"""Weak-scaling harness of the PyTorch port (tools/bench_scaling.py on
torch.distributed): the fused PPO step over 1, 2, 4, ... ranks with the
env lanes sharded on the mesh's 'env' axis, reporting steps/s and the
scaling efficiency.

    python tools/bench_scaling_torch.py [--devices 1 2 4 8]
        [--envs-per-dev 512] [--horizon 32] [--hidden 128] [--epochs 10]
        [--out FILE]
    python tools/bench_scaling_torch.py --cpu ...   # gloo ranks, for tests

On the card one rank runs per card (NCCL); asking for more ranks than
there are cards raises. Each width n spawns n ranks that train squared
(distance 3, one target) at envs_per_dev * n lanes, Default(hidden) in
f32, minibatch batch / 4, bptt 16: one warm-up epoch, then `epochs`
epochs of ppo.step timed by rank 0 (the ranks run in lockstep through
their all-reduces), ending in a synchronise. Prints one JSON line per
width ({devices, num_envs, sps, scaling_efficiency}: sps over the
1-rank width's times n) and last {metric: scaling_efficiency_max_mesh}.
With --cpu the numbers say that the sharded program runs, not how fast
a card does.
"""
import argparse
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def rank_sps(n, args, device):
    """steps/s of the global batch, as this rank timed it."""
    import torch
    import pufferlib_tpu_torch.vector as vector
    from pufferlib_tpu_torch.models import Default, Policy
    from pufferlib_tpu_torch.ocean import env_creator
    from pufferlib_tpu_torch.parallel import make_mesh
    from pufferlib_tpu_torch.training import ppo
    if device == 'cpu':
        torch.set_num_threads(1)
    mesh = make_mesh(n, device=device)
    num_envs = args['envs_per_dev'] * n
    batch = num_envs * args['horizon']
    vecenv = vector.make(env_creator('squared'),
        env_kwargs=dict(distance_to_target=3, num_targets=1),
        num_envs=num_envs, device=device)
    policy = Policy(Default(obs_shape=vecenv.single_observation_space.shape,
        action_space=vecenv.single_action_space, hidden_size=args['hidden'],
        generator=torch.Generator().manual_seed(0)))
    config = ppo.default_config(env='squared', batch_size=batch,
        minibatch_size=batch // 4, bptt_horizon=16,
        total_timesteps=batch * 10 ** 6, anneal_lr=False, verbose=False,
        device=device, checkpoint_interval=10 ** 6,
        data_dir=os.path.join(tempfile.gettempdir(), 'puffer_scaling'))
    data = ppo.create(config, vecenv, policy, mesh=mesh)

    def sync():
        if device != 'cpu':
            torch.cuda.synchronize()

    ppo.step(data)
    sync()
    start = time.perf_counter()
    for _ in range(args['epochs']):
        ppo.step(data)
    sync()
    return batch * args['epochs'] / (time.perf_counter() - start)


def run(devices, args, device):
    """[{devices, num_envs, sps, scaling_efficiency}] for each width."""
    import torch
    from pufferlib_tpu_torch.parallel.multihost import spawn
    if device != 'cpu' and max(devices) > torch.cuda.device_count():
        raise SystemExit(f'{max(devices)} ranks need as many cards, this '
            f'machine has {torch.cuda.device_count()} (NCCL takes one rank '
            'a card)')
    results, base = [], None
    for n in devices:
        sps = spawn(rank_sps, n, args=(n, args, device), device=device,
            timeout=1800)[0]
        base = sps if base is None else base
        results.append(dict(devices=n, num_envs=args['envs_per_dev'] * n,
            sps=round(sps, 1), scaling_efficiency=round(sps / (base * n),
                4)))
        print(json.dumps(results[-1]), flush=True)
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--devices', type=int, nargs='+', default=[1, 2, 4, 8])
    ap.add_argument('--envs-per-dev', type=int, default=512)
    ap.add_argument('--horizon', type=int, default=32)
    ap.add_argument('--hidden', type=int, default=128)
    ap.add_argument('--epochs', type=int, default=10)
    ap.add_argument('--cpu', action='store_true',
        help='gloo ranks on the CPU (else one NCCL rank a card)')
    ap.add_argument('--out', default=None,
        help='also write the per-width results to this JSON file')
    a = ap.parse_args()
    args = dict(envs_per_dev=a.envs_per_dev, horizon=a.horizon,
        hidden=a.hidden, epochs=a.epochs)
    results = run(a.devices, args, 'cpu' if a.cpu else 'cuda')
    if a.out:
        with open(a.out, 'w') as f:
            json.dump(dict(args, results=results), f, indent=1)
    print(json.dumps({'metric': 'scaling_efficiency_max_mesh',
        'value': results[-1]['scaling_efficiency'], 'unit': 'x',
        'devices': results[-1]['devices']}), flush=True)


if __name__ == '__main__':
    main()
