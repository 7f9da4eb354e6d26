"""The multi-device dry run of __graft_entry__.py (dryrun_multichip) on
the PyTorch port: the full trainer (rollout, GAE, PPO update) over an
n-rank mesh on tiny shapes, one evaluate + train.

    python tools/dryrun_multichip_torch.py N          # N ranks, a card each (NCCL)
    python tools/dryrun_multichip_torch.py --cpu N    # N gloo ranks on the CPU

Leg 1, data parallel: make_mesh(N), squared at 2N lanes through
RecurrentPolicy(LSTMWrapper(Default(32))), its default route (the enc5
kernels on the card, the plain scan on the CPU). Leg 2 (N >= 4), tensor
parallel: make_mesh_2d(N / 2, 2), the same policy with use_kernel=False
(a sharded weight cannot enter the kernels). Each leg asserts a finite
loss, grad_norm > 0 and adv_var > 0, that each rank stepped its own block
of the lanes, and (leg 2) that a >= 2-D param is split over the model
axis; it prints one line per leg. On the card it raises when asked for
more ranks than there are cards (NCCL takes one rank a card).
"""
import argparse
import math
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def leg(n_devices, device, tp):
    """One rank's evaluate + train; returns what the launcher checks."""
    import torch
    import pufferlib_tpu_torch.vector as vector
    from pufferlib_tpu_torch.models import (
        Default, LSTMWrapper, RecurrentPolicy)
    from pufferlib_tpu_torch.ocean import env_creator
    from pufferlib_tpu_torch.parallel import make_mesh, make_mesh_2d
    from pufferlib_tpu_torch.training import ppo
    torch.set_num_threads(1)
    mesh = make_mesh_2d(n_devices // 2, 2, device=device) if tp \
        else make_mesh(n_devices, device=device)
    num_envs = 2 * n_devices
    vecenv = vector.make(env_creator('squared'), num_envs=num_envs,
        device=device)
    shape = vecenv.single_observation_space.shape
    module = LSTMWrapper(Default(obs_shape=shape,
        action_space=vecenv.single_action_space, hidden_size=32,
        generator=torch.Generator().manual_seed(0)), obs_shape=shape,
        input_size=32, hidden_size=32,
        use_kernel=False if tp else None,
        generator=torch.Generator().manual_seed(1))
    config = ppo.default_config(env='squared', batch_size=num_envs * 16,
        minibatch_size=num_envs * 8, bptt_horizon=8,
        total_timesteps=num_envs * 16, verbose=False, device=device,
        data_dir=os.path.join(tempfile.gettempdir(), 'puffer_torch_dryrun'))
    data = ppo.create(config, vecenv, RecurrentPolicy(module), mesh=mesh)
    ppo.evaluate(data)
    ppo.train(data)
    dtensor = sys.modules.get('torch.distributed.tensor')
    split = [k for k, v in data.policy.state_dict().items()
        if dtensor is not None and isinstance(v, dtensor.DTensor)
        and v.ndim >= 2 and tuple(v.to_local().shape) != tuple(v.shape)]
    return dict(rank=data.rank, lanes=int(data.carry['done'].shape[0]),
        loss=data.losses.policy_loss, grad_norm=data.losses.grad_norm,
        adv_var=data.losses.adv_var, split=split,
        route=data.policy.module.route(8, data.device))


def dryrun_multichip(n_devices, device='cuda'):
    """Both legs on n_devices ranks; raises on a failed check."""
    import torch
    from pufferlib_tpu_torch.parallel.multihost import spawn
    if device != 'cpu' and n_devices > torch.cuda.device_count():
        raise SystemExit(f'{n_devices} ranks need {n_devices} cards, this '
            f'machine has {torch.cuda.device_count()} (NCCL takes one rank '
            'a card; --cpu runs gloo ranks on the CPU)')
    legs = [False] + ([True] if n_devices >= 4 else [])
    for tp in legs:
        ranks = spawn(leg, n_devices, args=(n_devices, device, tp),
            device=device, timeout=600)
        r0 = ranks[0]
        name = 'tp' if tp else 'dp'
        assert math.isfinite(r0['loss']), ranks
        assert r0['grad_norm'] > 0, f'{name}: zero gradient norm'
        assert r0['adv_var'] > 0, f'{name}: zero advantage variance'
        # every rank computes the same losses, on its own lanes
        assert all(r['loss'] == r0['loss'] for r in ranks), ranks
        n_env = n_devices // 2 if tp else n_devices
        assert all(r['lanes'] == 2 * n_devices // n_env for r in ranks), \
            'env lanes not split over the mesh'
        if tp:
            assert r0['split'], 'no param split over the model axis'
        mesh = f'({n_devices // 2},2)' if tp else f'({n_devices},)'
        print(f'dryrun_multichip_torch({n_devices}) {name} OK: mesh={mesh} '
            f'on {device}, route {r0["route"]}, loss={r0["loss"]:.4f} '
            f'grad_norm={r0["grad_norm"]:.4f} adv_var={r0["adv_var"]:.4g}'
            + (f' split={r0["split"]}' if tp else ''), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('n_devices', type=int)
    ap.add_argument('--cpu', action='store_true',
        help='gloo ranks on the CPU (else one NCCL rank a card)')
    args = ap.parse_args()
    dryrun_multichip(args.n_devices, 'cpu' if args.cpu else 'cuda')


if __name__ == '__main__':
    main()
