"""Multi-process training dry run of the PyTorch port (tools/
multihost_dryrun.py on torch.distributed): N processes against one.

    python tools/multihost_dryrun_torch.py --cpu [--procs 4] [--out FILE]
    python tools/multihost_dryrun_torch.py --procs N   # N NCCL ranks, a card each

Spawns N processes joined as one group (gloo on the CPU with --cpu, else
NCCL, one rank a card), each stepping its own block of squared's 16
lanes, and trains the JAX tool's configuration (Default(32), batch 512,
minibatch 256, bptt 8, seed 7) over make_mesh(N) for 3 epochs; then the
same with one process. Every rank must report the same losses, and the N
processes' must match the one's within 1e-4 (process-count invariance,
as the JAX tool asserts for its mesh), with grad_norm and adv_var > 0.
Prints one JSON line (multihost_dryrun OK, the processes, both losses,
grad_norm, adv_var) and exits non-zero on a failed check.
"""
import argparse
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

EPOCHS = 3


def train_result(device, epochs=EPOCHS):
    """This rank's run: the same config whatever the process count."""
    import torch
    import pufferlib_tpu_torch.vector as vector
    from pufferlib_tpu_torch.models import Default, Policy
    from pufferlib_tpu_torch.ocean import env_creator
    from pufferlib_tpu_torch.parallel import global_mesh
    from pufferlib_tpu_torch.parallel.mesh import full
    from pufferlib_tpu_torch.training import ppo
    torch.set_num_threads(1)
    mesh = global_mesh(device=device)
    vecenv = vector.make(env_creator('squared'), num_envs=16, device=device)
    policy = Policy(Default(obs_shape=vecenv.single_observation_space.shape,
        action_space=vecenv.single_action_space, hidden_size=32,
        generator=torch.Generator().manual_seed(0)))
    config = ppo.default_config(env='squared', batch_size=512,
        minibatch_size=256, bptt_horizon=8, total_timesteps=10 ** 9,
        seed=7, verbose=False, device=device, checkpoint_interval=10 ** 6,
        data_dir=os.path.join(tempfile.gettempdir(), 'multihost_dryrun'))
    data = ppo.create(config, vecenv, policy, mesh=mesh)
    losses = []
    for _ in range(epochs):
        ppo.evaluate(data)
        ppo.train(data)
        losses.append(float(data.losses.policy_loss))
    checksum = sum(float(full(p).detach().abs().sum())
        for p in data.policy.parameters())
    return {'losses': losses, 'param_checksum': checksum,
        'grad_norm': float(data.losses.grad_norm),
        'adv_var': float(data.losses.adv_var),
        'lanes': int(data.carry['done'].shape[0])}


def launch(procs=2, device='cuda', out=None):
    import torch
    from pufferlib_tpu_torch.parallel.multihost import spawn
    if device != 'cpu' and procs > torch.cuda.device_count():
        raise SystemExit(f'{procs} ranks need {procs} cards, this machine '
            f'has {torch.cuda.device_count()} (--cpu runs gloo ranks)')
    multi = spawn(train_result, procs, args=(device,), device=device,
        timeout=600)
    single = spawn(train_result, 1, args=(device,), device=device,
        timeout=600)[0]
    for m in multi:
        assert m['lanes'] == 16 // procs, m
        # all ranks hold the same replicated result
        assert m['losses'] == multi[0]['losses'], (m, multi[0])
    for a, b in zip(multi[0]['losses'], single['losses']):
        assert abs(a - b) < 1e-4, (multi[0]['losses'], single['losses'])
    rel = abs(multi[0]['param_checksum'] - single['param_checksum']) \
        / max(abs(single['param_checksum']), 1e-9)
    assert rel < 1e-4, (multi[0]['param_checksum'],
        single['param_checksum'])
    assert multi[0]['grad_norm'] > 0 and multi[0]['adv_var'] > 0, multi[0]
    record = {
        'multihost_dryrun': 'OK',
        'processes': procs,
        'device': device,
        'losses_multiproc': multi[0]['losses'],
        'losses_1proc': single['losses'],
        'grad_norm': multi[0]['grad_norm'],
        'adv_var': multi[0]['adv_var'],
    }
    print(json.dumps(record), flush=True)
    if out:
        with open(out, 'w') as f:
            json.dump(record, f, indent=1)
    return record


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--procs', type=int, default=2)
    ap.add_argument('--cpu', action='store_true',
        help='gloo ranks on the CPU (else one NCCL rank a card)')
    ap.add_argument('--out', default=None)
    args = ap.parse_args()
    launch(args.procs, 'cpu' if args.cpu else 'cuda', args.out)


if __name__ == '__main__':
    main()
