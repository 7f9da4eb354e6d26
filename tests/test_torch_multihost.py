"""Multi-process runs of the PyTorch port on the CPU (gloo ranks): process
counts, tensor parallelism, the tools and the bench's scaling lines.

- tools/multihost_dryrun_torch.py: 4 and 2 processes against 1, losses
  within 1e-4 (tests/test_multihost.py's bound for the JAX tool).
- Tensor parallelism (tests/test_parallel.py:121-139): a (1, 2) and a
  (2, 2) mesh against the same trainer with no mesh (pure data
  parallelism computes that, tests/test_torch_parallel.py), rtol 1e-3,
  atol 1e-4, with a >= 2-D param split over the model axis; the (1, 2)
  run also saves a checkpoint (rank 0 writes it) and every rank loads it
  back into its shards.
- tools/dryrun_multichip_torch.py --cpu 4 (both legs),
  examples/train_sharded_torch.py under torchrun, the plan's rule,
  init_distributed in one process, and bench_torch.py's scaling lines,
  which need two cards.

Every multi-process case runs in a subprocess with its own timeout.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, 'tests'))

import bench_torch  # noqa: E402
from test_torch_parallel import (  # noqa: E402
    assert_params_close, no_mesh, run_ranks)

torch.set_num_threads(1)


def _tool(*argv, timeout=300, **env):
    return subprocess.run([sys.executable, *argv], cwd=REPO,
        capture_output=True, text=True, timeout=timeout,
        env=dict(os.environ, OMP_NUM_THREADS='1', **env))


@pytest.mark.parametrize('procs', [2, 4])
def test_processes_match_one(procs):
    proc = _tool('tools/multihost_dryrun_torch.py', '--cpu', '--procs',
        str(procs))
    assert proc.returncode == 0, proc.stderr[-4000:]
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rec['multihost_dryrun'] == 'OK' and rec['processes'] == procs
    assert len(rec['losses_multiproc']) == 3
    assert rec['losses_multiproc'] == pytest.approx(rec['losses_1proc'],
        abs=1e-4)
    assert rec['grad_norm'] > 0 and rec['adv_var'] > 0


TP_CASES = {
    # (world, mesh, policy, checkpoint)
    'mlp_1x2': (2, [1, 2], 'mlp', True),
    'mlp_2x2': (4, [2, 2], 'mlp', False),
    'lstm_1x2': (2, [1, 2], 'lstm', False),
}


@pytest.mark.parametrize('case', sorted(TP_CASES))
def test_tensor_parallel_matches_data_parallel(tmp_path, case):
    world, mesh, policy, save = TP_CASES[case]
    spec = dict(num_envs=16, hidden=32, policy=policy, epochs=2,
        checkpoint=save, config=dict(batch_size=512, minibatch_size=256,
            bptt_horizon=8, seed=17))
    ref = no_mesh(tmp_path, dict(spec, checkpoint=False))
    got, ranks = run_ranks(tmp_path / 'tp', spec, world, mesh)
    assert all(r['params_differ'] == 0.0 for r in ranks)
    assert ranks[0]['sharded'], 'no >= 2-D param split over the model axis'
    assert ranks[0]['losses'][-1]['policy_loss'] == pytest.approx(
        ref['losses'][-1]['policy_loss'], rel=1e-3, abs=1e-4)
    assert_params_close(got, ref['params'], rtol=1e-3, atol=1e-4)
    if save:
        for r in ranks:
            assert r['checkpoint']['loaded'] and r['checkpoint']['equal']
            # 2 epochs x 4 update epochs x 2 minibatches of Adam steps
            assert r['checkpoint']['adam_steps'] == 16
        assert ranks[0]['checkpoint']['files'] == ['model_000002.pt',
            'trainer_state.pt']


def test_dryrun_multichip_on_four_cpu_ranks():
    proc = _tool('tools/dryrun_multichip_torch.py', '--cpu', '4')
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert 'dryrun_multichip_torch(4) dp OK' in proc.stdout
    assert 'dryrun_multichip_torch(4) tp OK: mesh=(2,2)' in proc.stdout


def test_train_sharded_example_under_torchrun(tmp_path):
    """The example's two extra lines on 2 gloo ranks: the progress lines
    and the final stats come from rank 0 alone."""
    proc = subprocess.run([sys.executable, '-m', 'torch.distributed.run',
        '--nproc-per-node', '2', os.path.join(REPO, 'examples',
            'train_sharded_torch.py')], cwd=tmp_path, capture_output=True,
        text=True, timeout=300, env=dict(os.environ, PUFFER_DEVICE='cpu',
            OMP_NUM_THREADS='1'))
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = proc.stdout.splitlines()
    assert sum(line.startswith('final stats:') for line in out) == 1
    assert sum(line.startswith('epoch 10 step 327680') for line in out) == 1


class _Mesh:
    """What param_shardings and the placement helpers read of a
    DeviceMesh: this rank at `coords`."""

    def __init__(self, names, shape, coords=None):
        self.mesh_dim_names = names
        self.shape = shape
        self.ndim = len(shape)
        self.coords = coords or (0,) * len(shape)
        self.device_type = 'cpu'

    def size(self, dim):
        return self.shape[dim]

    def get_local_rank(self, dim):
        return self.coords[dim]


def test_placements_are_the_jax_shardings():
    """carry_shardings / batch_shardings / env_sharded: the JAX package's
    dims (carry on 0, its LSTM state on 1; batch on 1, last_value on 0,
    lstm0 on 2) as DTensor placements, with this rank's block; the model
    axis replicates them. host_sharded_batch keeps this rank's rows."""
    from torch.distributed.tensor import Replicate, Shard
    from pufferlib_tpu_torch.parallel import (
        batch_shardings, carry_shardings, env_sharded, host_sharded_batch,
        replicated)
    mesh = _Mesh(('env', 'model'), (2, 2), coords=(1, 0))
    assert replicated(mesh) == (Replicate(), Replicate())
    x = torch.arange(24.).reshape(4, 6)
    (placements, block), = env_sharded(mesh, [x])
    assert placements == (Shard(0), Replicate())
    assert torch.equal(block, x[2:])
    carry = dict(env={'pos': torch.arange(8)}, done=torch.zeros(8),
        obs=torch.arange(16.).reshape(8, 2),
        lstm=(torch.arange(32.).reshape(1, 8, 4),) * 2)
    out = carry_shardings(mesh, carry)
    assert torch.equal(out['env']['pos'][1], torch.arange(4, 8))
    assert out['lstm'][0][0] == (Shard(1), Replicate())
    assert torch.equal(out['lstm'][0][1], carry['lstm'][0][:, 4:])
    batch = dict(obs=torch.zeros(3, 8, 2), last_value=torch.arange(8.),
        lstm0=(torch.zeros(2, 1, 8, 4),) * 2)
    out = batch_shardings(mesh, recurrent=True)(batch)
    assert out['obs'][0] == (Shard(1), Replicate())
    assert out['obs'][1].shape == (3, 4, 2)
    assert torch.equal(out['last_value'][1], torch.arange(4., 8.))
    assert out['lstm0'][0][1].shape == (2, 1, 4, 4)
    local = host_sharded_batch({'obs': np.ones((4, 3), np.float32)},
        _Mesh(('env',), (2,)))
    assert local['obs'].shape == (4, 3) and local['obs'].device.type == 'cpu'


def test_param_shardings_is_the_jax_rule():
    from torch.distributed.tensor import Replicate
    from pufferlib_tpu_torch import spaces
    from pufferlib_tpu_torch.models import Default, LSTMWrapper
    from pufferlib_tpu_torch.parallel import param_shardings
    module = LSTMWrapper(Default(obs_shape=(7, 7),
        action_space=spaces.Discrete(5), hidden_size=32), obs_shape=(7, 7),
        input_size=32, hidden_size=32)
    # the encoder (32 out of 49) and the head (6 = 5 logits + value, out of
    # 32): out divides by 2, so both column-parallel, outputs gathered
    plan = param_shardings(_Mesh(('env', 'model'), (2, 2)), module)
    assert sorted(plan) == ['policy.encoder', 'policy.head']
    for style in plan.values():
        assert type(style).__name__ == 'ColwiseParallel'
        assert style.output_layouts == (Replicate(),)
    # 6 does not divide by 4, 32 does: the head row-parallel, its input
    # taken whole
    plan = param_shardings(_Mesh(('env', 'model'), (1, 4)), module)
    assert type(plan['policy.head']).__name__ == 'RowwiseParallel'
    assert plan['policy.head'].input_layouts == (Replicate(),)
    # neither divides by 64 (32 out, 49 in): the encoder replicates
    assert 'policy.encoder' not in param_shardings(
        _Mesh(('model',), (64,)), module)
    # no model axis, or one of 1: everything replicates
    assert param_shardings(_Mesh(('env',), (4,)), module) == {}
    assert param_shardings(_Mesh(('env', 'model'), (4, 1)), module) == {}


def test_init_distributed_alone_is_a_noop(monkeypatch):
    import torch.distributed as dist
    from pufferlib_tpu_torch.exceptions import APIUsageError
    from pufferlib_tpu_torch.parallel import (
        init_distributed, process_local_slice)
    for var in ('MASTER_ADDR', 'MASTER_PORT', 'RANK', 'WORLD_SIZE'):
        monkeypatch.delenv(var, raising=False)
    init_distributed(device='cpu')
    assert not dist.is_initialized()
    assert process_local_slice(10) == (0, 10)
    # more than one process needs a coordinator
    with pytest.raises(APIUsageError, match='coordinator'):
        init_distributed(num_processes=2, process_id=0, device='cpu')
    assert not dist.is_initialized()


def test_scaling_lines_need_two_cards(monkeypatch):
    proc = _tool('bench_torch.py', BENCH_SMOKE='1', BENCH_ONLY='scaling',
        timeout=120)
    assert proc.returncode != 0 and not proc.stdout.strip()
    assert 'no scaling line' in proc.stderr and 'two or more' in \
        proc.stderr
    monkeypatch.delenv('BENCH_SCALING_DEVICES', raising=False)
    assert bench_torch.scaling_devices(1) == []
    assert bench_torch.scaling_devices(4) == [2, 4]
    assert bench_torch.scaling_devices(8) == [2, 4, 8]
    monkeypatch.setenv('BENCH_SCALING_DEVICES', '2 3 16')
    assert bench_torch.scaling_devices(8) == [2, 3]


def test_bench_scaling_tool_on_cpu_ranks():
    proc = _tool('tools/bench_scaling_torch.py', '--cpu', '--devices', '1',
        '2', '--envs-per-dev', '16', '--horizon', '32', '--hidden', '32',
        '--epochs', '1')
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = [json.loads(line) for line in proc.stdout.splitlines()]
    assert [r.get('devices') for r in lines] == [1, 2, 2]
    assert lines[0]['scaling_efficiency'] == 1.0
    assert all(r['sps'] > 0 for r in lines[:2])
    assert lines[-1]['metric'] == 'scaling_efficiency_max_mesh'
