"""Multi-process runs of the PyTorch port on the CPU (gloo ranks): process
counts, tensor parallelism, the tools and the bench's scaling lines.

- tools/multihost_dryrun_torch.py: 4 and 2 processes against 1, losses
  within 1e-4 (tests/test_multihost.py's bound for the JAX tool).
- Tensor parallelism (tests/test_parallel.py:121-139): (1, 2) and
  (2, 2) meshes against the same trainer with no mesh (pure data
  parallelism computes that, tests/test_torch_parallel.py), rtol 1e-3,
  atol 1e-4, for the MLP, the LSTM, the transformer and the conv policy,
  each with the params the JAX rule splits named; the MLP and conv (1,
  2) runs also save a checkpoint (rank 0 writes it), every rank loads it
  back into its shards, a trainer with no mesh loads it, and every rank
  loads the no-mesh trainer's.
- The rule per leaf against JAX's own param_shardings, for six policy
  families at (4, 2), (2, 4) and (1, 8), Adam's moments included (one
  process on a fake process group of eight ranks); the model axis's
  helpers against the whole layer on two gloo ranks.
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
import torch_mesh_worker  # noqa: E402
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
    # (world, mesh, policy, checkpoint, params that must be split)
    'mlp_1x2': (2, [1, 2], 'mlp', True, ['encoder.weight']),
    'mlp_2x2': (4, [2, 2], 'mlp', False, ['encoder.weight']),
    'lstm_1x2': (2, [1, 2], 'lstm', False, ['w_ih_l0', 'w_hh_l0']),
    'lstm_2x2': (4, [2, 2], 'lstm', False, ['w_ih_l0', 'w_hh_l0']),
    'transformer_1x2': (2, [1, 2], 'transformer', False,
        ['wq', 'wk', 'wv', 'wo', 'rel_bias']),
    'conv_1x2': (2, [1, 2], 'conv', True,
        ['convs.0.weight', 'convs.1.weight', 'convs.2.weight']),
}


@pytest.mark.parametrize('case', sorted(TP_CASES))
def test_tensor_parallel_matches_data_parallel(tmp_path, case):
    """A model axis against no mesh: every rank the same params, the
    named params split, the losses and params within rtol 1e-3, atol
    1e-4. With a checkpoint: the ranks' own round trip, the mesh's files
    loaded with no mesh, and the no-mesh trainer's files loaded into the
    mesh's shards."""
    from pufferlib_tpu_torch.training import checkpoint
    world, mesh, policy, save, split = TP_CASES[case]
    spec = dict(num_envs=16, hidden=32, policy=policy, epochs=2,
        window=8, checkpoint=save, config=dict(batch_size=512,
            minibatch_size=256, bptt_horizon=8, seed=17))
    ref = no_mesh(tmp_path, spec)
    if save:
        np.savez(str(tmp_path / 'ref.npz'), **ref['params'])
        path = ref['checkpoint']['path']
        spec['resume'] = dict(data_dir=str(tmp_path / 'no_mesh'),
            exp_id=os.path.basename(os.path.dirname(path)),
            params=str(tmp_path / 'ref.npz'))
    got, ranks = run_ranks(tmp_path / 'tp', spec, world, mesh)
    assert all(r['params_differ'] == 0.0 for r in ranks)
    sharded = {k.replace('module.', '', 1) for k in ranks[0]['sharded']}
    for name in split:
        assert any(k.endswith(name) for k in sharded), (name, sharded)
    assert ranks[0]['losses'][-1]['policy_loss'] == pytest.approx(
        ref['losses'][-1]['policy_loss'], rel=1e-3, abs=1e-4)
    assert_params_close(got, ref['params'], rtol=1e-3, atol=1e-4)
    if save:
        for r in ranks:
            assert r['checkpoint']['loaded'] and r['checkpoint']['equal']
            # 2 epochs x 4 update epochs x 2 minibatches of Adam steps
            assert r['checkpoint']['adam_steps'] == 16
            assert r['resumed'] == dict(loaded=True, differ=0.0,
                adam_steps=16)
        assert ranks[0]['checkpoint']['files'] == ['model_000002.pt',
            'trainer_state.pt']
        # the mesh's files, loaded with no mesh
        data = torch_mesh_worker.build(dict(spec, init_seed=99,
            data_dir=str(tmp_path / 'tp' / 'data')))
        data.config.exp_id = os.path.basename(os.path.dirname(
            ranks[0]['checkpoint']['path']))
        assert checkpoint.try_load_checkpoint(data)
        whole = torch_mesh_worker._whole_params(data)
        assert sorted(whole) == sorted(got)
        for k, v in whole.items():
            assert np.array_equal(v, got[k]), k


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


def _family(name):
    """(JAX module, its init input, the port's module, its input, the
    JAX params -> state_dict carry) of a policy family at a small size,
    widths picked so that the rule takes each of its branches at some
    model axis of 2, 4 or 8: LSTM hidden 5 (4H = 20) splits its columns
    at 2 and 4, W_ih's rows at 8 and leaves W_hh whole there; the
    transformer's rel_bias (4, 9) splits its heads at 2 and 4;
    ProcgenResnet's first conv (4 channels, kh 3) replicates at 8."""
    import functools
    import jax.numpy as jnp
    from pufferlib_tpu import models as jm
    from pufferlib_tpu import spaces as jspaces
    from pufferlib_tpu.environments.nethack.policy import Policy as JNet
    from pufferlib_tpu_torch import convert, models, spaces
    from pufferlib_tpu_torch.environments.nethack.policy import Policy
    rng = np.random.RandomState(0)
    jspace, space = jspaces.Discrete(5), spaces.Discrete(5)
    if name in ('default', 'lstm', 'transformer'):
        obs = rng.randn(2, 3, 7, 7).astype(np.float32)
        hidden = 5 if name == 'lstm' else 32
        jinner = jm.Default(obs_shape=(7, 7), action_space=jspace,
            hidden_size=32)
        inner = models.Default(obs_shape=(7, 7), action_space=space,
            hidden_size=32, decoder_input_size=hidden)
        if name == 'default':
            return (jinner, obs[:, 0], inner, obs[:, 0],
                convert.default_state_dict)
        if name == 'lstm':
            return (jm.LSTMWrapper(policy=jinner, obs_shape=(7, 7),
                input_size=32, hidden_size=5, num_layers=2,
                use_pallas=False), obs, models.LSTMWrapper(inner,
                obs_shape=(7, 7), input_size=32, hidden_size=5,
                num_layers=2, use_kernel=False), obs, convert.lstm_state_dict)
        return (jm.TransformerWrapper(policy=jinner, obs_shape=(7, 7),
            input_size=32, hidden_size=32, window=8, num_heads=4), obs,
            models.TransformerWrapper(inner, obs_shape=(7, 7),
                input_size=32, hidden_size=32, window=8, num_heads=4), obs,
            convert.transformer_state_dict)
    if name == 'conv_lstm':
        obs = rng.randint(0, 256, (2, 3, 2, 40, 40)).astype(np.uint8)
        layers = convert.convolutional_layers((5,))
        return (jm.LSTMWrapper(policy=jm.Convolutional(action_space=jspace,
            framestack=2, flat_size=64, hidden_size=16), obs_shape=(2, 40,
            40), input_size=16, hidden_size=16, use_pallas=False), obs,
            models.LSTMWrapper(models.Convolutional(space, 2, 64,
                hidden_size=16), obs_shape=(2, 40, 40), input_size=16,
                hidden_size=16, use_kernel=False), obs,
            functools.partial(convert.lstm_state_dict,
                policy_state_dict=functools.partial(
                    convert.layers_state_dict, layers=layers)))
    if name == 'procgen':
        obs = rng.randint(0, 256, (2, 16, 16, 3)).astype(np.uint8)
        return (jm.ProcgenResnet(action_space=jspace, cnn_width=4,
            mlp_width=16), obs, models.ProcgenResnet(space, cnn_width=4,
            mlp_width=16, obs_shape=(16, 16, 3)), obs, functools.partial(
            convert.layers_state_dict, layers=convert.procgen_layers((5,))))
    obs = np.concatenate([rng.randint(-3, 300, (2, 27)),
        rng.randint(0, 256, (2, 21 * 79))], axis=1).astype(np.float32)
    return (JNet(obs_shape=obs.shape[1:], action_space=jspaces.Discrete(8),
        hidden_size=64), obs, Policy(obs.shape[1:], spaces.Discrete(8),
        hidden_size=64), obs, convert.nethack_state_dict)


@pytest.fixture
def fake_world():
    """A fake process group of eight ranks in this process (collectives
    do nothing): enough for DeviceMesh, DTensor and Adam's placements."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group('fake', store=FakeStore(), rank=0,
        world_size=8)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize('mesh_shape', [(4, 2), (2, 4), (1, 8)])
@pytest.mark.parametrize('family', ['default', 'lstm', 'transformer',
    'conv_lstm', 'procgen', 'nethack'])
def test_param_shardings_matches_jax_per_leaf(fake_world, family,
        mesh_shape):
    """Each JAX leaf's PartitionSpec under JAX's own param_shardings,
    carried through convert.py's layout as a tensor of block labels,
    against the port's placement of the matching parameter after
    shard_params, and of its Adam moments after one step."""
    import jax
    import jax.numpy as jnp
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor
    from pufferlib_tpu.parallel import make_mesh_2d as jax_mesh_2d
    from pufferlib_tpu.parallel import param_shardings as jax_shardings
    from pufferlib_tpu_torch.parallel.mesh import (
        param_shardings, shard_params)
    jmod, jobs, module, obs, carry = _family(family)
    n_env, k = mesh_shape
    params = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(0),
        jnp.asarray(jobs)))
    specs = jax_shardings(jax_mesh_2d(n_env, k), params)

    def labels(leaf, sharding):
        # 1 + the block index along the sharded dim; zeros if replicated
        out = np.zeros(np.shape(leaf), np.float32)
        for dim, part in enumerate(sharding.spec):
            if part == 'model':
                n = np.shape(leaf)[dim] // k
                shape = [1] * out.ndim
                shape[dim] = -1
                out += 1 + (np.arange(np.shape(leaf)[dim]) // n).reshape(
                    shape)
        return out
    want = carry(jax.tree.map(labels, params, specs))

    mesh = DeviceMesh('cpu', torch.arange(8).reshape(n_env, k),
        mesh_dim_names=('env', 'model'))
    plan = param_shardings(mesh, module)
    shard_params(module, plan, mesh['model'])
    got = dict(module.named_parameters())
    assert sorted(got) == sorted(want)
    for name, label in want.items():
        varying = [d for d in range(label.ndim)
            if label.ndim and not torch.equal(label, label.narrow(d, 0,
                1).expand_as(label))]
        param = got[name]
        if not varying:
            assert not isinstance(param, DTensor), name
            continue
        (dim,) = varying
        assert plan.dims[name] == dim, (name, plan.dims.get(name), dim)
        assert param.placements[0].dim == dim, name
        # block r of k along dim is label r + 1, as torch's Shard lays it
        n = label.shape[dim] // k
        for r in range(k):
            assert torch.all(label.narrow(dim, r * n, n) == r + 1), name
    optimizer = torch.optim.Adam(module.parameters(), foreach=False)
    out = module(torch.as_tensor(obs))
    loss = sum(t.float().sum() for t in jax.tree.leaves(out[:2]))
    loss.backward()
    optimizer.step()
    for name, param in got.items():
        for slot in ('exp_avg', 'exp_avg_sq'):
            moment = optimizer.state[param][slot]
            assert isinstance(moment, DTensor) == isinstance(param,
                DTensor), (name, slot)
            if isinstance(param, DTensor):
                assert moment.placements == param.placements, (name, slot)
                assert moment.to_local().shape == param.to_local().shape


def _helpers_rank():
    """Each use site of a split weight on this rank of a (1, 2) mesh
    against the same layer whole: outputs and every gradient (the
    whole weights' gradient blocks), the rule's every branch."""
    import torch.nn.functional as F
    from torch import nn
    from pufferlib_tpu_torch.models import _layers
    from pufferlib_tpu_torch.parallel import make_mesh_2d
    from pufferlib_tpu_torch.parallel.mesh import (
        full, param_shardings, shard_params)
    torch.set_num_threads(1)
    torch.manual_seed(0)
    mesh = make_mesh_2d(1, 2, device='cpu')
    gen = torch.Generator().manual_seed(0)

    class Sites(nn.Module):
        def __init__(self):
            super().__init__()
            self.col = nn.Linear(6, 4)        # outputs split
            self.row = nn.Linear(4, 3)        # inputs split
            self.conv = nn.Conv2d(3, 4, 3)    # out channels split
            self.conv_kh = nn.Conv2d(3, 3, (2, 3), padding=1)  # kh
            self.embed_d = nn.Embedding(5, 4)  # features split
            self.embed_n = nn.Embedding(6, 3)  # rows split
            self.w = nn.Parameter(torch.randn(6, 8, generator=gen))
            self.rows = nn.Parameter(torch.randn(4, 3, generator=gen))

        def forward(self, x, img, idx):
            a = _layers._linear(self.col, x, torch.float32)
            b = _layers._linear(self.row, a, torch.bfloat16).float()
            c = _layers._conv(self.conv, img, torch.float32)
            d = _layers._conv(self.conv_kh, img, torch.float32)
            e = _layers._embed(self.embed_d, idx)
            f = _layers._embed(self.embed_n, idx)
            w, enter, gather = _layers._columns(self.w)
            g = gather(enter(x) @ w)
            h = _layers._whole(self.rows)
            return [a, b, c, d, e, f, g, h]

    whole = Sites()
    split = Sites()
    split.load_state_dict(whole.state_dict())
    plan = param_shardings(mesh, split)
    shard_params(split, plan, mesh['model'])
    x = torch.randn(5, 6, generator=gen)
    img = torch.randn(2, 3, 6, 6, generator=gen)
    idx = torch.randint(0, 5, (5, 2), generator=gen)
    cots = None
    out = {}
    for name, module in (('whole', whole), ('split', split)):
        xs = x.clone().requires_grad_()
        ys = module(xs, img, idx)
        if cots is None:
            cots = [torch.randn(y.shape, generator=gen) for y in ys]
        sum((y.float() * c).sum() for y, c in zip(ys, cots)).backward()
        out[name] = dict(outputs=[y.detach().float() for y in ys],
            dx=xs.grad, grads={k: full(p.grad) for k, p in
                module.named_parameters()})
    return dict(dims=dict(plan.dims), **{k: {
        'outputs': [o.tolist() for o in v['outputs']],
        'dx': v['dx'].tolist(),
        'grads': {n: g.tolist() for n, g in v['grads'].items()}}
        for k, v in out.items()})


def test_model_axis_helpers_match_the_whole_layer():
    from pufferlib_tpu_torch.parallel.multihost import spawn
    ranks = spawn(_helpers_rank, 2, device='cpu', timeout=240)
    assert ranks[0]['dims'] == {'col.weight': 0, 'row.weight': 1,
        'conv.weight': 0, 'conv_kh.weight': 2, 'embed_d.weight': 1,
        'embed_n.weight': 0, 'w': 1, 'rows': 0}
    for r in ranks:
        whole, split = r['whole'], r['split']
        for i, (a, b) in enumerate(zip(split['outputs'],
                whole['outputs'])):
            np.testing.assert_allclose(a, b, rtol=1e-2 if i == 1 else 1e-6,
                atol=1e-2 if i == 1 else 1e-6, err_msg=f'output {i}')
        np.testing.assert_allclose(split['dx'], whole['dx'], rtol=1e-5,
            atol=1e-5)
        for name, g in whole['grads'].items():
            np.testing.assert_allclose(split['grads'][name], g, rtol=1e-5,
                atol=1e-5, err_msg=name)
    assert ranks[0]['split'] == ranks[1]['split']
