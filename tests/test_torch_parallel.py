"""Multi-device training of the PyTorch port on the CPU (gloo ranks)
against the JAX package's mesh training and against itself.

The contract (the JAX mesh's: tests/test_parallel.py, test_multihost.py):
k ranks train the same function as one rank and as no mesh, up to the
order of float sums. Sizes are tests/test_parallel.py's: squared at 16
lanes, batch 512, minibatch 256 (128 where each minibatch is one time
slab), bptt 8, hidden 32.

- Against JAX: the JAX trainer runs over make_mesh(8) (use_pallas=False);
  its initial params are carried to the port by convert.py, and the draws
  its rollout made (the sampler's uniforms from its key chain, each
  lane's reset targets from its lane keys, the initial env state) are
  handed to the port's rollout, at the global width; each of the port's
  2 ranks keeps its block. After evaluate + train the params must agree
  within rtol 1e-4, atol 1e-5 (test_parallel's tolerance): the LSTM in
  time slabs and agent-major (the gather path), the MLP agent-major (JAX's
  mesh layout; the port's gather path).
- Against itself: 2 ranks, 1 rank and no mesh, with the port's own draws,
  2 epochs, the same tolerance: the contiguous MLP layout (no data moves)
  and shuffle_minibatches with target_kl (the gather path; every rank
  takes the same early-stop decision); 2 ranks and no mesh on multiagent
  (two agents a lane) and spaces (a structured observation, a
  MultiDiscrete action).
- create's refusals, and that parallel/ imports neither jax nor
  pufferlib_tpu.

Each case spawns its ranks through tests/torch_mesh_worker.py in a
subprocess with its own timeout: the children import the port only, the
JAX side runs here.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import pufferlib_tpu.vector as jax_vector
from pufferlib_tpu.models import Default as JaxDefault
from pufferlib_tpu.models import LSTMWrapper as JaxLSTMWrapper
from pufferlib_tpu.models import Policy as JaxPolicy
from pufferlib_tpu.models import RecurrentPolicy as JaxRecurrentPolicy
from pufferlib_tpu.ocean import env_creator as jax_env_creator
from pufferlib_tpu.parallel import make_mesh as jax_make_mesh
from pufferlib_tpu.training import ppo as jax_ppo

from pufferlib_tpu_torch.convert import default_state_dict, lstm_state_dict

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, 'tests', 'torch_mesh_worker.py')
sys.path.insert(0, os.path.join(REPO, 'tests'))

import torch_mesh_worker  # noqa: E402

LANES, BATCH, HORIZON, HIDDEN = 16, 512, 8, 32
T = BATCH // LANES


def run_ranks(tmp_path, spec, world, mesh, timeout=240):
    """The worker's ranks on `spec`: (rank 0's params, every rank's
    result)."""
    tmp_path.mkdir(exist_ok=True)
    spec = dict(spec, world=world, mesh=mesh, out=str(tmp_path / 'out'),
        data_dir=str(tmp_path / 'data'), timeout=timeout - 30)
    path = tmp_path / 'spec.json'
    path.write_text(json.dumps(spec))
    proc = subprocess.run([sys.executable, WORKER, str(path)], cwd=REPO,
        capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(str(tmp_path / 'out.npz')) as f:
        params = {k: f[k] for k in f.files}
    return params, json.loads((tmp_path / 'out.json').read_text())


def no_mesh(tmp_path, spec):
    """The same trainer in this process, with no mesh."""
    return torch_mesh_worker.train(dict(spec,
        data_dir=str(tmp_path / 'no_mesh')))


def assert_params_close(got, want, rtol, atol):
    want = {k[len('module.'):] if k.startswith('module.') else k: v
        for k, v in want.items()}
    got = {k[len('module.'):] if k.startswith('module.') else k: v
        for k, v in got.items()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=rtol,
            atol=atol, err_msg=k)


def _draws(states, num_targets):
    """The port's squared reset draws that reproduce the JAX lanes'
    targets: the chosen cell's index (one target), else the chosen cells
    as floats (k of n: a top-k)."""
    chosen = np.asarray(states['env']['chosen'])
    if num_targets == 1:
        return np.argmax(chosen, axis=1)
    return chosen.astype(np.float32)


def jax_mesh_run(tmp_path, recurrent, minibatch_size, seed, **cfg):
    """JAX's trainer over make_mesh(8): (initial weights as the port's
    state_dict, the draws of its first rollout, its params after one
    evaluate + train as the port's state_dict)."""
    vecenv = jax_vector.make(jax_env_creator('squared'),
        backend=jax_vector.Device, num_envs=LANES)
    obs_shape = vecenv.single_observation_space.shape
    atn = vecenv.single_action_space
    if recurrent:
        policy = JaxRecurrentPolicy(JaxLSTMWrapper(policy=JaxDefault(
            obs_shape=obs_shape, action_space=atn, hidden_size=HIDDEN),
            obs_shape=obs_shape, input_size=HIDDEN, hidden_size=HIDDEN,
            use_pallas=False))
        convert = lstm_state_dict
    else:
        policy = JaxPolicy(JaxDefault(obs_shape=obs_shape,
            action_space=atn, hidden_size=HIDDEN, use_pallas=False))
        convert = default_state_dict
    config = jax_ppo.default_config(env='squared', batch_size=BATCH,
        minibatch_size=minibatch_size, bptt_horizon=HORIZON,
        total_timesteps=2048, verbose=False, seed=seed,
        data_dir=str(tmp_path / 'jax'), **cfg)
    jdata = jax_ppo.create(config, vecenv, policy, mesh=jax_make_mesh(8))

    def state_dict():
        return {k: v.numpy() for k, v in convert(jax.tree.map(np.asarray,
            jdata.params)).items()}

    weights = state_dict()
    # the draws evaluate's rollout makes: one split of the carried key
    # (the update's branch), then the action key chain; each lane's
    # reset target from fold_in(fold_in(lane_key, t), 0)
    key, _ = jax.random.split(jdata.carry['key'])
    lane_keys = jdata.carry['keys']
    t0 = int(jdata.carry['t'])
    env = vecenv.env
    u, reset = [], []
    for t in range(T):
        key, act_key = jax.random.split(key)
        u.append(np.asarray(jax.random.uniform(jax.random.split(
            act_key, 1)[0], (LANES,), dtype=jnp.float32)))
        step_keys = jax.vmap(jax.random.fold_in, (0, None))(lane_keys,
            t0 + t)
        states, _ = jax.vmap(env.reset)(jax.vmap(jax.random.fold_in,
            (0, None))(step_keys, 0))
        reset.append(_draws(states, env.env.num_targets))
    draws = dict(u=np.stack(u), reset=np.stack(reset),
        init=_draws(jdata.carry['env'], env.env.num_targets))
    jax_ppo.evaluate(jdata)
    jax_ppo.train(jdata)
    assert np.isfinite(jdata.losses.policy_loss)
    return weights, draws, state_dict()


JAX_CASES = {
    # (recurrent, minibatch_size, port config): 4 minibatches of one time
    # slab each; 2 of agent-major segments (JAX's recurrent layout when
    # minibatches != slabs); the MLP agent-major (JAX's mesh layout)
    'lstm_time_slabs': (True, 128, {}),
    'lstm_agent_major': (True, 256, {}),
    'mlp_agent_major': (False, 256,
        dict(mlp_contiguous_minibatches=False)),
}


@pytest.mark.parametrize('case', sorted(JAX_CASES))
def test_two_ranks_match_the_jax_mesh(tmp_path, case):
    recurrent, minibatch_size, port_cfg = JAX_CASES[case]
    seed = 11
    weights, draws, want = jax_mesh_run(tmp_path, recurrent,
        minibatch_size, seed)
    np.savez(tmp_path / 'weights.npz', **weights)
    np.savez(tmp_path / 'draws.npz', **draws)
    spec = dict(num_envs=LANES, hidden=HIDDEN,
        policy='lstm' if recurrent else 'mlp',
        weights=str(tmp_path / 'weights.npz'),
        draws=str(tmp_path / 'draws.npz'),
        config=dict(batch_size=BATCH, minibatch_size=minibatch_size,
            bptt_horizon=HORIZON, total_timesteps=2048, seed=seed,
            **port_cfg))
    got, ranks = run_ranks(tmp_path, spec, 2, [2])
    assert [r['lanes'] for r in ranks] == [[0, 8], [8, 16]]
    assert all(r['params_differ'] == 0.0 for r in ranks)
    moved = max(float(np.abs(want[k] - weights[k]).max()) for k in want)
    assert moved > 1e-4, 'the update must move the params'
    assert_params_close(got, want, rtol=1e-4, atol=1e-5)


PORT_CASES = {
    # the contiguous MLP layout: a minibatch (256 rows) is a multiple of
    # the 16 agent rows, so each rank trains on its own rows
    'contiguous': dict(),
    # every minibatch gathered and split [r::k]; target_kl's stop read
    # from the global approx_kl
    'shuffle_target_kl': dict(shuffle_minibatches=True, target_kl=1e-3),
}


@pytest.mark.parametrize('case', sorted(PORT_CASES))
def test_two_ranks_match_one_rank_and_no_mesh(tmp_path, case):
    spec = dict(num_envs=LANES, hidden=HIDDEN, epochs=2,
        config=dict(batch_size=BATCH, minibatch_size=256,
            bptt_horizon=HORIZON, seed=3, **PORT_CASES[case]))
    ref = no_mesh(tmp_path, spec)
    two, ranks = run_ranks(tmp_path / 'two', spec, 2, [2])
    one, single = run_ranks(tmp_path / 'one', spec, 1, [1])
    assert all(r['params_differ'] == 0.0 for r in ranks)
    assert ranks[0]['losses'] == ranks[1]['losses']
    assert_params_close(two, ref['params'], rtol=1e-4, atol=1e-5)
    assert_params_close(one, ref['params'], rtol=1e-4, atol=1e-5)
    for got in (ranks[0], single[0]):
        for epoch, losses in enumerate(ref['losses']):
            for k, v in losses.items():
                assert got['losses'][epoch][k] == pytest.approx(v,
                    rel=1e-4, abs=1e-5), (epoch, k)
        assert got['stats'] == pytest.approx(ref['stats'], rel=1e-4)


ENV_CASES = {
    # two agents a lane: a rank's agent rows are its lanes' (agent-major),
    # the sampler's uniforms drawn per row and the resets per lane; the
    # agent-major layout gathers them
    'multiagent': dict(env='multiagent', config=dict(batch_size=1024,
        minibatch_size=256, mlp_contiguous_minibatches=False)),
    # a structured observation (nativized) and a MultiDiscrete [2, 2]
    # action: two uniforms a row
    'spaces': dict(env='spaces', config=dict(batch_size=512,
        minibatch_size=128, shuffle_minibatches=True)),
}


@pytest.mark.parametrize('case', sorted(ENV_CASES))
def test_two_ranks_match_no_mesh_on_other_envs(tmp_path, case):
    spec = dict(ENV_CASES[case], num_envs=LANES, hidden=HIDDEN, epochs=2)
    spec['config'] = dict(spec['config'], bptt_horizon=4, seed=5)
    ref = no_mesh(tmp_path, spec)
    got, ranks = run_ranks(tmp_path / 'two', spec, 2, [2])
    assert [r['lanes'] for r in ranks] == [[0, 8], [8, 16]]
    assert_params_close(got, ref['params'], rtol=1e-4, atol=1e-5)
    assert ranks[0]['stats'] == pytest.approx(ref['stats'], rel=1e-4)


def test_create_refuses_under_a_mesh(tmp_path):
    """Under a model axis the kernels (use_kernel True on Default, True or
    None on LSTMWrapper); lanes or minibatch segments that do not divide
    over the env axis: an APIUsageError on every rank, before any step."""
    spec = dict(refusals=True, world=2, out=str(tmp_path / 'out'))
    path = tmp_path / 'spec.json'
    path.write_text(json.dumps(spec))
    proc = subprocess.run([sys.executable, WORKER, str(path)], cwd=REPO,
        capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-4000:]
    for rank in json.loads((tmp_path / 'out.json').read_text()):
        for name in ('default_use_kernel', 'lstm_use_kernel_none',
                'lstm_use_kernel_true'):
            assert 'use_kernel=False' in rank[name], (name, rank[name])
        assert 'lanes' in rank['lanes'] and '15' in rank['lanes']
        assert 'segments' in rank['seg_rows']
        assert rank['lstm_use_kernel_false'] == 'built'


def test_parallel_imports_no_jax():
    """parallel/ imports neither jax nor pufferlib_tpu (a fresh
    interpreter: this one has both), and exports the JAX package's
    names."""
    import pufferlib_tpu.parallel as jax_parallel
    import pufferlib_tpu_torch.parallel as parallel
    assert parallel.__all__ == jax_parallel.__all__
    code = ('import sys, pufferlib_tpu_torch.parallel, '
        'pufferlib_tpu_torch.parallel.mesh, '
        'pufferlib_tpu_torch.parallel.multihost; '
        'bad = [m for m in sys.modules if m in ("jax", "flax", "optax", '
        '"pufferlib_tpu") or m.startswith(("jax.", "flax.", "optax.", '
        '"pufferlib_tpu."))]; assert not bad, bad')
    subprocess.run([sys.executable, '-c', code], cwd=REPO, check=True,
        timeout=120)
