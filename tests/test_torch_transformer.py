"""The PyTorch port's TransformerWrapper (pufferlib_tpu_torch/models/
transformer.py) against the JAX package's, and the port's trainers with
it, on the CPU.

Weights: the JAX module's flax init, carried by
convert.transformer_state_dict; where said, every leaf is first moved by
0.1 x a seeded normal, so that the zero biases and the zero recency bias
of the init cannot hide a wrong layout. Inputs come from numpy with a
seed.
- f32: logits and values within rtol = atol = 1e-5 and the window within
  1e-6 (the same f32 products, summed in other orders): one step,
  batch-major and time-major segments, T past the window, a carried
  state and none.
- bf16, one apply from an f32 state: the JAX module returns its window
  in bf16 (ROADMAP fault 3.2), the port in f32, equal to JAX's cast to
  f32. With the init weights every output is equal (the encoder's zero
  bias: both round its product once). With moved weights the window's
  new row is within one bf16 ulp at its scale (flax rounds the encoder's
  product and its bias add apart, the port's Linear rounds once), the
  logits and values
  within 0.05 absolute + 2% (the chain of some ten bf16 roundings).
- The port's own step-vs-segment and resume-from-snapshot contracts
  (tests/test_transformer.py:35-102).
- The fused trainer on memory against the JAX trainer in f32: the JAX
  rollout's draws injected (actions and obs exact, logprobs, values and
  the stored windows to 1e-5 / 1e-6), then one update of each on the JAX
  batch, time slabs and agent-major (params within 2e-5, stats within
  rtol 1e-4, atol 1e-5: tests/test_torch_ppo.py's tolerances); the
  rollout's T = 1 logprobs recomputed by the update's segment calls
  (the first minibatch's ratio 1); two gloo ranks against one rank and
  no mesh, through the byte gather of a state whose two tensors have
  leading sizes 8 and 1; a (1, 2) model axis (the FFN sharded, the
  attention matrices replicated) against no mesh at
  tests/test_torch_multihost.py's tensor parallel bounds.
- The bench's transformer smoke line, and the host trainer's refusal.
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
import optax
import pufferlib_tpu.vector as jax_vector
from pufferlib_tpu import spaces as jspaces
from pufferlib_tpu.models import Default as JaxDefault
from pufferlib_tpu.models import TransformerPolicy as JaxTransformerPolicy
from pufferlib_tpu.models import TransformerWrapper as JaxTransformerWrapper
from pufferlib_tpu.ocean import env_creator as jax_env_creator
from pufferlib_tpu.training import ppo as jax_ppo

import pufferlib_tpu_torch.vector as vector
from pufferlib_tpu_torch import spaces, vector_host
from pufferlib_tpu_torch.convert import (
    transformer_params, transformer_state_dict)
from pufferlib_tpu_torch.environments.test import host_fixtures
from pufferlib_tpu_torch.exceptions import APIUsageError
from pufferlib_tpu_torch.models import (
    Default, TransformerPolicy, TransformerWrapper)
from pufferlib_tpu_torch.ocean import env_creator
from pufferlib_tpu_torch.training import ppo, ppo_host

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, 'tests'))

import torch_mesh_worker  # noqa: E402

OBS = (5,)
ACT = 3
HIDDEN, WINDOW = 32, 4


def _moved(params, seed=1):
    """Every leaf of params (numpy) plus 0.1 x a seeded normal."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda a: (np.asarray(a) + 0.1 * rng.randn(
        *np.shape(a))).astype(np.float32), params)


def _jax_module(dtype=jnp.float32, window=WINDOW, hidden=HIDDEN,
        obs=OBS, action_space=None):
    return JaxTransformerWrapper(policy=JaxDefault(obs_shape=obs,
        action_space=action_space or jspaces.Discrete(ACT),
        hidden_size=hidden, dtype=dtype), obs_shape=obs, input_size=hidden,
        hidden_size=hidden, window=window, num_heads=4, dtype=dtype)


def _port_module(params, dtype=torch.float32, window=WINDOW,
        hidden=HIDDEN, obs=OBS, action_space=None):
    module = TransformerWrapper(Default(obs_shape=obs,
        action_space=action_space or spaces.Discrete(ACT),
        hidden_size=hidden, dtype=dtype), obs_shape=obs, input_size=hidden,
        hidden_size=hidden, window=window, num_heads=4, dtype=dtype)
    module.load_state_dict(transformer_state_dict(params))
    return module


def _params(jmodule, moved=True):
    params = jmodule.init(jax.random.PRNGKey(0),
        jnp.zeros((2,) + OBS, jnp.float32))
    params = jax.tree.map(np.asarray, params)
    return _moved(params) if moved else params


def test_weights_round_trip():
    params = _params(_jax_module())
    back = transformer_params(_port_module(params).state_dict())
    got = dict(jax.tree.leaves_with_path(back))
    want = dict(jax.tree.leaves_with_path(params))
    assert sorted(map(str, got)) == sorted(map(str, want))
    for path, leaf in want.items():
        np.testing.assert_array_equal(got[path], leaf, err_msg=str(path))


# (T or None for one (B, *obs) step, time_major, the state: 'random',
# 'zeros' (initial_state) or None)
LAYOUTS = {
    'step': (None, False, 'random'),
    'batch_major': (3, False, 'random'),
    'time_major': (3, True, 'random'),
    'past_window': (7, False, 'zeros'),
    'past_window_time_major': (7, True, 'random'),
    'no_state': (3, True, None),
}


@pytest.mark.parametrize('case', sorted(LAYOUTS))
def test_apply_matches_jax_in_f32(case):
    T, time_major, state_kind = LAYOUTS[case]
    B = 6
    jmodule = _jax_module()
    params = _params(jmodule)
    module = _port_module(params)
    rng = np.random.RandomState(sorted(LAYOUTS).index(case) + 2)
    lead = (B,) if T is None else (T, B) if time_major else (B, T)
    x = rng.randn(*lead, *OBS).astype(np.float32)
    state = None
    if state_kind == 'random':
        state = (rng.randn(WINDOW, B, HIDDEN).astype(np.float32),
            np.zeros((1, B, HIDDEN), np.float32))
    elif state_kind == 'zeros':
        state = tuple(np.array(s) for s in jmodule.initial_state(B))
    jlogits, jvalue, jstate = jmodule.apply(params, jnp.asarray(x),
        None if state is None else tuple(map(jnp.asarray, state)),
        time_major=time_major)
    with torch.no_grad():
        logits, value, new_state = module(torch.from_numpy(x),
            None if state is None else tuple(map(torch.from_numpy, state)),
            time_major=time_major)
    rows = B * (T or 1)
    assert logits.shape == (rows, ACT) and value.shape == (rows, 1)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(value.numpy(), np.asarray(jvalue),
        rtol=1e-5, atol=1e-5)
    assert new_state[0].shape == (WINDOW, B, HIDDEN)
    assert new_state[1].shape == (1, B, HIDDEN)
    assert new_state[0].dtype == torch.float32
    np.testing.assert_allclose(new_state[0].numpy(), np.asarray(jstate[0]),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(new_state[1].numpy(), 0)


@pytest.mark.parametrize('moved', [False, True])
def test_bf16_apply_matches_jax(moved):
    B = 6
    jmodule = _jax_module(jnp.bfloat16)
    params = _params(jmodule, moved=moved)
    module = _port_module(params, torch.bfloat16)
    rng = np.random.RandomState(7)
    x = rng.randn(B, *OBS).astype(np.float32)
    state = (rng.randn(WINDOW, B, HIDDEN).astype(np.float32),
        np.zeros((1, B, HIDDEN), np.float32))
    jlogits, jvalue, jstate = jmodule.apply(params, jnp.asarray(x),
        tuple(map(jnp.asarray, state)))
    with torch.no_grad():
        logits, value, new_state = module(torch.from_numpy(x),
            tuple(map(torch.from_numpy, state)))
    # the JAX module's window turns bf16 (fault 3.2); the port keeps the
    # dtype it was given
    assert jstate[0].dtype == jnp.bfloat16
    assert new_state[0].dtype == torch.float32
    want_window = np.asarray(jstate[0].astype(jnp.float32))
    got = [logits.float().numpy(), value.float().numpy()]
    want = [np.asarray(jlogits, np.float32), np.asarray(jvalue, np.float32)]
    if not moved:
        np.testing.assert_array_equal(new_state[0].numpy(), want_window)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        return
    # the old window's rows are exact; the new row (the encoder's outputs)
    # within one bf16 ulp at the row's scale: flax's rounding of the
    # product before the bias add shows where the two nearly cancel
    np.testing.assert_array_equal(new_state[0][:-1].numpy(),
        want_window[:-1])
    np.testing.assert_allclose(new_state[0][-1].numpy(), want_window[-1],
        rtol=0, atol=2.0 ** -7 * np.abs(want_window[-1]).max())
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0.02, atol=0.05)


def _port_built(window=WINDOW):
    module = TransformerWrapper(Default(obs_shape=OBS,
        action_space=spaces.Discrete(ACT), hidden_size=HIDDEN,
        generator=torch.Generator().manual_seed(0)), obs_shape=OBS,
        input_size=HIDDEN, hidden_size=HIDDEN, window=window, num_heads=4,
        generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        module.rel_bias.normal_(generator=torch.Generator().manual_seed(2))
    return module


def test_single_step_shapes():
    module = _port_built()
    B = 6
    obs = torch.randn((B,) + OBS, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        logits, value, (mem, aux) = module(obs, module.initial_state(B))
    assert logits.shape == (B, ACT) and value.shape == (B, 1)
    assert mem.shape == (WINDOW, B, HIDDEN)
    assert aux.shape == (1, B, HIDDEN)
    with pytest.raises(ValueError, match='shape'):
        module(torch.zeros(B, 4))


@pytest.mark.parametrize('time_major', [False, True])
def test_step_vs_segment(time_major):
    """T single steps carrying the state equal one T-step segment call,
    across a window wrap (T > window): logits and values within 1e-5,
    the window within 1e-6."""
    module = _port_built()
    B, T = 6, 7
    seq = torch.randn((T, B) + OBS, generator=torch.Generator().manual_seed(2))
    state = module.initial_state(B)
    step_logits, step_values = [], []
    with torch.no_grad():
        for t in range(T):
            lg, vl, state = module(seq[t], state)
            step_logits.append(lg)
            step_values.append(vl)
        if time_major:
            lg, vl, seg_state = module(seq, module.initial_state(B),
                time_major=True)
            lg, vl = lg.reshape(T, B, -1), vl.reshape(T, B, -1)
        else:
            lg, vl, seg_state = module(seq.transpose(0, 1),
                module.initial_state(B))
            lg = lg.reshape(B, T, -1).transpose(0, 1)
            vl = vl.reshape(B, T, -1).transpose(0, 1)
    torch.testing.assert_close(torch.stack(step_logits), lg, rtol=1e-5,
        atol=1e-5)
    torch.testing.assert_close(torch.stack(step_values), vl, rtol=1e-5,
        atol=1e-5)
    torch.testing.assert_close(state[0], seg_state[0], rtol=1e-6, atol=1e-6)


def test_segment_resumes_from_snapshot():
    """A rollout split at a segment boundary and resumed from the first
    segment's final state equals the unbroken run (the trainer's lstm0
    snapshots rely on it)."""
    module = _port_built()
    B, T, h = 5, 8, 4
    seq = torch.randn((T, B) + OBS, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        full, _, _ = module(seq, module.initial_state(B), time_major=True)
        _, _, mid = module(seq[:h], module.initial_state(B), time_major=True)
        second, _, _ = module(seq[h:], mid, time_major=True)
    torch.testing.assert_close(full.reshape(T, B, -1)[h:],
        second.reshape(T - h, B, -1), rtol=1e-5, atol=1e-5)


MEM_KWARGS = dict(mem_length=2, mem_delay=0)
STEPS, LANES, BPTT, MEM_WINDOW = 16, 8, 4, 8


def _memory_solution(states):
    """The port's memory reset draws that reproduce the JAX lanes'
    solutions (their -1 tail is set by reset)."""
    return np.maximum(np.asarray(states['env']['solution']), 0).astype(
        np.int64)


def _jax_memory_rollout():
    """The JAX trainer's rollout on memory with a TransformerPolicy in f32:
    (jvec, jpolicy, moved params, JAX batch, JAX carry, the draws it
    made as the port's rollout takes them, the initial reset draws)."""
    jvec = jax_vector.make(jax_env_creator('memory'), env_kwargs=MEM_KWARGS,
        backend=jax_vector.Device, num_envs=LANES)
    obs_shape = jvec.single_observation_space.shape
    jreset, jstep = jax_vector.make_env_ops(jvec.env, jvec.emulated)
    jpolicy = JaxTransformerPolicy(_jax_module(window=MEM_WINDOW,
        obs=obs_shape, action_space=jvec.single_action_space))
    params = _moved(jax.tree.map(np.asarray, jpolicy.init(
        jax.random.PRNGKey(2), jnp.zeros((1,) + obs_shape, jnp.float32),
        jpolicy.initial_state(1))), seed=3)
    jconfig = jax_ppo.default_config(batch_size=STEPS * LANES,
        minibatch_size=STEPS * LANES, bptt_horizon=BPTT)
    jrollout = jax_ppo.make_rollout_fn(jpolicy, jstep, jconfig, STEPS)
    key = jax.random.PRNGKey(3)
    lane_keys = jax.random.split(jax.random.PRNGKey(4), LANES)
    reset_keys = jax.random.split(jax.random.PRNGKey(5), LANES)
    env_states, obs, dones = jreset(reset_keys)
    carry = dict(env=env_states, done=dones, obs=obs, keys=lane_keys,
        t=jnp.uint32(0), lstm=jpolicy.initial_state(LANES), key=key)
    jcarry, jbatch, _, _ = jax.jit(jrollout)(params, carry)

    u, resets = [], []
    for t in range(STEPS):
        key, act_key = jax.random.split(key)
        u.append(np.asarray(jax.random.uniform(jax.random.split(act_key, 1)[0],
            (LANES,), dtype=jnp.float32)))
        step_keys = jax.vmap(jax.random.fold_in, (0, None))(lane_keys, t)
        states, _ = jax.vmap(jvec.env.reset)(jax.vmap(jax.random.fold_in,
            (0, None))(step_keys, 0))
        resets.append(_memory_solution(states))
    draws = dict(u=torch.from_numpy(np.stack(u)),
        reset=torch.from_numpy(np.stack(resets)))
    init_states, _ = jax.vmap(jvec.env.reset)(reset_keys)
    return (jvec, jpolicy, params, jax.tree.map(np.asarray, jbatch), jcarry,
        draws, torch.from_numpy(_memory_solution(init_states)))


@pytest.fixture(scope='module')
def jax_memory():
    return _jax_memory_rollout()


def _port_memory_policy(params, vecenv):
    shape = vecenv.single_observation_space.shape
    return TransformerPolicy(_port_module(params, window=MEM_WINDOW,
        obs=shape, action_space=vecenv.single_action_space))


def test_rollout_replays_jax_draws(jax_memory):
    """The JAX rollout and the port's, from the same weights and lanes
    with the JAX draws injected: actions and obs exactly; logprobs,
    values and the bootstrap value within 1e-5; the stored windows and
    the carried window within 1e-6. The rollout crosses episode ends
    (memory's every 4 steps) and the window (8) wraps."""
    _, _, params, jbatch, jcarry, draws, init = jax_memory
    vecenv = vector.make(env_creator('memory'), env_kwargs=MEM_KWARGS,
        num_envs=LANES, device='cpu')
    reset_batch, step_batch = vector.make_env_ops(vecenv.env,
        vecenv.emulated)
    policy = _port_memory_policy(params, vecenv)
    states, obs, dones = reset_batch(init)
    rollout = ppo.make_rollout_fn(policy, vecenv.env, step_batch,
        ppo.default_config(device='cpu', bptt_horizon=BPTT), STEPS,
        torch.Generator())
    carry, batch, _, episodes = rollout(dict(env=states, done=dones,
        obs=obs, lstm=policy.initial_state(LANES)), draws)

    assert episodes > 0, 'the rollout must cross episode ends'
    for name in ('action', 'obs'):
        np.testing.assert_array_equal(batch[name].numpy(), jbatch[name],
            err_msg=name)
    for name in ('logprob', 'value', 'last_value'):
        np.testing.assert_allclose(batch[name].numpy(), jbatch[name],
            rtol=0, atol=1e-5, err_msg=name)
    assert batch['lstm0'][0].shape == (STEPS // BPTT, MEM_WINDOW, LANES,
        HIDDEN)
    assert batch['lstm0'][1].shape == (STEPS // BPTT, 1, LANES, HIDDEN)
    for got, want in zip(batch['lstm0'] + carry['lstm'],
            tuple(jbatch['lstm0']) + tuple(jcarry['lstm'])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
            atol=1e-6)


# minibatch rows: one time slab of all lanes (4 minibatches, T // bptt of
# them), or two of agent-major segments
UPDATE_LAYOUTS = {'time_slab': LANES * BPTT, 'agent_major': LANES * 8}


@pytest.mark.parametrize('layout', sorted(UPDATE_LAYOUTS))
def test_update_matches_jax(jax_memory, layout):
    jvec, jpolicy, params, jbatch, _, _, _ = jax_memory
    minibatch = UPDATE_LAYOUTS[layout]
    lr = 3e-3
    overrides = dict(batch_size=STEPS * LANES, minibatch_size=minibatch,
        bptt_horizon=BPTT, update_epochs=2, learning_rate=lr,
        anneal_lr=False, verbose=False)
    num_minibatches = STEPS * LANES // minibatch
    seg_rows = minibatch // BPTT
    obs_shape = jvec.single_observation_space.shape
    tx = optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-5)
    jupdate = jax_ppo.make_update_fn(jpolicy, tx,
        jax_ppo.default_config(**overrides), STEPS, LANES, num_minibatches,
        seg_rows, obs_shape=obs_shape)
    jparams, _, jstats = jax.jit(jupdate)(params, tx.init(params),
        jax.tree.map(jnp.asarray, jbatch), jax.random.PRNGKey(1),
        jnp.float32(lr))

    vecenv = vector.make(env_creator('memory'), env_kwargs=MEM_KWARGS,
        num_envs=LANES, device='cpu')
    policy = _port_memory_policy(params, vecenv)
    optimizer = torch.optim.Adam(policy.parameters(), lr=lr,
        betas=(0.9, 0.999), eps=1e-5)
    update = ppo.make_update_fn(policy, optimizer,
        ppo.default_config(device='cpu', **overrides), STEPS, LANES,
        num_minibatches, seg_rows, obs_shape)
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()
        if k != 'lstm0'}
    tbatch['lstm0'] = tuple(torch.from_numpy(np.array(s))
        for s in jbatch['lstm0'])
    stats = update(tbatch, lr)

    got = dict(jax.tree.leaves_with_path(transformer_params(
        policy.module.state_dict())))
    before = dict(jax.tree.leaves_with_path(params))
    moved = 0.0
    for path, leaf in jax.tree.leaves_with_path(jparams):
        np.testing.assert_allclose(got[path], np.asarray(leaf), rtol=0,
            atol=2e-5, err_msg=str(path))
        moved = max(moved, float(np.abs(np.asarray(leaf)
            - before[path]).max()))
    assert moved > 1e-3, 'the update must move the params'
    assert sorted(stats) == sorted(jstats)
    for k in stats:
        np.testing.assert_allclose(stats[k].item(), float(jstats[k]),
            rtol=1e-4, atol=1e-5, err_msg=k)


def _memory_trainer(tmp_path, **overrides):
    vecenv = vector.make(env_creator('memory'), env_kwargs=MEM_KWARGS,
        num_envs=16, device='cpu')
    shape = vecenv.single_observation_space.shape
    policy = TransformerPolicy(TransformerWrapper(Default(obs_shape=shape,
        action_space=vecenv.single_action_space, hidden_size=HIDDEN,
        generator=torch.Generator().manual_seed(0)), obs_shape=shape,
        input_size=HIDDEN, hidden_size=HIDDEN, window=MEM_WINDOW,
        num_heads=4, generator=torch.Generator().manual_seed(1)))
    with torch.no_grad():
        policy.module.rel_bias.normal_(
            generator=torch.Generator().manual_seed(2))
    cfg = dict(batch_size=16 * 32, minibatch_size=16 * 8, bptt_horizon=8,
        update_epochs=1, verbose=False, device='cpu', data_dir=str(tmp_path),
        checkpoint_interval=10 ** 6)
    cfg.update(overrides)
    return ppo.create(ppo.default_config(**cfg), vecenv, policy)


@pytest.mark.parametrize('layout', ['time_slab', 'agent_major'])
def test_segments_recompute_the_rollout_logprobs(tmp_path, layout):
    """The rollout's T = 1 calls and the update's segment calls, from the
    stored windows, give the same logprobs (within 1e-5); so with
    learning rate 0 every minibatch's ratio is 1: approx_kl within 1e-6
    of 0 and no clipped row. The window (8) spans a segment (bptt 8)
    and the state carries across episode ends."""
    extra = {} if layout == 'time_slab' else dict(
        lstm_time_slab_minibatches=False)
    data = _memory_trainer(tmp_path, learning_rate=0.0, **extra)
    ppo.evaluate(data)
    batch = data.batch
    h = data.config.bptt_horizon
    obs_shape = data.vecenv.single_observation_space.shape
    with torch.no_grad():
        for c in range(batch['obs'].shape[0] // h):
            rows = slice(c * h, (c + 1) * h)
            state = tuple(s[c] for s in batch['lstm0'])
            _, logprob, _, _, _ = data.policy(
                batch['obs'][rows].reshape((h, -1) + obs_shape), state,
                action=batch['action'][rows].reshape(-1), time_major=True)
            torch.testing.assert_close(logprob.reshape(h, -1),
                batch['logprob'][rows], rtol=0, atol=1e-5)
    ppo.train(data)
    losses = data.losses
    assert abs(losses.approx_kl) < 1e-6 and abs(losses.old_approx_kl) < 1e-6
    assert losses.clipfrac == 0.0
    assert np.isfinite(losses.value_loss) and losses.grad_norm > 0


def test_trainer_steps_give_finite_stats(tmp_path):
    data = _memory_trainer(tmp_path, learning_rate=0.01)
    ppo.step(data)
    ppo.step_many(data, 2)
    assert data.epoch == 3
    assert all(np.isfinite(v) for v in data.losses.values()), data.losses
    mem, aux = data.carry['lstm']
    assert mem.shape == (MEM_WINDOW, 16, HIDDEN) and torch.any(mem != 0)
    assert aux.shape == (1, 16, HIDDEN)


def _run_ranks(tmp_path, spec, world, mesh=None, timeout=240):
    """tests/torch_mesh_worker.py's ranks on `spec` over `mesh` (the env
    axis, [world], by default): (rank 0's params, every rank's
    result)."""
    tmp_path.mkdir(exist_ok=True)
    spec = dict(spec, world=world, mesh=mesh or [world], out=str(tmp_path / 'out'),
        data_dir=str(tmp_path / 'data'), timeout=timeout - 30)
    path = tmp_path / 'spec.json'
    path.write_text(json.dumps(spec))
    proc = subprocess.run([sys.executable, torch_mesh_worker.__file__,
        str(path)], cwd=REPO, capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(str(tmp_path / 'out.npz')) as f:
        params = {k: f[k] for k in f.files}
    return params, json.loads((tmp_path / 'out.json').read_text())


def test_two_ranks_match_one_rank(tmp_path):
    """ppo.create(..., mesh=) with a TransformerPolicy over two gloo ranks
    of the env axis, against one rank and no mesh: 2 minibatches of 4
    segment slabs make the agent-major layout, so each rank's windows
    (4, 8, 8, 32) and aux slots (4, 1, 8, 32) cross the byte gather
    together. Params within rtol 1e-4, atol 1e-5 after 2 epochs, losses
    alike, every rank the same params."""
    spec = dict(num_envs=16, hidden=HIDDEN, policy='transformer', window=8,
        epochs=2, config=dict(batch_size=512, minibatch_size=256,
            bptt_horizon=8, seed=3))
    ref = torch_mesh_worker.train(dict(spec,
        data_dir=str(tmp_path / 'no_mesh')))
    two, ranks = _run_ranks(tmp_path / 'two', spec, 2)
    one, single = _run_ranks(tmp_path / 'one', spec, 1)
    assert [r['lanes'] for r in ranks] == [[0, 8], [8, 16]]
    assert all(r['params_differ'] == 0.0 for r in ranks)
    assert sorted(two) == sorted(ref['params']) == sorted(one)
    for k, v in ref['params'].items():
        np.testing.assert_allclose(two[k], v, rtol=1e-4, atol=1e-5,
            err_msg=k)
        np.testing.assert_allclose(one[k], v, rtol=1e-4, atol=1e-5,
            err_msg=k)
    for got in (ranks[0], single[0]):
        for epoch, losses in enumerate(ref['losses']):
            for k, v in losses.items():
                assert got['losses'][epoch][k] == pytest.approx(v,
                    rel=1e-4, abs=1e-5), (epoch, k)


def test_model_axis_matches_no_mesh(tmp_path):
    """A (1, 2) mesh, the model axis alone: the FFN's and the policy's
    Linear layers shard over two gloo ranks and go through sharded_linear,
    while wq / wk / wv / wo and rel_bias replicate. Against the same
    trainer with no mesh at tests/test_torch_multihost.py's tensor
    parallel bounds, rtol 1e-3, atol 1e-4, after 2 epochs."""
    spec = dict(num_envs=16, hidden=HIDDEN, policy='transformer', window=8,
        epochs=2, config=dict(batch_size=512, minibatch_size=256,
            bptt_horizon=8, seed=17))
    ref = torch_mesh_worker.train(dict(spec,
        data_dir=str(tmp_path / 'no_mesh')))
    got, ranks = _run_ranks(tmp_path / 'tp', spec, 2, mesh=[1, 2])
    assert all(r['params_differ'] == 0.0 for r in ranks)
    sharded = {part for k in ranks[0]['sharded'] for part in k.split('.')}
    assert {'ffn_in', 'ffn_out'} <= sharded, ranks[0]['sharded']
    assert not sharded & {'wq', 'wk', 'wv', 'wo', 'rel_bias'}, sharded
    assert sorted(got) == sorted(ref['params'])
    for k, v in ref['params'].items():
        np.testing.assert_allclose(got[k], v, rtol=1e-3, atol=1e-4,
            err_msg=k)
    for epoch, losses in enumerate(ref['losses']):
        for k, v in losses.items():
            assert ranks[0]['losses'][epoch][k] == pytest.approx(v,
                rel=1e-3, abs=1e-4), (epoch, k)


def test_bench_transformer_smoke_line():
    env = dict(os.environ, OMP_NUM_THREADS='2', BENCH_SMOKE='1',
        BENCH_ONLY='transformer')
    proc = subprocess.run([sys.executable, 'bench_torch.py'],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(l) for l in proc.stdout.splitlines() if l.strip()]
    assert [r['metric'] for r in lines] == [
        'ocean_squared_ppo_transformer_sps']
    rec = lines[0]
    assert set(rec) == {'metric', 'value', 'unit', 'vs_baseline', 'device'}
    assert rec['unit'] == 'steps/s' and rec['value'] > 0
    assert set(rec['device']) == {'card', 'cpu_count', 'loadavg_before',
        'loadavg_after', 'window_s', 'process_cpu_s'}
    assert rec['device']['card'] == 'cpu'
    assert 'minibatch 128' in proc.stderr


def test_host_trainer_refuses_the_transformer(tmp_path):
    """The host trainer keeps LSTM state only, as the JAX one
    (ppo_host.py:145-146): a TransformerPolicy is refused in create,
    naming the device trainer, before the envs reset."""
    vecenv = vector_host.make(host_fixtures.make_fake_procgen,
        backend=vector_host.HostSerial, num_envs=2)
    shape = vecenv.single_observation_space.shape
    policy = TransformerPolicy(TransformerWrapper(Default(obs_shape=shape,
        action_space=vecenv.single_action_space, hidden_size=16),
        obs_shape=shape, input_size=16, hidden_size=16, window=4,
        num_heads=4))
    config = ppo_host.default_config(batch_size=64, minibatch_size=32,
        bptt_horizon=8, device='cpu', data_dir=str(tmp_path))
    with pytest.raises(APIUsageError, match='ppo.create'):
        ppo_host.create(config, vecenv, policy)
    vecenv.close()
