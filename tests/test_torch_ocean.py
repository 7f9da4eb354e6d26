"""The nine other Ocean envs, vector.Device and vector.Serial of the
PyTorch port against the JAX package.

Both packages step the same lanes with the same actions through
vector.Device. The JAX side draws its randomness from its own keys; the
port is handed the same draws:
- reset draws are read back from the JAX lanes' state after each of its
  steps (Memory's solution, Spaces' obs, VisualTarget's cells; the other
  envs draw nothing at reset), and only lanes that reset read them;
- step draws (Bandit's reward noise, the Performance envs' spread) are
  the standard normals of the JAX lanes' keys, folded as
  pufferlib_tpu/vector.py and autoreset_step fold them:
  normal(fold_in(fold_in(lane_key, t), 1)); Bandit's unrounded, as its
  step program adds them (_bandit_noise).
obs, reward, done, truncated and every info field must then be exactly
equal, step after step, across autoresets. The Performance envs' burnt
value x is never observed; it is compared at a relative 1e-5, since XLA
may contract its multiply-add where the port rounds twice (about 6e-8
relative a round, tens of rounds). The Performance env's work rate is
set alike on both sides (each side measures its own otherwise).

The port's Serial backend, a loop over single-lane batches, must equal
its Device exactly from the same seed.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import pufferlib_tpu.vector as jvector
from pufferlib_tpu.ocean import env_creator as jax_env_creator

import pufferlib_tpu_torch.vector as vector
from pufferlib_tpu_torch import emulation
from pufferlib_tpu_torch.environments.test import environment as mock
from pufferlib_tpu_torch.exceptions import APIUsageError
from pufferlib_tpu_torch.ocean import env_creator
from pufferlib_tpu_torch.ocean.ocean import _calibrate_work_rate
from pufferlib_tpu_torch.ops.cuda.burn import burn, burn_reference

torch.set_num_threads(1)

STEPS = 24
WORK_PER_SECOND = 10_000_000
ENVS = {
    'bandit': dict(),
    'password': dict(),
    'stochastic': dict(horizon=7),
    'memory': dict(),
    'multiagent': dict(),
    'spaces': dict(),
    'visual': dict(grid_size=4, cell_px=2, horizon=6),
    'performance': dict(delay_mean=2e-6, delay_std=1e-6),
    'performance_empiric': dict(count_n=20, count_std=8),
}
ALL_ENVS = ['squared'] + sorted(ENVS)


def _reset_draws(name, jdev, lo, hi):
    """The port's reset draws that reproduce the JAX lanes' resets."""
    state = jax.tree.map(lambda x: np.asarray(x)[lo:hi],
        jdev._state.env['env'])
    if name == 'memory':
        return torch.from_numpy(np.maximum(state['solution'], 0).astype(
            np.int64))
    if name == 'spaces':
        obs = state['obs']
        return torch.from_numpy(np.concatenate([obs['image'].reshape(-1, 25),
            obs['flat'].astype(np.float32)], axis=1))
    if name == 'visual':
        return torch.from_numpy(np.concatenate([state['agent'],
            state['target']], axis=1).astype(np.int64))
    return torch.zeros((hi - lo, 0))


def _step_draws(name, kwargs, jdev, lo, hi):
    """The standard normals the JAX lanes draw at this step, or None."""
    if not (name == 'bandit' or kwargs.get('delay_std')
            or kwargs.get('count_std')):
        return None
    t = jnp.uint32(jdev._steps[jdev._group])
    keys = jdev._state.keys[lo:hi]
    z = jax.jit(jax.vmap(lambda k: jax.random.normal(jax.random.fold_in(
        jax.random.fold_in(k, t), 1))))(keys)
    return torch.from_numpy(np.asarray(z))


def _bandit_noise(jdev, lo, hi):
    """Bandit's noise as its JAX step program computes it: the normal of
    the lane's key is sqrt(2) x erfinv(u) (jax.random.normal), and XLA
    fuses erfinv(u) into the reward's sum, so the draw handed to the port
    is the product unrounded, in float64, from which Bandit's step
    recovers erfinv(u) exactly. Rounded to float32 it is the normal of
    the key, exactly."""
    t = jnp.uint32(jdev._steps[jdev._group])
    keys = jdev._state.keys[lo:hi]
    lo_u = np.nextafter(np.float32(-1), np.float32(0))

    def erfinv(k):
        u = jax.random.uniform(jax.random.fold_in(jax.random.fold_in(k, t),
            1), (), jnp.float32, lo_u, 1.0)
        return jax.lax.erf_inv(u)
    e = np.asarray(jax.jit(jax.vmap(erfinv))(keys)).astype(np.float64)
    z = np.float64(np.float32(np.sqrt(2))) * e
    np.testing.assert_array_equal(z.astype(np.float32),
        _step_draws('bandit', {}, jdev, lo, hi).numpy())
    return torch.from_numpy(z)


def _assert_equal(got, expected, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    expected = np.asarray(expected)
    assert got.shape == expected.shape, (what, got.shape, expected.shape)
    np.testing.assert_array_equal(got, expected.astype(got.dtype),
        err_msg=what)


def _make_pair(name, kwargs, num_envs, batch_size):
    jdev = jvector.make(jax_env_creator(name), env_kwargs=kwargs,
        backend=jvector.Device, num_envs=num_envs, batch_size=batch_size)
    dev = vector.make(env_creator(name), env_kwargs=kwargs,
        num_envs=num_envs, batch_size=batch_size, device='cpu')
    if name == 'performance':
        jdev.env.env.work_per_second = WORK_PER_SECOND
        dev.env.env.work_per_second = WORK_PER_SECOND
    return jdev, dev


def _random_actions(space, rows, rng):
    if hasattr(space, 'nvec'):
        return np.stack([rng.randint(0, n, rows) for n in space.nvec],
            axis=1).astype(np.int32)
    return rng.randint(0, space.n, rows).astype(np.int32)


def _run_against_jax(name, num_envs, batch_size=None, kwargs=None):
    kwargs = ENVS[name] if kwargs is None else kwargs
    jdev, dev = _make_pair(name, kwargs, num_envs, batch_size)
    assert repr(dev.single_observation_space) == repr(
        jdev.single_observation_space)
    assert repr(dev.single_action_space) == repr(jdev.single_action_space)
    assert dev.num_agents == jdev.num_agents
    B = batch_size or num_envs
    jdev.async_reset(seed=7)
    dev.async_reset(seed=7, reset_draws=_reset_draws(name, jdev, 0,
        num_envs))
    rng = np.random.RandomState(len(name))
    ends = 0
    for t in range(STEPS + (num_envs // B - 1) * STEPS):
        jobs, jrew, jdone, jtrunc, jinfo, jids, jmask = jdev.recv()
        obs, rew, done, trunc, info, ids, mask = dev.recv()
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_array_equal(mask, jmask)
        for what, a, b in (('obs', obs, jobs), ('reward', rew, jrew),
                ('done', done, jdone), ('truncated', trunc, jtrunc)):
            _assert_equal(a, b, f'recv {t} {what}')
        assert sorted(info) == sorted(jinfo), (sorted(info), sorted(jinfo))
        for k in info:
            _assert_equal(info[k], jinfo[k], f'recv {t} info {k}')
        ends += int(np.sum(np.asarray(jdone)))
        if name.startswith('performance'):
            np.testing.assert_allclose(dev._state.env['env']['x'].numpy(),
                np.asarray(jdev._state.env['env']['x']), rtol=1e-5,
                atol=0, err_msg=f'recv {t} x')
        g = jdev._group
        assert dev._group == g
        lo, hi = g * B, (g + 1) * B
        step_draws = _bandit_noise(jdev, lo, hi) if name == 'bandit' \
            else _step_draws(name, kwargs, jdev, lo, hi)
        actions = _random_actions(dev.single_action_space, dev.batch_agents,
            rng)
        jdev.send(actions)
        dev.send(torch.from_numpy(actions),
            reset_draws=_reset_draws(name, jdev, lo, hi),
            step_draws=step_draws)
    return ends, dev


@pytest.mark.parametrize('name', sorted(ENVS))
def test_device_matches_jax_across_autoresets(name):
    ends, dev = _run_against_jax(name, num_envs=16)
    if not name.startswith('performance'):
        assert ends > 0, 'the run must cross an autoreset'
    else:
        # the burn ran: x moved off 0
        assert torch.all(dev._state.env['env']['x'] > 0)


def test_bandit_reward_scale_matches_jax():
    """A reward_scale that is not exact in binary: XLA folds sqrt(2) x
    reward_scale into one float32 constant, which the port must round
    alike."""
    ends, _ = _run_against_jax('bandit', num_envs=16,
        kwargs=dict(reward_scale=0.3))
    assert ends > 0


def test_multiagent_lane_groups_match_jax():
    """batch_size < num_envs with two agents a lane: lane groups cycle in
    the same order, rows agent-major within a lane, on both sides."""
    ends, dev = _run_against_jax('multiagent', num_envs=8, batch_size=4)
    assert dev.batch_agents == 8 and dev.num_agents == 16
    assert ends > 0


@pytest.mark.parametrize('name', ALL_ENVS)
def test_serial_matches_device(name):
    """Serial's single-lane batches give Device's results bit for bit,
    from the same seed (the same draws, in the same order)."""
    kwargs = ENVS.get(name, {})
    devs = [vector.make(env_creator(name), env_kwargs=kwargs, backend=b,
        num_envs=6, device='cpu') for b in (vector.Device, vector.Serial)]
    outs = [[d.reset(seed=3)[0]] for d in devs]
    rng = np.random.RandomState(1)
    for _ in range(12):
        actions = torch.from_numpy(_random_actions(
            devs[0].single_action_space, devs[0].num_agents, rng))
        for d, out in zip(devs, outs):
            obs, rew, done, trunc, info = d.step(actions)
            out.extend([obs, rew, done, trunc] + [info[k]
                for k in sorted(info)])
    for a, b in zip(*outs):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert len(outs[0]) == len(outs[1])


def test_serial_refuses_lane_groups():
    with pytest.raises(APIUsageError, match='Device'):
        vector.make(env_creator('bandit'), backend=vector.Serial,
            num_envs=4, batch_size=2, device='cpu')


@pytest.mark.parametrize('name', ['dict_mixed-dict_discrete',
    'tuple_nested-tuple_discrete', 'discrete_obs-multidiscrete',
    'nmmo_like-nmmo_actions'])
def test_mock_env_through_device_and_serial(name):
    """The mock suite's structured obs go through the vector engine: the
    flat batch nativizes back to each lane's drawn observation, and
    Serial equals Device."""
    devs = [vector.make(mock.env_creator(name), backend=b, num_envs=3,
        device='cpu') for b in (vector.Device, vector.Serial)]
    draws = devs[0].env.sample_reset(3, 'cpu', torch.Generator().manual_seed(0))
    obs = [d.reset(reset_draws=draws)[0] for d in devs]
    assert torch.equal(obs[0], obs[1])
    assert torch.equal(obs[0].reshape(3, -1), draws[:, 0])
    rng = np.random.RandomState(2)
    for t in range(10):
        actions = torch.from_numpy(_random_actions(
            devs[0].single_action_space, 3, rng))
        steps = [d.step(actions, reset_draws=draws) for d in devs]
        for a, b in zip(steps[0][:4], steps[1][:4]):
            assert torch.equal(a, b)
        tick = (t + 1) % 9
        assert torch.equal(steps[0][0].reshape(3, -1), draws[:, tick])
    leaves = devs[0].nativize(steps[0][0])
    assert torch.equal(emulation.emulate_tensor(leaves, devs[0].emulated),
        steps[0][0])


def test_burn_plain_version_and_checks():
    """The burn's plain version is the masked loop of v * 1.0000001 + 1e-9
    on each lane; a count <= 0 leaves its lane."""
    x = torch.tensor([0.0, 1.0, 2.0, 3.0])
    iters = torch.tensor([0, 3, -2, 1], dtype=torch.int32)
    got = burn(x, iters)
    want = x.numpy().copy()
    for i, k in enumerate(iters.tolist()):
        for _ in range(max(k, 0)):
            want[i] = np.float32(np.float32(want[i] * np.float32(1.0000001))
                + np.float32(1e-9))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(burn_reference(x, iters), got)
    with pytest.raises(ValueError, match='int32'):
        burn(x, iters.long())
    with pytest.raises(ValueError, match='float32'):
        burn(x.double(), iters)
    assert isinstance(_calibrate_work_rate('cpu'), int)


def test_renders():
    for name in ('memory', 'password', 'squared', 'visual'):
        env = env_creator(name)()
        state, _ = env.reset(env.sample_reset(2, 'cpu',
            torch.Generator().manual_seed(0)))
        text = env.render(state)
        assert '\033[' in text, name
