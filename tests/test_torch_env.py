"""Squared and vector.Device of the PyTorch port against the JAX package.

Both packages step the same lanes with the same actions. The JAX side
draws its resets from its own keys; after each of its steps the test reads
the targets it chose (`chosen`) and hands them to the port as that step's
reset draws. obs, reward, done, truncated and every info field must then
be exactly equal, across autoresets, for both reset branches
(num_targets == 1 draws one index; k of n takes a top-k).
"""
import numpy as np
import pytest
import torch

import pufferlib_tpu.vector as jvector
from pufferlib_tpu.ocean import env_creator as jax_env_creator

import pufferlib_tpu_torch.vector as vector
from pufferlib_tpu_torch.ocean import env_creator

torch.set_num_threads(1)

STEPS = 24


def _draws(jdev, lo, hi, num_targets):
    """The port's reset draws that reproduce the JAX lanes' targets."""
    chosen = np.asarray(jdev._state.env['env']['chosen'])[lo:hi]
    if num_targets == 1:
        return torch.from_numpy(np.argmax(chosen, axis=1))
    return torch.from_numpy(chosen.astype(np.float32))


def _assert_equal(got, expected, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    expected = np.asarray(expected)
    assert got.shape == expected.shape, (what, got.shape, expected.shape)
    np.testing.assert_array_equal(got, expected.astype(got.dtype),
        err_msg=what)


def _make(kwargs, num_envs, batch_size=None):
    jdev = jvector.make(jax_env_creator('squared'), env_kwargs=kwargs,
        backend=jvector.Device, num_envs=num_envs, batch_size=batch_size)
    dev = vector.make(env_creator('squared'), env_kwargs=kwargs,
        num_envs=num_envs, batch_size=batch_size, device='cpu')
    return jdev, dev


@pytest.mark.parametrize('kwargs', [
    dict(distance_to_target=2, num_targets=1),
    dict(distance_to_target=2, num_targets=-1),
    dict(distance_to_target=3, num_targets=3),
])
def test_device_matches_jax_across_autoresets(kwargs):
    num_envs = 16
    jdev, dev = _make(kwargs, num_envs)
    nt = dev.env.env.num_targets
    assert repr(dev.single_observation_space) == repr(
        jdev.single_observation_space)
    assert repr(dev.single_action_space) == repr(jdev.single_action_space)

    jobs, _ = jdev.reset(seed=7)
    obs, _ = dev.reset(seed=7, reset_draws=_draws(jdev, 0, num_envs, nt))
    _assert_equal(obs, jobs, 'reset obs')

    rng = np.random.RandomState(0)
    resets = 0
    for t in range(STEPS):
        actions = rng.randint(0, 8, num_envs).astype(np.int32)
        jobs, jrew, jdone, jtrunc, jinfo = jdev.step(actions)
        obs, rew, done, trunc, info = dev.step(torch.from_numpy(actions),
            reset_draws=_draws(jdev, 0, num_envs, nt))
        for name, a, b in (('obs', obs, jobs), ('reward', rew, jrew),
                ('done', done, jdone), ('truncated', trunc, jtrunc)):
            _assert_equal(a, b, f'step {t} {name}')
        assert sorted(info) == sorted(jinfo)
        for k in info:
            _assert_equal(info[k], jinfo[k], f'step {t} info {k}')
        resets += int(np.sum(np.asarray(jdone)))
    assert resets > 0, 'the run must cross an autoreset'


def test_device_lane_groups_match_jax():
    """batch_size < num_envs: async send/recv cycles contiguous lane
    groups in the same order on both sides."""
    kwargs = dict(distance_to_target=1, num_targets=1)
    num_envs, batch = 12, 4
    jdev, dev = _make(kwargs, num_envs, batch)
    jdev.async_reset(seed=3)
    dev.async_reset(seed=3, reset_draws=_draws(jdev, 0, num_envs, 1))
    rng = np.random.RandomState(1)
    for t in range(3 * STEPS // 2):
        jobs, jrew, jdone, _, _, jids, _ = jdev.recv()
        obs, rew, done, _, _, ids, _ = dev.recv()
        np.testing.assert_array_equal(ids, jids)
        _assert_equal(obs, jobs, f'recv {t} obs')
        _assert_equal(rew, jrew, f'recv {t} reward')
        _assert_equal(done, jdone, f'recv {t} done')
        g = dev._group
        assert g == jdev._group
        actions = rng.randint(0, 8, batch).astype(np.int32)
        jdev.send(actions)
        dev.send(torch.from_numpy(actions),
            reset_draws=_draws(jdev, g * batch, (g + 1) * batch, 1))


def test_squared_sampled_resets_choose_k_targets():
    """Without injected draws the env samples its own: every lane gets
    exactly num_targets targets on the perimeter, agent at the centre."""
    env = env_creator('squared')(distance_to_target=2, num_targets=3,
        episode_stats=False)
    g = torch.Generator().manual_seed(0)
    state, obs = env.reset(env.sample_reset(64, 'cpu', g))
    assert obs.shape == (64, 5, 5)
    assert torch.all(state['chosen'].sum(dim=1) == 3)
    assert torch.all((obs == 1).sum(dim=(1, 2)) == 3)
    assert torch.all(obs[:, 2, 2] == -1)


def test_protocol_errors():
    dev = vector.make(env_creator('squared'), num_envs=4, device='cpu')
    from pufferlib_tpu_torch.exceptions import APIUsageError
    with pytest.raises(APIUsageError):
        dev.send(torch.zeros(4, dtype=torch.int64))
    dev.reset()
    with pytest.raises(APIUsageError):
        dev.step(torch.full((4,), 8))
    with pytest.raises(ValueError, match='Invalid environment name'):
        env_creator('no_such_env')


def test_make_builds_a_custom_backend():
    """vector.make builds whatever backend class it is given, with
    num_envs, batch_size and seed (and the port's device), as the JAX make
    does (pufferlib_tpu/vector.py:517): a small custom backend that
    subclasses Serial, through both packages' make, must agree with its
    JAX twin in what it was built with, its spaces and its lanes, and step
    to the same observations when handed the JAX lanes' reset draws."""
    class JaxCustom(jvector.Serial):
        def __init__(self, *args, batch_size=None, marker=None, **kwargs):
            super().__init__(*args, **kwargs)
            self.built_with = (batch_size, marker)

    class Custom(vector.Serial):
        def __init__(self, *args, batch_size=None, marker=None, **kwargs):
            super().__init__(*args, **kwargs)
            self.built_with = (batch_size, marker)

    kwargs = dict(distance_to_target=2, num_targets=1)
    jvec = jvector.make(jax_env_creator('squared'), env_kwargs=kwargs,
        backend=JaxCustom, num_envs=4, marker='custom')
    vec = vector.make(env_creator('squared'), env_kwargs=kwargs,
        backend=Custom, num_envs=4, marker='custom', device='cpu')
    assert type(jvec) is JaxCustom and type(vec) is Custom
    assert vec.built_with == jvec.built_with == (None, 'custom')
    assert vec.num_agents == jvec.num_agents == 4
    assert repr(vec.single_observation_space) == repr(
        jvec.single_observation_space)
    assert repr(vec.single_action_space) == repr(jvec.single_action_space)
    jobs, _ = jvec.reset(seed=3)
    chosen = np.stack([np.asarray(s['env']['chosen'])
        for s in jvec._states]).reshape(4, -1)
    vec.async_reset(3, reset_draws=torch.from_numpy(
        np.argmax(chosen, axis=1)))
    obs = vec.recv()[0]
    _assert_equal(obs, jobs, 'obs')
