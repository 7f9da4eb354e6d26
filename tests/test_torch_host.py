"""The host path of the PyTorch port against the JAX package.

- spaces.from_gymnasium / to_gymnasium give the JAX package's spaces.
- host_env and vector_host (HostSerial, and HostMultiprocessing with and
  without the native driver, and through the pipelined recv_async /
  send_to protocol) step the mock envs of host_fixtures (the port's copy
  beside the JAX package's) over the mock space grid: obs bytes, rewards,
  terminals, truncations, masks, agent ids and infos equal the JAX
  package's HostSerial on the same creators, seeds and actions, exactly.
- PettingZoo: padding of absent agents (zero obs, masked out, terminal)
  and the fixed agent set, exactly as the JAX package's.
- The Atari wrapper stack (and NoopReset, MaxAndSkip) on the fake ALE,
  exactly as the JAX package's wrappers; postprocess.EpisodeStats.
- The native envpool driver (the port's copy of csrc/envpool.cpp) builds
  with g++ and gathers as numpy does.
- A spawned worker that imports the host modules does not import torch
  or gymnasium.
"""
import functools
import subprocess
import sys

import numpy as np
import pytest

gymnasium = pytest.importorskip('gymnasium')

from pufferlib_tpu import host_env as jhost_env
from pufferlib_tpu import spaces as jspaces
from pufferlib_tpu import vector_host as jvector_host
from pufferlib_tpu.environments.atari import wrappers as jwrappers
from pufferlib_tpu.environments.test import host_fixtures as jfixtures
from pufferlib_tpu.postprocess import EpisodeStats as JaxEpisodeStats

from pufferlib_tpu_torch import host_env, native, spaces, vector_host
from pufferlib_tpu_torch.environments.atari import wrappers
from pufferlib_tpu_torch.environments.test import host_fixtures
from pufferlib_tpu_torch.postprocess import EpisodeStats

COMBOS = [
    ('box', 'discrete'),
    ('image', 'multidiscrete'),
    ('dict_mixed', 'discrete'),
    ('tuple_nested', 'dict_discrete'),
]
NUM_ENVS = 3
STEPS = 13  # crosses the 5-step episode boundary twice (auto-reset)


def _actions(space, n, rng):
    if getattr(space, 'shape', ()):
        nvec = np.asarray(space.nvec)
        return np.stack([rng.randint(0, nvec) for _ in range(n)])
    return rng.randint(0, space.n, n)


def _stream(vec, steps=STEPS, seed=11, rng_seed=0):
    """reset(seed) and `steps` steps of random actions: every recv's
    arrays (copied) and infos."""
    rng = np.random.RandomState(rng_seed)
    vec.async_reset(seed)
    out = [tuple(np.array(a) for a in vec.recv()[:4])]
    for _ in range(steps):
        vec.send(_actions(vec.single_action_space, vec.num_agents, rng))
        o, r, d, t, infos, ids, mask = vec.recv()
        out.append((np.array(o), np.array(r), np.array(d), np.array(t),
            infos, np.array(ids), np.array(mask)))
    vec.close()
    return out


def _assert_streams_equal(got, want):
    assert len(got) == len(want)
    for t, (g, w) in enumerate(zip(got, want)):
        for i, (a, b) in enumerate(zip(g, w)):
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype and a.shape == b.shape, (t, i)
                assert a.tobytes() == b.tobytes(), (t, i)
            else:
                assert a == b, (t, i)


def _jax_serial(obs_name, atn_name, num_envs=NUM_ENVS):
    return jvector_host.make(functools.partial(jfixtures.GymnasiumTestEnv,
        obs_name, atn_name), backend=jvector_host.HostSerial,
        num_envs=num_envs)


@pytest.mark.parametrize('obs_name,atn_name', COMBOS)
def test_spaces_convert_as_jax(obs_name, atn_name):
    obs, atn = host_fixtures.host_mock_spaces()
    for space in (obs[obs_name], atn[atn_name]):
        got, want = spaces.from_gymnasium(space), jspaces.from_gymnasium(space)
        assert repr(got) == repr(want)
        assert repr(spaces.from_gymnasium(got)) == repr(got)
        back = spaces.to_gymnasium(got)
        assert type(back) is type(space) and back == space


@pytest.mark.parametrize('obs_name,atn_name', COMBOS)
def test_host_serial_equals_jax(obs_name, atn_name):
    """Every recv of the port's HostSerial over the port's fixtures equals
    the JAX package's over its own, byte for byte."""
    vec = vector_host.make(functools.partial(host_fixtures.GymnasiumTestEnv,
        obs_name, atn_name), backend=vector_host.HostSerial,
        num_envs=NUM_ENVS)
    jvec = _jax_serial(obs_name, atn_name)
    assert repr(vec.single_observation_space) == repr(
        jvec.single_observation_space)
    assert repr(vec.single_action_space) == repr(jvec.single_action_space)
    assert vec.emulated.emulated_observation_dtype == \
        jvec.emulated.emulated_observation_dtype
    _assert_streams_equal(_stream(vec), _stream(jvec))


@pytest.mark.parametrize('native_driver', [True, False])
@pytest.mark.parametrize('obs_name,atn_name', COMBOS[1:3])
def test_host_multiprocessing_equals_jax(obs_name, atn_name, native_driver):
    """The shared-memory envpool, one env a worker in full sync, with the
    native driver (g++-built) and without it: every recv equals the JAX
    package's HostSerial."""
    vec = vector_host.make(functools.partial(host_fixtures.GymnasiumTestEnv,
        obs_name, atn_name), backend=vector_host.HostMultiprocessing,
        num_envs=NUM_ENVS, num_workers=NUM_ENVS, native=native_driver)
    assert (vec._lib is not None) == native_driver
    got = _stream(vec)
    want = _stream(_jax_serial(obs_name, atn_name))
    # the pool gives agent ids and masks of its own shape; the data rows
    # are what must agree
    _assert_streams_equal([g[:5] for g in got], [w[:5] for w in want])
    for g in got[1:]:
        assert g[5].tolist() == list(range(NUM_ENVS)) and g[6].all()


def test_host_pipeline_equals_manual_envs():
    """recv_async / send_to with two of four worker groups in flight:
    each env's transition stream equals the JAX package's env stepped by
    hand with the same actions, byte for byte."""
    vec = vector_host.make(functools.partial(host_fixtures.GymnasiumTestEnv,
        'box', 'discrete'), backend=vector_host.HostMultiprocessing,
        num_envs=4, num_workers=4, batch_size=2, native=True)
    assert vec.supports_pipeline
    vec.async_reset(seed=11)
    per_env, steps_done, outstanding = {}, dict.fromkeys(range(4), 0), []
    for _ in range(2):
        o, r, d, t, infos, ids, mask, token = vec.recv_async()
        outstanding.append((o.copy(), r.copy(), d.copy(), ids, token))
    while min(steps_done.values()) < 6:
        o, r, d, ids, token = outstanding.pop(0)
        for row, env_id in enumerate(ids):
            per_env.setdefault(int(env_id), []).append(
                (o[row].tobytes(), float(r[row]), bool(d[row])))
        actions = np.asarray([(int(e) * 3 + steps_done[int(e)]) % 2
            for e in ids], np.int32)
        for e in ids:
            steps_done[int(e)] += 1
        vec.send_to(actions, token)
        o, r, d, t, infos, ids, mask, token = vec.recv_async()
        outstanding.append((o.copy(), r.copy(), d.copy(), ids, token))
    vec.close()
    for env_id, stream in per_env.items():
        env = jhost_env.GymnasiumPufferEnv(
            env=jfixtures.GymnasiumTestEnv('box', 'discrete'))
        obs, _ = env.reset(seed=11 + env_id)
        want = [(np.asarray(obs).tobytes(), 0.0, False)]
        for t in range(len(stream) - 1):
            if env.done:
                obs, _ = env.reset()
                rew, done = 0.0, False
            else:
                obs, rew, done, _, _ = env.step((env_id * 3 + t) % 2)
            want.append((np.asarray(obs).tobytes(), float(rew), bool(done)))
        assert stream == want, env_id


class _DyingAgents:
    """A two-agent parallel env whose agent 2 leaves after its second
    step; both end at the fifth."""

    def __init__(self):
        self.possible_agents = [1, 2]
        self.agents = []
        self.render_mode = None
        self._space = gymnasium.spaces.Box(-1, 1, (3,), np.float32)

    def observation_space(self, agent):
        return self._space

    def action_space(self, agent):
        return gymnasium.spaces.Discrete(4)

    def _obs(self, agent):
        return np.full(3, 0.1 * agent + 0.01 * self.t, np.float32)

    def reset(self, seed=None):
        self.t = 0
        self.agents = [1, 2]
        return {a: self._obs(a) for a in self.agents}, {
            a: {} for a in self.agents}

    def step(self, actions):
        self.t += 1
        obs = {a: self._obs(a) for a in self.agents}
        rewards = {a: float(actions[a]) + self.t for a in self.agents}
        dones = {a: self.t >= (2 if a == 2 else 5) for a in self.agents}
        truncs = {a: False for a in self.agents}
        infos = {a: {} for a in self.agents}
        self.agents = [a for a in self.agents if not dones[a]]
        return obs, rewards, dones, truncs, infos

    def close(self):
        pass


@pytest.mark.parametrize('make_env', [
    lambda: _DyingAgents(),
    lambda: host_fixtures.PettingZooTestEnv('box', 'discrete')])
def test_pettingzoo_padding_equals_jax(make_env):
    """PettingZooPufferEnv under HostSerial: absent agents' rows zeroed,
    masked out and terminal, the fixed agent set, equal to the JAX
    package's exactly (its PettingZooTestEnv beside the port's)."""
    jfix = {host_fixtures.PettingZooTestEnv: jfixtures.PettingZooTestEnv}
    probe = make_env()
    jmake = (lambda: jfix[type(probe)]('box', 'discrete')) \
        if type(probe) in jfix else make_env
    vec = vector_host.make(lambda: host_env.PettingZooPufferEnv(
        env=make_env()), backend=vector_host.HostSerial, num_envs=2)
    jvec = jvector_host.make(lambda: jhost_env.PettingZooPufferEnv(
        env=jmake()), backend=jvector_host.HostSerial, num_envs=2)
    got, want = _stream(vec, steps=9), _stream(jvec, steps=9)
    _assert_streams_equal(got, want)
    if isinstance(probe, _DyingAgents):
        # agent 2 left at step 2: its rows are padding from then on
        o, r, d, t, _, _, mask = got[3]
        assert not mask[1] and d[1] and r[1] == 0 and not o[1].any()


def _atari_stack(mod, episode_stats, noop_skip=False):
    env = host_fixtures.FakeALE(life_every=23, frame_shape=(2, 12, 12))
    if noop_skip:
        env = mod.MaxAndSkipEnv(mod.NoopResetEnv(env, noop_max=5), skip=4)
    env = mod.EpisodicLifeEnv(env)
    env = mod.FireResetEnv(env)
    env = mod.ClipRewardEnv(env)
    return episode_stats(env)


@pytest.mark.parametrize('noop_skip', [False, True])
def test_atari_wrappers_equal_jax(noop_skip):
    """The port's Atari stack (EpisodicLife, FireReset, sign-clip,
    EpisodeStats; with NoopReset and MaxAndSkip) and the JAX package's, on
    the fake ALE (a life lost every 23 steps, 4 lives), through
    GymnasiumPufferEnv: every step's obs bytes, reward, terminal,
    truncation and info equal, across life losses and game overs."""
    env = host_env.GymnasiumPufferEnv(env=_atari_stack(wrappers,
        EpisodeStats, noop_skip))
    jenv = jhost_env.GymnasiumPufferEnv(env=_atari_stack(jwrappers,
        JaxEpisodeStats, noop_skip))
    rng = np.random.RandomState(0)
    got = [env.reset(seed=3)]
    want = [jenv.reset(seed=3)]
    ends = 0
    for _ in range(200):
        action = rng.randint(0, 4)
        for e, out in ((env, got), (jenv, want)):
            out.append(e.reset() if e.done else e.step(action))
        ends += bool(got[-1][-1])
    assert ends >= 3
    for g, w in zip(got, want):
        assert len(g) == len(w)
        assert np.asarray(g[0]).tobytes() == np.asarray(w[0]).tobytes()
        assert [str(x) for x in g[1:]] == [str(x) for x in w[1:]]


def test_fake_atari_matches_rehearsal_shapes():
    """make_fake_atari is tools/rehearse_atari.py's env: 4x84x84 uint8,
    four actions, episode stats at each life lost."""
    env = host_fixtures.make_fake_atari()
    assert env.single_observation_space.shape == (4, 84, 84)
    assert env.single_observation_space.dtype == np.uint8
    assert env.single_action_space.n == 4
    env.reset(seed=0)
    infos = []
    for _ in range(200):
        infos.append(env.reset()[1] if env.done else env.step(2)[-1])
    assert any('episode_return' in i for i in infos)


def test_native_driver_builds_and_gathers():
    lib = native.load(required=True)
    assert native.library_path().endswith('.so')
    rng = np.random.RandomState(0)
    src = rng.randint(0, 255, (6, 10)).astype(np.uint8)
    dst = np.empty((3, 10), np.uint8)
    native.gather_rows(lib, src, dst, np.array([4, 0, 2]), 10)
    assert np.array_equal(dst, src[[4, 0, 2]])
    sem = np.array([0, 5, 1, 6], np.uint8)
    ready = native.wait_ready(lib, sem, np.arange(4), 2, timeout_us=10**6)
    assert sorted(ready.tolist()) == [1, 3]


def test_host_modules_import_neither_torch_nor_gymnasium():
    """What a spawned envpool worker imports: the host modules, the
    wrappers and the fixtures, every zoo binding's module, and each fake
    the card runs through its binding's wrap (links_awaken's wrap alone
    needs gymnasium). torch and gymnasium stay out."""
    code = ('import sys\n'
        'import pufferlib_tpu_torch.vector_host, pufferlib_tpu_torch.host_env\n'
        'import pufferlib_tpu_torch.wrappers, pufferlib_tpu_torch.postprocess\n'
        'import pufferlib_tpu_torch.environments.atari.wrappers\n'
        'from pufferlib_tpu_torch.environments.test import host_fixtures\n'
        'host_fixtures.make_fake_atari().reset(seed=0)\n'
        'host_fixtures.make_fake_procgen().reset(seed=0)\n'
        'import importlib\n'
        'for name in ("bsuite", "butterfly", "classic_control", "crafter", '
        '"dm_control", "dm_lab", "griddly", "links_awaken", "magent", '
        '"microrts", "minerl", "minigrid", "nocturne", "open_spiel", '
        '"open_spiel.adapters", "slimevolley", "smac", "stable_retro", '
        '"vizdoom"):\n'
        '    importlib.import_module("pufferlib_tpu_torch.environments." '
        '+ name)\n'
        'for make in host_fixtures.ZOO2_FAKES.values():\n'
        '    make().reset(seed=0)\n'
        'print(sorted(m for m in ("torch", "gymnasium", "jax") '
        'if m in sys.modules))\n')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
        text=True, timeout=300, check=True)
    assert out.stdout.strip() == '[]', out.stdout
