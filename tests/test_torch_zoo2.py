"""The port's last zoo bindings (pufferlib_tpu_torch.environments: bsuite,
butterfly, classic_control, crafter, dm_control, dm_lab, griddly,
links_awaken, magent, microrts, minerl, minigrid, nocturne, open_spiel
with its adapters, slimevolley, smac, stable_retro, vizdoom), minigrid's
host trainer and the two examples left, against the JAX package's, on
the CPU.

- Each binding's make beside the JAX binding's on the same backend, the
  same seed and the same action sequence: real backends for
  classic_control (CartPole-v1), dm_control (walker-walk) and butterfly
  (pettingzoo's cooperative_pong_v6 under v5's name, which pettingzoo
  1.26 deprecates); elsewhere the fakes of
  tests/test_zoo_fake_backends{,2,3}.py and tests/test_open_spiel_fake.py
  (or like ones), installed through sys.modules for both packages. The
  flat spaces, observations, rewards, terminals, truncations, masks and
  infos are exactly equal. Each binding's make raises the JAX binding's
  ImportError without its backend. bsuite's episode budget and nocturne's
  scenario truncation, as the JAX tests hold them.
- links_awaken's Policy against the JAX module with the weights carried
  by convert.convolutional_layers: logits and values within 1e-5 (f32).
- config.yaml's minigrid path at a small size: the port's ppo_host
  against the JAX host trainer over their minigrid bindings on the same
  fake (8 envs, LSTMWrapper(Default) hidden 32, bptt 4, batch 256), the
  JAX sampler's uniforms (and, shuffled, its segment permutations)
  injected: actions, observations, rewards and dones exactly, logprobs
  and values to 1e-5, every parameter after the update to 1e-4 and the
  losses to 1e-4 of their size (tests/test_torch_ppo_host.py's
  tolerances: the same f32 math summed in other orders). The port's LSTM
  runs kernel='off'.
- The fakes the card runs (environments.test.host_fixtures.ZOO2_FAKES):
  one HostSerial ppo_host epoch each on the CPU, finite losses.
- examples/wrap_one_env_torch.py prints what examples/wrap_one_env.py
  prints; examples/cleanrl_style_ppo_torch.py --device cpu prints 30
  finite scores, the last above 0.4 (the JAX example on the CPU reaches
  0.555 at its last epoch), with nothing of JAX imported.
"""
import copy
import functools
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

gymnasium = pytest.importorskip('gymnasium')

import jax
import jax.numpy as jnp

import test_open_spiel_fake as spiel_fakes
import test_zoo_fake_backends as fakes1
import test_zoo_fake_backends2 as fakes2
import test_zoo_fake_backends3 as fakes3
from pufferlib_tpu import vector_host as jvector_host
from pufferlib_tpu.models import Default as JaxDefault
from pufferlib_tpu.models import LSTMWrapper as JaxLSTMWrapper
from pufferlib_tpu.models import RecurrentPolicy as JaxRecurrentPolicy
from pufferlib_tpu.training import ppo as jax_ppo
from pufferlib_tpu.training import ppo_host as jax_ppo_host

from pufferlib_tpu_torch import spaces, vector_host
from pufferlib_tpu_torch.config import cli
from pufferlib_tpu_torch.convert import (
    convolutional_layers, layers_state_dict, lstm_state_dict)
from pufferlib_tpu_torch.environments.test import host_fixtures
from pufferlib_tpu_torch.models import Default, LSTMWrapper, RecurrentPolicy
from pufferlib_tpu_torch.training import ppo_host

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BINDINGS = ('bsuite', 'butterfly', 'classic_control', 'crafter',
    'dm_control', 'dm_lab', 'griddly', 'links_awaken', 'magent', 'microrts',
    'minerl', 'minigrid', 'nocturne', 'open_spiel', 'slimevolley', 'smac',
    'stable_retro', 'vizdoom')


def _modules(name):
    import importlib
    return (importlib.import_module(f'pufferlib_tpu.environments.{name}'),
        importlib.import_module(f'pufferlib_tpu_torch.environments.{name}'))


@pytest.fixture
def fake_module(monkeypatch):
    def install(name, **attrs):
        mod = types.ModuleType(name)
        for k, v in attrs.items():
            setattr(mod, k, v)
        monkeypatch.setitem(sys.modules, name, mod)
        return mod
    return install


# --------------------------------------------------------------------------
# Fakes beside the JAX tests' (those defined inside a JAX test function,
# and ones whose observations move with the tick, so that a step out of
# place shows)

class FakeGriddly(gymnasium.Env):
    observation_space = gymnasium.spaces.Box(0, 255, (5, 5, 2), np.uint8)
    action_space = gymnasium.spaces.Discrete(5)
    render_mode = None

    def reset(self, seed=None, options=None):
        self.t = 0
        return np.zeros((5, 5, 2), np.uint8), {}

    def step(self, action):
        self.t += 1
        obs = np.full((5, 5, 2), self.t * 10 + int(action), np.uint8)
        return obs, float(action), self.t >= 3, False, {'kills': self.t}


class FakeDoom(gymnasium.Env):
    observation_space = gymnasium.spaces.Dict({
        'screen': gymnasium.spaces.Box(0, 255, (60, 80, 3), np.uint8),
        'gamevariables': gymnasium.spaces.Box(-np.inf, np.inf, (1,),
            np.float32),
    })
    action_space = gymnasium.spaces.Discrete(8)
    render_mode = None

    def _obs(self):
        return {'screen': np.full((60, 80, 3), self.t, np.uint8),
            'gamevariables': np.array([100.0 - self.t], np.float32)}

    def reset(self, seed=None, options=None):
        self.t = 0
        return self._obs(), {}

    def step(self, action):
        self.t += 1
        return self._obs(), 1.0, self.t >= 3, False, {}


class FakeMineRL:
    def __init__(self):
        self.observation_space = gymnasium.spaces.Dict({
            'pov': gymnasium.spaces.Box(0, 255, (16, 16, 3), np.uint8),
            'compassAngle': gymnasium.spaces.Box(-180, 180, (1,),
                np.float32),
        })
        self.action_space = gymnasium.spaces.Discrete(4)
        self.t = 0

    def _obs(self):
        return {'pov': np.full((16, 16, 3), self.t, np.uint8),
            'compassAngle': np.array([self.t * 1.5], np.float32)}

    def reset(self):
        self.t = 0
        return self._obs()

    def step(self, action):
        self.t += 1
        return self._obs(), float(action), self.t >= 3, {}

    def close(self):
        pass


class FakeRetro:
    def __init__(self):
        self.observation_space = gymnasium.spaces.Box(0, 255, (10, 10, 3),
            np.uint8)
        self.action_space = gymnasium.spaces.MultiBinary(4)
        self.t = 0

    def reset(self):
        self.t = 0
        return np.zeros((10, 10, 3), np.uint8)

    def step(self, action):
        self.t += 1
        reward = float(np.dot(np.ravel(action), [1, 2, 4, 8]))
        return np.full((10, 10, 3), self.t, np.uint8), reward, \
            self.t >= 3, {}

    def close(self):
        pass


class FakeLinks(fakes3.FakeLinksAwaken):
    """Frames that change with the tick, so the resize shows."""

    def _frame(self):
        rng = np.random.RandomState(self.t)
        return rng.randint(0, 256, (144, 160, 3)).astype(np.uint8)

    def reset(self, seed=None, options=None):
        self.t = 0
        return self._frame(), {}

    def step(self, action):
        self.t += 1
        return self._frame(), 0.5, self.t >= 3, False, {}


class FakeGridEnv(gymnasium.Env):
    """A MiniGrid env before ImgObsWrapper whose image is drawn from
    (seed, episode, tick, the actions so far) and whose reward and
    episode end follow the actions: a trainer that routes an action or
    an observation wrongly diverges."""
    observation_space = fakes1.FakeMiniGrid.observation_space
    action_space = gymnasium.spaces.Discrete(7)
    render_mode = None

    def __init__(self):
        self._seed, self._episode = 0, 0

    def _obs(self):
        rng = np.random.RandomState((self._seed * 7919 + self._episode * 101
            + self.t * 13 + self.total) % 2 ** 31)
        return {'image': rng.randint(0, 11, (7, 7, 3)).astype(np.uint8),
            'direction': self.t % 4, 'mission': 'go'}

    def reset(self, seed=None, options=None):
        if seed is not None:
            self._seed, self._episode = seed, 0
        else:
            self._episode += 1
        self.t = self.total = 0
        return self._obs(), {}

    def step(self, action):
        self.t += 1
        self.total += int(action)
        done = self.t >= 6 or (action == 2 and self.t >= 3)
        reward = (1.0 - 0.1 * self.t) if done and action == 2 else 0.0
        return self._obs(), reward, done, False, {}


# --------------------------------------------------------------------------
# Each binding beside the JAX one


def _spaces_equal(a, b):
    assert type(a).__name__ == type(b).__name__, (a, b)
    for attr in ('shape', 'n', 'nvec', 'low', 'high'):
        if hasattr(b, attr):
            np.testing.assert_array_equal(np.asarray(getattr(a, attr)),
                np.asarray(getattr(b, attr)), err_msg=attr)
    if hasattr(b, 'dtype'):
        assert np.dtype(a.dtype) == np.dtype(b.dtype)


def _snapshot(x):
    if isinstance(x, dict):
        return {k: _snapshot(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return [_snapshot(v) for v in x]
    if isinstance(x, (str, bytes)):
        return x
    return np.array(x, copy=True)


def _equal(a, b, where):
    if isinstance(b, dict):
        assert sorted(a, key=str) == sorted(b, key=str), where
        for k in b:
            _equal(a[k], b[k], f'{where}/{k}')
    elif isinstance(b, list):
        assert len(a) == len(b), where
        for i, (u, v) in enumerate(zip(a, b)):
            _equal(u, v, f'{where}/{i}')
    elif isinstance(b, str):
        assert a == b, where
    else:
        assert np.asarray(a).dtype == np.asarray(b).dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)


def _actions(space, agents, rng):
    if hasattr(space, 'nvec'):
        a = np.stack([rng.randint(0, n, agents) for n in space.nvec], 1)
    else:
        a = rng.randint(0, space.n, (agents, 1))
    return a.astype(np.int64) if agents > 1 else a[0].astype(np.int64)


def _run_both(make_jax, make_port, steps, seed=0):
    """Reset both envs with one seed and step them with one random action
    sequence (resetting where an episode ends): the flat spaces, the
    emulated dtype and every output, and the masks of a multi-agent env,
    equal. Returns the port's trace."""
    jenv, tenv = make_jax(), make_port()
    _spaces_equal(tenv.single_observation_space,
        jenv.single_observation_space)
    _spaces_equal(tenv.single_action_space, jenv.single_action_space)
    assert np.dtype(tenv.emulated.emulated_observation_dtype) == np.dtype(
        jenv.emulated.emulated_observation_dtype)
    traces = []
    for env in (jenv, tenv):
        rng = np.random.RandomState(seed)
        agents = getattr(env, 'num_agents', 1)
        trace = [_snapshot(env.reset(seed=seed))]
        for _ in range(steps):
            if env.done:
                trace.append(('reset', _snapshot(env.reset())))
                continue
            out = env.step(_actions(env.single_action_space, agents, rng))
            mask = _snapshot(getattr(env, 'mask', None)) if agents > 1 \
                else None
            trace.append(_snapshot(list(out)) + [mask])
        env.close()
        traces.append(trace)
    jtrace, ttrace = traces
    assert len(ttrace) == len(jtrace)
    for i, (t, j) in enumerate(zip(ttrace, jtrace)):
        if isinstance(j, tuple):
            assert isinstance(t, tuple), i
            t, j = t[1], j[1]
        _equal(t, j, f'step {i}')
    return ttrace


def _install(name, fake_module, monkeypatch):
    """Install `name`'s fake backend (or nothing, for a real one) for
    both packages' make."""
    if name == 'butterfly':
        # pettingzoo 1.26 keeps cooperative_pong_v5's name only to raise
        # DeprecatedEnv: both packages get the real v6 env under it
        from pettingzoo.butterfly import (
            cooperative_pong_v6, knights_archers_zombies_v10)
        fake_module('pettingzoo.butterfly',
            cooperative_pong_v5=cooperative_pong_v6,
            knights_archers_zombies_v10=knights_archers_zombies_v10)
    elif name == 'bsuite':
        fake_module('bsuite', load_from_id=lambda n: fakes2.FakeDMEnv())
        fake_module('bsuite.utils')
        fake_module('bsuite.utils.gym_wrapper',
            GymFromDMEnv=fakes2.FakeGymFromDMEnv)
    elif name == 'crafter':
        fake_module('crafter', Env=fakes2.FakeCrafter)
    elif name == 'dm_lab':
        fake_module('deepmind_lab',
            Lab=lambda n, obs, config=None: fakes3.FakeLab())
    elif name == 'griddly':
        fake_module('griddly')
        monkeypatch.setattr(gymnasium, 'make', lambda n, **kw: FakeGriddly())
    elif name == 'links_awaken':
        fake_module('links_awaken', LinksAwakenV1=FakeLinks)
    elif name == 'magent':
        fake_module('magent2')
        fake_module('magent2.environments', battle_v4=types.SimpleNamespace(
            parallel_env=lambda render_mode=None:
                fakes3.FakeSMACParallel()))
    elif name == 'microrts':
        envs = types.SimpleNamespace(
            GlobalAgentCombinedRewardEnv=fakes3.FakeMicroRTSEnv)
        fake_module('gym_microrts', envs=envs)
        fake_module('gym_microrts.envs',
            GlobalAgentCombinedRewardEnv=fakes3.FakeMicroRTSEnv)
    elif name == 'minerl':
        fake_module('minerl')
        fake_module('gym', make=lambda n, **kw: FakeMineRL(),
            spaces=gymnasium.spaces)
    elif name == 'minigrid':
        fake_module('minigrid')
        fake_module('minigrid.wrappers',
            ImgObsWrapper=fakes1.FakeImgObsWrapper)
        monkeypatch.setattr(gymnasium, 'make',
            lambda n, **kw: FakeGridEnv())
    elif name == 'nocturne':
        fake_module('nocturne')
        fake_module('nocturne.envs')
        fake_module('nocturne.envs.base_env',
            BaseEnv=fakes3.FakeNocturneBase)
    elif name == 'open_spiel':
        spiel_fakes._install_spiel(fake_module)
    elif name == 'slimevolley':
        fake_module('slimevolleygym')
        fake_module('gym', make=lambda n, **kw: fakes2.FakeSlimeVolley(),
            spaces=gymnasium.spaces)
    elif name == 'smac':
        fake_module('smac')
        fake_module('smac.env')
        fake_module('smac.env.pettingzoo',
            StarCraft2PZEnv=types.SimpleNamespace(
                parallel_env=lambda: fakes3.FakeSMACParallel()))
    elif name == 'stable_retro':
        fake_module('retro', make=lambda n, **kw: FakeRetro())
    elif name == 'vizdoom':
        fake_module('vizdoom')
        fake_module('vizdoom.gymnasium_wrapper')
        monkeypatch.setattr(gymnasium, 'make', lambda n, **kw: FakeDoom())


# (make kwargs, steps) of each binding; classic_control, dm_control and
# butterfly on their real backends
CASES = {
    'bsuite': ({'name': 'bandit/0'}, 8),
    'butterfly': ({'name': 'cooperative_pong_v5'}, 6),
    'classic_control': ({'name': 'cartpole'}, 40),
    'crafter': ({}, 4),
    'dm_control': ({'name': 'walker-walk'}, 8),
    'dm_lab': ({}, 8),
    'griddly': ({}, 8),
    'links_awaken': ({}, 8),
    'magent': ({'name': 'battle_v4'}, 4),
    'microrts': ({}, 6),
    'minerl': ({}, 8),
    'minigrid': ({}, 16),
    'nocturne': ({}, 6),
    'open_spiel': ({}, 12),
    'slimevolley': ({}, 6),
    'smac': ({}, 6),
    'stable_retro': ({}, 8),
    'vizdoom': ({}, 8),
}


@pytest.mark.parametrize('name', BINDINGS)
def test_binding_matches_jax(name, fake_module, monkeypatch):
    _install(name, fake_module, monkeypatch)
    jmod, tmod = _modules(name)
    kwargs, steps = CASES[name]
    _run_both(functools.partial(jmod.make, **kwargs),
        functools.partial(tmod.make, **kwargs), steps)


def test_butterfly_default_steps_on_the_installed_pettingzoo():
    """The port's butterfly.make() with its default name on the installed
    pettingzoo, which keeps cooperative_pong_v5 only to raise
    DeprecatedEnv: the port builds cooperative_pong_v6 in its place
    (ROADMAP fault 11, repaired on the port's side only), and the env
    resets and steps through an episode end. The JAX binding still raises
    (the divergence is kept); its v6 env under v5's name is held equal to
    the port's step by step above."""
    pytest.importorskip('pettingzoo.butterfly')
    jmod, tmod = _modules('butterfly')
    with pytest.raises(ImportError, match='deprecated'):
        jmod.make()
    env = tmod.make()
    obs, _ = env.reset(seed=3)
    shape = env.single_observation_space.shape
    assert sorted(obs) == sorted(env.agents) and env.num_agents == 2
    assert all(o.shape == shape for o in obs.values())
    rng = np.random.RandomState(3)
    steps, ended = 0, False
    while not ended and steps < 2000:
        obs, rewards, terminals, truncations, _ = env.step({a: rng.randint(
            0, env.single_action_space.n) for a in obs})
        assert all(o.shape == shape for o in obs.values())
        assert np.isfinite(list(rewards.values())).all()
        ended = any(terminals.values()) or any(truncations.values())
        steps += 1
    assert steps > 1 and ended
    env.close()


def test_open_spiel_multiplayer_matches_jax(fake_module):
    spiel_fakes._install_spiel(fake_module)
    jmod, tmod = _modules('open_spiel')
    trace = _run_both(functools.partial(jmod.make, multiplayer=True),
        functools.partial(tmod.make, multiplayer=True), 6)
    # only the player to move has a legal move; a zero-sum end
    obs = trace[0][0]
    assert obs[0].any() and trace[4][2] == {0: True, 1: True}


def test_open_spiel_adapters_match_jax(fake_module):
    """The adapters alone: bot pool, side draws, terminal win infos and
    the multiplayer masks, step by step."""
    spiel_fakes._install_spiel(fake_module)
    from pufferlib_tpu.environments.open_spiel import adapters as jadapters
    from pufferlib_tpu_torch.environments.open_spiel import adapters
    for cls, single, kwargs, act in (
            ('OpenSpielSingleAgentEnv', True, dict(min_simulations=10,
                max_simulations=12), lambda t: t % 2),
            ('OpenSpielPettingZooEnv', False, {},
                lambda t: {0: t % 2, 1: 0})):
        envs = [getattr(m, cls)('connect_four', **kwargs)
            for m in (jadapters, adapters)]
        jspace, tspace = (env.observation_space if single
            else env.observation_space(0) for env in envs)
        _spaces_equal(spaces.from_gymnasium(tspace),
            spaces.from_gymnasium(jspace))
        traces = []
        for env in envs:
            trace = [_snapshot(env.reset(seed=3))]
            for t in range(12):
                over = env.state.is_terminal() if single else not env.agents
                trace.append(_snapshot(env.reset()) if over
                    else _snapshot(list(env.step(act(t)))))
            traces.append(trace)
        _equal(traces[1], traces[0], cls)


BACKENDS = {
    'bsuite': 'bsuite', 'butterfly': 'pettingzoo.butterfly',
    'classic_control': 'gymnasium', 'crafter': 'crafter',
    'dm_control': 'dm_control', 'dm_lab': 'deepmind_lab',
    'griddly': 'griddly', 'links_awaken': 'links_awaken',
    'magent': 'magent2', 'microrts': 'gym_microrts', 'minerl': 'minerl',
    'minigrid': 'minigrid', 'nocturne': 'nocturne', 'open_spiel': 'pyspiel',
    'slimevolley': 'slimevolleygym', 'smac': 'smac',
    'stable_retro': 'retro', 'vizdoom': 'vizdoom',
}


@pytest.mark.parametrize('name', BINDINGS)
def test_missing_backend_raises_the_jax_error(name, monkeypatch):
    """Without its backend (None in sys.modules: the import fails) each
    make raises the JAX binding's ImportError, message and all."""
    jmod, tmod = _modules(name)
    monkeypatch.setitem(sys.modules, BACKENDS[name], None)
    errors = []
    for module in (jmod, tmod):
        with pytest.raises(ImportError) as e:
            module.env_creator()()
        errors.append(str(e.value))
    assert errors[1] == errors[0]


def test_bsuite_episode_budget_matches_jax(fake_module):
    """BSuiteStopper raises the package's EpisodeLimitExceeded on the
    reset past bsuite_num_episodes, through make too."""
    from pufferlib_tpu.exceptions import (
        EpisodeLimitExceeded as JaxEpisodeLimitExceeded)
    from pufferlib_tpu_torch.exceptions import EpisodeLimitExceeded

    class Limited(fakes2.FakeGymFromDMEnv):
        bsuite_num_episodes = 2

    fake_module('bsuite', load_from_id=lambda n: fakes2.FakeDMEnv())
    fake_module('bsuite.utils')
    fake_module('bsuite.utils.gym_wrapper', GymFromDMEnv=Limited)
    jmod, tmod = _modules('bsuite')
    assert issubclass(EpisodeLimitExceeded, RuntimeError)
    assert str(EpisodeLimitExceeded()) == str(JaxEpisodeLimitExceeded())
    for module, error in ((jmod, JaxEpisodeLimitExceeded),
            (tmod, EpisodeLimitExceeded)):
        stopper = module.BSuiteStopper(Limited(None))
        stopper.reset()
        stopper.reset()
        with pytest.raises(error, match='exactly 2 episodes'):
            stopper.reset()
        env = module.make()
        env.reset(seed=0)
        for _ in range(3):
            env.step(np.array([0]))
        env.reset()
        for _ in range(3):
            env.step(np.array([0]))
        with pytest.raises(error, match='exactly 2 episodes'):
            env.reset()


def test_nocturne_truncates_scenarios_like_jax(fake_module):
    captured = []

    class CapturingBase(fakes3.FakeNocturneBase):
        def __init__(self, config=None):
            super().__init__(config)
            captured.append(self)

    fake_module('nocturne')
    fake_module('nocturne.envs')
    fake_module('nocturne.envs.base_env', BaseEnv=CapturingBase)
    jmod, tmod = _modules('nocturne')
    jmod.make()
    tmod.make()
    assert [c.files for c in captured] == [['a.json'], ['a.json']]
    assert [c.config for c in captured] == [{}, {}]


def test_dm_control_names_parse_like_jax():
    from dm_control import suite
    jmod, tmod = _modules('dm_control')
    for name in ('walker-walk', 'walker_walk', 'ball_in_cup-catch',
            'ball_in_cup_catch', 'cartpole-swingup_sparse'):
        assert tmod._parse_name(name, suite) == jmod._parse_name(name, suite)
    for module in (jmod, tmod):
        with pytest.raises(ValueError, match='cannot parse'):
            module._parse_name('no_such_domain-run', suite)


def test_microrts_refuses_an_unknown_env_like_jax(fake_module, monkeypatch):
    _install('microrts', fake_module, monkeypatch)
    for module in _modules('microrts'):
        with pytest.raises(ValueError, match='Unknown microrts'):
            module.make('NoSuchEnv')


def test_slimevolley_actions_reach_the_env(fake_module):
    """The MultiBinary action arrives as the same vector through both."""
    received = []
    for module in _modules('slimevolley'):
        raw = fakes2.FakeSlimeVolley()
        fake_module('slimevolleygym')
        fake_module('gym', make=lambda n, **kw: raw, spaces=gymnasium.spaces)
        env = module.make()
        env.reset(seed=0)
        env.step(np.array([1, 0, 1]))
        received.append(np.ravel(raw.received[-1]))
    np.testing.assert_array_equal(received[1], received[0])
    np.testing.assert_array_equal(received[1], [1, 0, 1])


def test_links_awaken_policy_matches_jax():
    """links_awaken.Policy (channels-last Convolutional over the
    binding's 72 x 80 x 3 frames) against the JAX module, weights carried
    by convert.convolutional_layers."""
    from pufferlib_tpu import spaces as jspaces
    jmod, tmod = _modules('links_awaken')
    shape = (72, 80, 3)
    frames = np.random.RandomState(0).randint(0, 256, (4,) + shape).astype(
        np.uint8)
    jpol = jmod.Policy(obs_shape=shape, action_space=jspaces.Discrete(8),
        hidden_size=64)
    params = jax.tree.map(np.asarray, jpol.init(jax.random.PRNGKey(0),
        jnp.asarray(frames)))
    tpol = tmod.Policy(shape, spaces.Discrete(8), hidden_size=64)
    assert tpol.channels_last and tpol.fc.in_features == 64 * 5 * 6
    tpol.load_state_dict(layers_state_dict(params, convolutional_layers(
        [8])))
    want_logits, want_value = jpol.apply(params, jnp.asarray(frames))
    with torch.no_grad():
        logits, value = tpol(torch.as_tensor(frames))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(value.numpy(), np.asarray(want_value),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('name', BINDINGS)
def test_resolve_env_module_finds_the_binding(name):
    module = cli.resolve_env_module(name)
    assert module.__name__ == f'pufferlib_tpu_torch.environments.{name}'
    assert callable(module.env_creator) and callable(module.wrap)


# --------------------------------------------------------------------------
# minigrid's host trainer against the JAX one

MINIGRID = dict(env='minigrid', batch_size=256, minibatch_size=64,
    bptt_horizon=4, total_timesteps=2048, verbose=False,
    checkpoint_interval=10 ** 6)
HIDDEN = 32


def _minigrid_vec(package_vector_host, module):
    return package_vector_host.make(module.env_creator(),
        backend=package_vector_host.HostSerial, num_envs=8)


def _jax_uniforms(key, calls, rows):
    """The JAX host trainer's sampler draws (tests/test_torch_ppo_host.py):
    key, sub = split(key); uniform(split(sub, 1)[0], (rows,))."""
    out = []
    for _ in range(calls):
        key, sub = jax.random.split(key)
        out.append(torch.from_numpy(np.array(jax.random.uniform(
            jax.random.split(sub, 1)[0], (rows,), dtype=jnp.float32))))
    return out


def _jax_permutations(key, config, S):
    """The segment permutations the JAX trainer's epoch runner draws in
    the next train(): update_key = split(key)[1], one permutation of S
    segments from each of split(update_key, update_epochs)."""
    _, update_key = jax.random.split(key)
    return torch.stack([torch.from_numpy(np.array(jax.random.permutation(k,
        S))) for k in jax.random.split(update_key, config.update_epochs)])


@pytest.mark.parametrize('shuffle', [False, True])
def test_minigrid_ppo_host_matches_jax(tmp_path, fake_module, monkeypatch,
        shuffle):
    _install('minigrid', fake_module, monkeypatch)
    jmod, tmod = _modules('minigrid')
    jvec = _minigrid_vec(jvector_host, jmod)
    vec = _minigrid_vec(vector_host, tmod)
    shape = vec.single_observation_space.shape
    assert shape == (7, 7, 3) and vec.single_observation_space.dtype == \
        np.uint8
    jpolicy = JaxRecurrentPolicy(JaxLSTMWrapper(policy=JaxDefault(
        obs_shape=shape, action_space=jvec.single_action_space,
        hidden_size=HIDDEN), obs_shape=shape, input_size=HIDDEN,
        hidden_size=HIDDEN))
    policy = RecurrentPolicy(LSTMWrapper(Default(obs_shape=shape,
        action_space=vec.single_action_space, hidden_size=HIDDEN),
        obs_shape=shape, input_size=HIDDEN, hidden_size=HIDDEN,
        kernel='off'))
    jconfig = jax_ppo.default_config(**MINIGRID,
        shuffle_minibatches=shuffle, data_dir=str(tmp_path / 'jax'))
    config = ppo_host.default_config(**MINIGRID, shuffle_minibatches=shuffle,
        device='cpu', data_dir=str(tmp_path / 'port'))
    jdata = jax_ppo_host.create(jconfig, jvec, jpolicy)
    data = ppo_host.create(config, vec, policy)
    data.policy.module.load_state_dict(lstm_state_dict(jax.tree.map(
        np.asarray, jdata.params)))
    draws = iter(_jax_uniforms(jdata.key, 32, 8))

    jax_ppo_host.evaluate(jdata)
    ppo_host.evaluate(data, draws)
    jexp, exp = jdata.experience, data.experience
    for name in ('actions', 'obs', 'rewards', 'dones', 'key_agent',
            'key_step'):
        np.testing.assert_array_equal(getattr(exp, name),
            getattr(jexp, name), err_msg=name)
    assert exp.rewards.any() and exp.dones.any()
    for name in ('logprobs', 'values'):
        np.testing.assert_allclose(getattr(exp, name), getattr(jexp, name),
            rtol=0, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(exp.lstm_h.numpy(), np.asarray(jexp.lstm_h),
        rtol=0, atol=1e-5)

    S = 256 // 4
    perms = _jax_permutations(jdata.key, jconfig, S) if shuffle else None
    jax_ppo_host.train(jdata)
    ppo_host.train(data, perms)
    want = lstm_state_dict(jax.tree.map(np.asarray, jdata.params))
    for k, v in data.policy.module.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
            atol=1e-4, err_msg=k)
    for k in ('policy_loss', 'value_loss', 'entropy', 'approx_kl',
            'explained_variance', 'adv_var'):
        w = float(jdata.losses[k])
        assert abs(float(data.losses[k]) - w) <= 1e-4 * max(1.0, abs(w)), k
    ppo_host.close(data)
    jax_ppo_host.close(jdata)


def test_minigrid_section_builds_the_card_policy():
    """config.cli on config.yaml's minigrid section over the card's fake:
    Default over 147 uint8 features inside LSTMWrapper(128, 128), the
    enc5 route (whose streamed design the card runs at F 147)."""
    args, module, _ = cli.load_config(argv=['--env', 'minigrid',
        '--train.device', 'cpu'])
    assert (args.use_rnn, args.train.num_envs, args.train.batch_size,
        args.train.minibatch_size, args.train.bptt_horizon) == (
        True, 128, 16384, 4096, 16)
    vec = vector_host.make(host_fixtures.make_fake_minigrid,
        backend=vector_host.HostSerial, num_envs=2)
    policy = cli.make_policy(vec, module, args)
    vec.close()
    lstm = policy.module
    assert isinstance(lstm.policy, Default)
    assert lstm.policy.encoder.in_features == 147
    assert (lstm.input_size, lstm.hidden_size) == (128, 128)
    assert lstm.route(16, 'cpu') == 'off'
    lstm.use_kernel = True
    assert lstm.route(16, 'cpu') == 'enc5'


@pytest.mark.parametrize('name', sorted(host_fixtures.ZOO2_FAKES))
def test_card_fake_trains_one_epoch(name, tmp_path):
    """The fake the card runs through its binding's wrap: one HostSerial
    ppo_host epoch of config.cli's policy for the section (Default, an
    LSTM for minigrid) at a small batch, finite losses."""
    args, module, _ = cli.load_config(argv=['--env', name,
        '--train.device', 'cpu'])
    vec = vector_host.make(host_fixtures.ZOO2_FAKES[name],
        backend=vector_host.HostSerial, num_envs=2)
    args.policy['hidden_size'] = 16
    args.rnn['hidden_size'] = 16
    args.rnn['input_size'] = 16
    policy = cli.make_policy(vec, module, args)
    rows = 2 * vec.num_agents if hasattr(vec, 'num_agents') else 2
    batch = max(64, rows * 8)
    config = ppo_host.default_config(env=name, batch_size=batch,
        minibatch_size=batch // 2, bptt_horizon=4, total_timesteps=10 ** 6,
        verbose=False, device='cpu', data_dir=str(tmp_path),
        checkpoint_interval=10 ** 6)
    data = ppo_host.create(config, vec, policy)
    ppo_host.evaluate(data)
    ppo_host.train(data)
    ppo_host.close(data)
    for loss in ('policy_loss', 'value_loss', 'entropy'):
        assert np.isfinite(getattr(data.losses, loss)), loss


# --------------------------------------------------------------------------
# The examples


def _python(code, timeout=300):
    return subprocess.run([sys.executable, '-c', code], cwd=REPO,
        capture_output=True, text=True, timeout=timeout)


def test_wrap_one_env_example_prints_what_jax_prints():
    port = _python("import runpy; runpy.run_path("
        "'examples/wrap_one_env_torch.py', run_name='__main__')")
    assert port.returncode == 0, port.stdout + port.stderr
    jax_run = _python("import jax; jax.config.update('jax_platforms', "
        "'cpu'); import runpy; runpy.run_path('examples/wrap_one_env.py', "
        "run_name='__main__')")
    assert jax_run.returncode == 0, jax_run.stdout + jax_run.stderr
    assert 'flat observation space' in port.stdout
    assert port.stdout == jax_run.stdout


def test_cleanrl_example_learns_on_the_cpu():
    code = ("import runpy, sys; sys.argv = ['x', '--device', 'cpu']; "
        "runpy.run_path('examples/cleanrl_style_ppo_torch.py', "
        "run_name='__main__'); print(sorted(m for m in sys.modules if m "
        "in ('jax', 'pufferlib_tpu') or m.startswith(('jax.', "
        "'pufferlib_tpu.'))))")
    out = _python(code)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == '[]'
    scores = [float(line.split()[3]) for line in lines[:-1]]
    assert len(scores) == 30 and all(np.isfinite(scores))
    assert scores[-1] > 0.4, scores
    assert scores[0] < 0.05, scores
