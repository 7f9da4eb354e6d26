"""Host env fixtures (counterpart of
pufferlib_tpu/environments/test/host_fixtures.py; reference
test/environment.py:252-360): the synthetic-delay envs and the seeded
gymnasium / pettingzoo mock envs (gymnasium imported inside them), and,
written on the port's own spaces so that they need no gymnasium, the fake
ALE of tools/rehearse_atari.py behind the port's Atari wrapper stack and
a fake procgen env. Kept torch-free: envpool workers unpickle these
creators in spawned processes.
"""
import numpy as np

from pufferlib_tpu_torch import spaces


def _do_work(delay_mean, delay_std):
    import time as _time
    start = _time.process_time()
    target = delay_mean + delay_std * np.random.randn()
    while _time.process_time() - start < target:
        pass


class GymnasiumPerformanceEnv:
    """Busy-spins `delay_mean +- delay_std` seconds of CPU per step."""

    def __init__(self, delay_mean=0, delay_std=0, obs_size=1):
        import gymnasium
        self.observation_space = gymnasium.spaces.Box(
            low=-1, high=1, shape=(obs_size,), dtype=np.float32)
        self.action_space = gymnasium.spaces.Discrete(2)
        self.observation = np.zeros(obs_size, np.float32)
        self.delay_mean = delay_mean
        self.delay_std = delay_std
        self.render_mode = None

    def reset(self, seed=None, options=None):
        return self.observation, {}

    def step(self, action):
        _do_work(self.delay_mean, self.delay_std)
        return self.observation, 0.0, False, False, {}

    def close(self):
        pass


class GymnasiumCrashOnceEnv:
    """Kills its PROCESS (os._exit) on the 3rd step unless the sentinel
    file already exists; the crash leaves the sentinel behind, so a
    respawned worker's instance runs normally. Fixture for the host
    envpool's elastic recovery (restart_workers)."""

    def __init__(self, sentinel=None):
        import gymnasium
        self.observation_space = gymnasium.spaces.Box(
            low=0, high=100, shape=(2,), dtype=np.float32)
        self.action_space = gymnasium.spaces.Discrete(2)
        self.sentinel = sentinel
        self.render_mode = None
        self.t = 0

    def reset(self, seed=None, options=None):
        self.t = 0
        return np.zeros(2, np.float32), {}

    def step(self, action):
        import os
        self.t += 1
        if self.t == 3 and self.sentinel \
                and not os.path.exists(self.sentinel):
            open(self.sentinel, 'w').close()
            os._exit(1)
        obs = np.full(2, float(self.t), np.float32)
        return obs, 1.0, self.t >= 5, False, {}

    def close(self):
        pass


class GymnasiumSleepEnv(GymnasiumPerformanceEnv):
    """time.sleep-based delay fixture: models envs whose step latency
    releases the GIL/CPU (IO, subprocess games). Unlike the busy-spin
    variant, an async pool overlaps these even on a single core."""

    def step(self, action):
        import time as _time
        _time.sleep(self.delay_mean)
        return self.observation, 0.0, False, False, {}


class PettingZooPerformanceEnv:
    """Single-agent parallel-API variant of the delay fixture."""

    def __init__(self, delay_mean=0, delay_std=0):
        self.possible_agents = [1]
        self.agents = [1]
        self.delay_mean = delay_mean
        self.delay_std = delay_std
        self.render_mode = None

    def observation_space(self, agent):
        import gymnasium
        return gymnasium.spaces.Box(
            low=-1, high=1, shape=(1,), dtype=np.float32)

    def action_space(self, agent):
        import gymnasium
        return gymnasium.spaces.Discrete(2)

    def reset(self, seed=None):
        return {1: np.zeros(1, np.float32)}, {1: {}}

    def step(self, actions):
        _do_work(self.delay_mean, self.delay_std)
        return ({1: np.zeros(1, np.float32)}, {1: 1.0}, {1: False},
            {1: False}, {1: {}})

    def close(self):
        pass


# --------------------------------------------------------------------------
# Deterministic host-side mock envs (reference test/environment.py:312-360:
# GymnasiumTestEnv / PettingZooTestEnv with seeded episodes) — the fixture
# for the vectorization-vs-manual-loop byte-exactness contract.

def host_mock_spaces():
    """Gymnasium obs/action space registry for host mock envs (jax-free
    sibling of the device MOCK_* suite)."""
    import gymnasium
    obs = {
        'box': gymnasium.spaces.Box(-1, 1, (6,), np.float32),
        'image': gymnasium.spaces.Box(0, 255, (3, 4, 4), np.uint8),
        'dict_mixed': gymnasium.spaces.Dict({
            'a': gymnasium.spaces.Box(0, 255, (3, 3), np.uint8),
            'b': gymnasium.spaces.Box(-128, 127, (4,), np.int8),
        }),
        'tuple_nested': gymnasium.spaces.Tuple([
            gymnasium.spaces.Box(0, 1, (2,), np.float32),
            gymnasium.spaces.Box(0, 255, (3,), np.uint8),
        ]),
    }
    atn = {
        'discrete': gymnasium.spaces.Discrete(4),
        'multidiscrete': gymnasium.spaces.MultiDiscrete([2, 3]),
        'dict_discrete': gymnasium.spaces.Dict({
            'x': gymnasium.spaces.Discrete(2),
            'y': gymnasium.spaces.Discrete(3),
        }),
    }
    return obs, atn


def _action_leaf_sum(action):
    if isinstance(action, dict):
        return sum(_action_leaf_sum(v) for v in action.values())
    if isinstance(action, (tuple, list)):
        return sum(_action_leaf_sum(v) for v in action)
    return int(np.sum(np.asarray(action)))


class GymnasiumTestEnv:
    """Deterministic seeded episodes: obs are a pure function of
    (seed, tick); reward = tick; episodes last episode_length steps."""

    def __init__(self, obs_name='box', atn_name='discrete',
            episode_length=5):
        obs_spaces, atn_spaces = host_mock_spaces()
        self.observation_space = obs_spaces[obs_name]
        self.action_space = atn_spaces[atn_name]
        self.episode_length = episode_length
        self.render_mode = None
        self._seed = 0
        self._episode = 0

    def _obs(self, t):
        # fold the action history in so byte-exactness catches action
        # mis-routing, not just obs plumbing
        self.observation_space.seed(
            int(self._seed * 10007 + self._episode * 101 + t
                + self._action_sum * 13))
        return self.observation_space.sample()

    def reset(self, seed=None, options=None):
        if seed is not None:
            self._seed = seed
            self._episode = 0
        else:
            self._episode += 1
        self.t = 0
        self._action_sum = 0
        return self._obs(0), {}

    def step(self, action):
        self.t += 1
        self._action_sum += _action_leaf_sum(action)
        done = self.t >= self.episode_length
        info = {'score': float(self.t)} if done else {}
        # reward depends on the received action (0.125 multiples are
        # exact in float32)
        reward = float(self.t) + (self._action_sum % 7) * 0.125
        return self._obs(self.t), reward, done, False, info

    def close(self):
        pass


class PettingZooTestEnv:
    """Deterministic 2-agent parallel mock with seeded episodes."""

    def __init__(self, obs_name='box', atn_name='discrete',
            episode_length=5):
        obs_spaces, atn_spaces = host_mock_spaces()
        self._obs_space = obs_spaces[obs_name]
        self._atn_space = atn_spaces[atn_name]
        self.episode_length = episode_length
        self.possible_agents = [1, 2]
        self.agents = []
        self.render_mode = None
        self._seed = 0
        self._episode = 0

    def observation_space(self, agent):
        return self._obs_space

    def action_space(self, agent):
        return self._atn_space

    def _obs(self, agent, t):
        self._obs_space.seed(int(self._seed * 10007
            + self._episode * 101 + agent * 31 + t
            + self._action_sum * 13))
        return self._obs_space.sample()

    def reset(self, seed=None):
        if seed is not None:
            self._seed = seed
            self._episode = 0
        else:
            self._episode += 1
        self.t = 0
        self._action_sum = 0
        self.agents = list(self.possible_agents)
        return {a: self._obs(a, 0) for a in self.agents}, \
            {a: {} for a in self.agents}

    def step(self, actions):
        self.t += 1
        self._action_sum += _action_leaf_sum(actions)
        done = self.t >= self.episode_length
        obs = {a: self._obs(a, self.t) for a in self.agents}
        rewards = {a: float(self.t * a)
            + (self._action_sum % 5) * 0.125 for a in self.agents}
        dones = {a: done for a in self.agents}
        truncs = {a: False for a in self.agents}
        infos = {a: {} for a in self.agents}
        if done:
            self.agents = []
        return obs, rewards, dones, truncs, infos

    def close(self):
        pass


# --------------------------------------------------------------------------
# Pixel envs at production shapes on the port's spaces (no gymnasium):
# the host trainer's Atari and procgen rehearsals

class FakeALE:
    """84x84 grayscale frames (4 stacked), 4 lives, FIRE at action 1: the
    fake backend of tools/rehearse_atari.py. A cheap deterministic frame
    (a full random fill would dominate the step cost): every pixel
    (7 t) % 256, the top-left 8x8 of each frame random from the seed."""

    def __init__(self, life_every=97, frame_shape=(4, 84, 84)):
        self.observation_space = spaces.Box(0, 255, frame_shape, np.uint8)
        self.action_space = spaces.Discrete(4)
        self.render_mode = None
        self.life_every = life_every
        self.t = 0
        self.lives = 0
        self.unwrapped = self
        self._rng = np.random.RandomState(0)

    def get_action_meanings(self):
        return ['NOOP', 'FIRE', 'RIGHT', 'LEFT']

    def _obs(self):
        shape = self.observation_space.shape
        frame = np.full(shape, (self.t * 7) % 256, np.uint8)
        frame[:, :8, :8] = self._rng.randint(0, 255, (shape[0], 8, 8))
        return frame

    def reset(self, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.RandomState(seed)
        self.t = 0
        self.lives = 4
        return self._obs(), {'lives': self.lives}

    def step(self, action):
        self.t += 1
        if self.t % self.life_every == 0:
            self.lives -= 1
        reward = 0.5 if self.t % 31 == 0 else 0.0
        return (self._obs(), reward, self.lives == 0, False,
            {'lives': self.lives})

    def close(self):
        pass


def make_fake_atari(life_every=97, frame_shape=(4, 84, 84)):
    """tools/rehearse_atari.py's make_env on the port: FakeALE behind
    EpisodicLife, FireReset, sign-clip, EpisodeStats and
    GymnasiumPufferEnv."""
    from pufferlib_tpu_torch.environments.atari.wrappers import (
        ClipRewardEnv, EpisodicLifeEnv, FireResetEnv)
    from pufferlib_tpu_torch.host_env import GymnasiumPufferEnv
    from pufferlib_tpu_torch.postprocess import EpisodeStats
    env = FakeALE(life_every, frame_shape)
    env = EpisodicLifeEnv(env)
    env = FireResetEnv(env)
    env = ClipRewardEnv(env)
    env = EpisodeStats(env)
    return GymnasiumPufferEnv(env=env)


class FakeProcgen:
    """64x64x3 uint8 frames (NHWC) and 15 actions, as procgen's: a
    random 8x8 patch at a place that moves with the tick on a frame of
    the tick's colour, reward 1 every 50 steps, episodes of 200 steps."""

    def __init__(self, frame_shape=(64, 64, 3), episode_length=200):
        self.observation_space = spaces.Box(0, 255, frame_shape, np.uint8)
        self.action_space = spaces.Discrete(15)
        self.render_mode = None
        self.episode_length = episode_length
        self.t = 0
        self._rng = np.random.RandomState(0)

    def _obs(self):
        shape = self.observation_space.shape
        frame = np.full(shape, (self.t * 5) % 256, np.uint8)
        at = (self.t * 3) % (shape[0] - 8)
        frame[at:at + 8, at:at + 8] = self._rng.randint(0, 255, (8, 8,
            shape[2]))
        return frame

    def reset(self, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.RandomState(seed)
        self.t = 0
        return self._obs(), {}

    def step(self, action):
        self.t += 1
        reward = 1.0 if self.t % 50 == 0 else 0.0
        return (self._obs(), reward, self.t >= self.episode_length, False,
            {})

    def close(self):
        pass


def make_fake_procgen():
    """FakeProcgen behind EpisodeStats and GymnasiumPufferEnv, as
    environments.procgen.make wraps the real one."""
    from pufferlib_tpu_torch.host_env import GymnasiumPufferEnv
    from pufferlib_tpu_torch.postprocess import EpisodeStats
    return GymnasiumPufferEnv(env=EpisodeStats(FakeProcgen()))


# --------------------------------------------------------------------------
# The zoo's backends at their observation layouts, on the port's spaces
# (no gymnasium): nle, nmmo, nmmo3 and pokegym are not installed here or on
# the card. Each draws a bank of observations from its seed once and
# cycles through it, so that a step costs little beside the wrappers.

class FakeNLE:
    """NetHack's Dict observation (blstats int32 (27,), chars, colors
    uint8 (21, 79), glyphs int16 (21, 79), the space of
    tests/test_zoo_fake_backends.py), 23 actions, reward 1 a step,
    episodes of `episode_length` steps."""

    def __init__(self, episode_length=64, seed=0, bank=16):
        self.observation_space = spaces.Dict({
            'blstats': spaces.Box(-2**15, 2**15 - 1, (27,), np.int32),
            'chars': spaces.Box(0, 255, (21, 79), np.uint8),
            'colors': spaces.Box(0, 15, (21, 79), np.uint8),
            'glyphs': spaces.Box(0, 5976, (21, 79), np.int16),
        })
        self.action_space = spaces.Discrete(23)
        self.render_mode = None
        self.episode_length = episode_length
        rng = np.random.RandomState(seed)
        self._bank = [{k: rng.randint(0, 100, s.shape).astype(s.dtype)
            for k, s in self.observation_space.items()} for _ in range(bank)]
        self.t = 0

    def _obs(self):
        return self._bank[self.t % len(self._bank)]

    def reset(self, seed=None, options=None):
        self.t = 0
        return self._obs(), {}

    def step(self, action):
        self.t += 1
        return self._obs(), 1.0, self.t >= self.episode_length, False, {}

    def close(self):
        pass


def make_fake_nethack(episode_length=64):
    """FakeNLE behind environments.nethack's own wrapper stack
    (EpisodeStats, GymnasiumPufferEnv)."""
    from pufferlib_tpu_torch.environments.nethack import wrap
    return wrap(FakeNLE(episode_length))


class FakeNMMO:
    """A Neural MMO parallel env (old pettingzoo: reset gives obs, step a
    4-tuple) of `num_agents` agents with nmmo's observation layout:
    AgentId int16 (1,), Entity int16 (rows, 31) whose column 0 is the id
    (the agent's own row among them, but for agent 1, which has none),
    Tile int16 (225, 3). 5 x 4 x 3 multi-discrete actions; reward 0.1 a
    step; episodes of `episode_length` steps."""

    def __init__(self, num_agents=128, rows=100, episode_length=64,
            seed=0, bank=8):
        self.possible_agents = list(range(1, num_agents + 1))
        self.agents = []
        self.render_mode = None
        self.rows = rows
        self.episode_length = episode_length
        self._space = spaces.Dict({
            'AgentId': spaces.Box(0, 2**15 - 1, (1,), np.int16),
            'Entity': spaces.Box(-2**15, 2**15 - 1, (rows, 31), np.int16),
            'Tile': spaces.Box(0, 255, (225, 3), np.int16),
        })
        self._atn = spaces.MultiDiscrete([5, 4, 3])
        rng = np.random.RandomState(seed)
        self._bank = []
        for _ in range(bank):
            entity = rng.randint(-8, 300, (rows, 31)).astype(np.int16)
            entity[:, 0] = rng.randint(0, num_agents + 1, rows)
            tile = rng.randint(0, 200, (225, 3)).astype(np.int16)
            self._bank.append((entity, tile))
        self.t = 0

    def observation_space(self, agent):
        return self._space

    def action_space(self, agent):
        return self._atn

    def _obs(self, agent):
        entity, tile = self._bank[(self.t + agent) % len(self._bank)]
        entity = entity.copy()
        if agent != 1:
            entity[agent % self.rows, 0] = agent
        else:
            entity[entity[:, 0] == 1, 0] = 0
        return {'AgentId': np.array([agent], np.int16), 'Entity': entity,
            'Tile': tile}

    def reset(self, seed=None):
        self.t = 0
        self.agents = list(self.possible_agents)
        return {a: self._obs(a) for a in self.agents}

    def step(self, actions):
        self.t += 1
        done = self.t >= self.episode_length
        obs = {a: self._obs(a) for a in self.agents}
        rewards = {a: 0.1 for a in self.agents}
        dones = {a: done for a in self.agents}
        infos = {a: {} for a in self.agents}
        if done:
            self.agents = []
        return obs, rewards, dones, infos

    def close(self):
        pass


def make_fake_nmmo(num_agents=128, episode_length=64):
    """FakeNMMO behind environments.nmmo's own wrapper stack."""
    from pufferlib_tpu_torch.environments.nmmo import wrap
    return wrap(FakeNMMO(num_agents, episode_length=episode_length))


class FakePuffEnv:
    """An nmmo3 native PufferEnv: `num_agents` agents, each a flat uint8
    observation of 11 * 15 map codes then 44 player features, 26
    actions, reward 0.1 a step; every agent done after
    `episode_length` steps."""

    def __init__(self, width=1024, height=1024, num_envs=1, num_agents=64,
            episode_length=64, seed=0, bank=8):
        self.num_agents = num_agents
        self.single_observation_space = spaces.Box(0, 255, (11 * 15 + 44,),
            np.uint8)
        self.single_action_space = spaces.Discrete(26)
        self.observation_space = self.single_observation_space
        self.action_space = self.single_action_space
        self.render_mode = None
        self.episode_length = episode_length
        rng = np.random.RandomState(seed)
        self._bank = rng.randint(0, 256, (bank, num_agents, 209)).astype(
            np.uint8)
        self.t = 0

    def reset(self, seed=None):
        self.t = 0
        return self._bank[0], {}

    def step(self, actions):
        self.t += 1
        n = self.num_agents
        done = np.full(n, self.t >= self.episode_length)
        return (self._bank[self.t % len(self._bank)],
            np.full(n, 0.1, np.float32), done, np.zeros(n, bool), {})

    def close(self):
        pass


def make_fake_nmmo3(num_agents=64, episode_length=64):
    """FakePuffEnv through host_env.NativePufferEnv, as
    environments.nmmo3.make takes the real one."""
    from pufferlib_tpu_torch.host_env import NativePufferEnv
    return NativePufferEnv(env=FakePuffEnv(num_agents=num_agents,
        episode_length=episode_length))


class FakePokegym:
    """pokegym's screen: 72 x 80 x 4 uint8 (channels last), 7 actions,
    reward 0.1 a step, episodes of `episode_length` steps."""

    def __init__(self, headless=True, state_path=None, episode_length=64,
            seed=0, bank=8):
        self.observation_space = spaces.Box(0, 255, (72, 80, 4), np.uint8)
        self.action_space = spaces.Discrete(7)
        self.render_mode = None
        self.episode_length = episode_length
        rng = np.random.RandomState(seed)
        self._bank = rng.randint(0, 256, (bank, 72, 80, 4)).astype(np.uint8)
        self.t = 0

    def reset(self, seed=None, options=None):
        self.t = 0
        return self._bank[0], {}

    def step(self, action):
        self.t += 1
        return (self._bank[self.t % len(self._bank)], 0.1,
            self.t >= self.episode_length, False, {})

    def close(self):
        pass


def make_fake_pokemon_red(episode_length=64):
    """FakePokegym behind environments.pokemon_red's own wrapper stack."""
    from pufferlib_tpu_torch.environments.pokemon_red import wrap
    return wrap(FakePokegym(episode_length=episode_length))


# --------------------------------------------------------------------------
# The backends of the other zoo bindings, on the port's spaces (none of
# them is installed here or on the card). Each fake has its backend's API
# (gymnasium's, old gym's 4-tuple, a pettingzoo parallel env, dm_env,
# deepmind_lab's Lab, nocturne's BaseEnv, a pyspiel game) and goes
# through its binding's own wrap; observations come from a bank drawn
# from the seed once, rewards are constant, episodes end after
# `episode_length` steps. Where the layout follows the real backend's it
# says so; the others are the fake's own.

def _draw(space, rng):
    """A sample of a Box or a Dict of Boxes; float Boxes draw a standard
    normal clipped to their bounds (an unbounded Box's own sample spans
    +-1e6)."""
    if isinstance(space, spaces.Dict):
        return {k: _draw(v, rng) for k, v in space.items()}
    if np.issubdtype(space.dtype, np.floating):
        return np.clip(rng.randn(*space.shape), space.low,
            space.high).astype(space.dtype)
    return space.sample(rng)


class FakeBankEnv:
    """A single-agent env of `observation_space` (a Box or a Dict of
    Boxes) and `action_space`, reward `reward` a step. old_api: reset
    gives the observation alone and step a 4-tuple (old gym)."""

    def __init__(self, observation_space, action_space, episode_length=64,
            reward=0.1, old_api=False, seed=0, bank=8):
        self.observation_space = observation_space
        self.action_space = action_space
        self.render_mode = None
        self.episode_length = episode_length
        self.reward = reward
        self.old_api = old_api
        rng = np.random.RandomState(seed)
        self._bank = [_draw(observation_space, rng) for _ in range(bank)]
        self.t = 0

    def _obs(self):
        return self._bank[self.t % len(self._bank)]

    def reset(self, seed=None, options=None):
        self.t = 0
        return self._obs() if self.old_api else (self._obs(), {})

    def step(self, action):
        self.t += 1
        done = self.t >= self.episode_length
        if self.old_api:
            return self._obs(), self.reward, done, {}
        return self._obs(), self.reward, done, False, {}

    def close(self):
        pass


class FakeParallelEnv:
    """A pettingzoo parallel env of `num_agents` agents named by
    `prefix`, each with `observation_space` and `action_space`, reward
    `reward` a step; agent 0 dies after `episode_length // 2` steps (its
    done row, then padding), the rest after `episode_length`."""

    def __init__(self, num_agents, observation_space, action_space,
            episode_length=64, reward=0.1, prefix='agent_', seed=0, bank=8):
        self.possible_agents = [f'{prefix}{i}' for i in range(num_agents)]
        self.agents = []
        self.render_mode = None
        self._obs_space = observation_space
        self._atn_space = action_space
        self.episode_length = episode_length
        self.reward = reward
        rng = np.random.RandomState(seed)
        self._bank = [_draw(observation_space, rng) for _ in range(bank)]
        self.t = 0

    def observation_space(self, agent):
        return self._obs_space

    def action_space(self, agent):
        return self._atn_space

    def _obs(self, i):
        return self._bank[(self.t + i) % len(self._bank)]

    def reset(self, seed=None):
        self.t = 0
        self.agents = list(self.possible_agents)
        return ({a: self._obs(i) for i, a in enumerate(self.agents)},
            {a: {} for a in self.agents})

    def step(self, actions):
        self.t += 1
        index = {a: i for i, a in enumerate(self.possible_agents)}
        first = self.possible_agents[0]
        dones = {a: self.t >= self.episode_length or (a == first
            and self.t >= self.episode_length // 2) for a in self.agents}
        obs = {a: self._obs(index[a]) for a in self.agents}
        rewards = {a: self.reward for a in self.agents}
        truncs = {a: False for a in self.agents}
        infos = {a: {} for a in self.agents}
        self.agents = [a for a in self.agents if not dones[a]]
        return obs, rewards, dones, truncs, infos

    def close(self):
        pass


def make_fake_bsuite(episode_length=1):
    """bsuite's bandit/0 through GymFromDMEnv: (1, 1) float32
    observations, 11 arms, one-step episodes, bsuite_num_episodes 10000
    (bandit's), behind environments.bsuite.wrap."""
    from pufferlib_tpu_torch.environments.bsuite import wrap
    env = FakeBankEnv(spaces.Box(-np.inf, np.inf, (1, 1), np.float32),
        spaces.Discrete(11), episode_length, reward=1.0, old_api=True)
    env.bsuite_num_episodes = 10000
    return wrap(env)


def make_fake_butterfly(episode_length=64):
    """cooperative_pong_v5: two paddles, 280 x 480 x 3 uint8 frames, 3
    actions, behind environments.butterfly.wrap."""
    from pufferlib_tpu_torch.environments.butterfly import wrap
    return wrap(FakeParallelEnv(2, spaces.Box(0, 255, (280, 480, 3),
        np.uint8), spaces.Discrete(3), episode_length, prefix='paddle_',
        bank=2))


def make_fake_classic_control(episode_length=64):
    """CartPole-v1's spaces (4 float32, 2 actions), reward 1 a step,
    behind environments.classic_control.wrap."""
    from pufferlib_tpu_torch.environments.classic_control import wrap
    high = np.array([4.8, np.inf, 0.418, np.inf], np.float32)
    return wrap(FakeBankEnv(spaces.Box(-high, high, (4,), np.float32),
        spaces.Discrete(2), episode_length, reward=1.0))


def make_fake_crafter(episode_length=64):
    """crafter.Env (old gym's API): 64 x 64 x 3 uint8, 17 actions, behind
    environments.crafter.wrap."""
    from pufferlib_tpu_torch.environments.crafter import wrap
    return wrap(FakeBankEnv(spaces.Box(0, 255, (64, 64, 3), np.uint8),
        spaces.Discrete(17), episode_length, old_api=True))


class _Spec:
    def __init__(self, shape, minimum=None, maximum=None):
        self.shape = shape
        self.minimum = minimum
        self.maximum = maximum


class _TimeStep:
    def __init__(self, observation, reward, last):
        self.observation = observation
        self.reward = reward
        self._last = last

    def last(self):
        return self._last


class FakeDmControl:
    """A dm_env Environment with walker-walk's specs: orientations (14,),
    height (), velocity (9,) float64; 6 actions in [-1, 1]; reward 0.1 a
    step (None at reset); episodes of `episode_length` steps."""

    SPECS = {'orientations': (14,), 'height': (), 'velocity': (9,)}

    def __init__(self, episode_length=64, seed=0, bank=8):
        self.episode_length = episode_length
        rng = np.random.RandomState(seed)
        self._bank = [{k: rng.randn(*shape) for k, shape in
            self.SPECS.items()} for _ in range(bank)]
        self.t = 0

    def observation_spec(self):
        return {k: _Spec(shape) for k, shape in self.SPECS.items()}

    def action_spec(self):
        return _Spec((6,), -np.ones(6), np.ones(6))

    def reset(self):
        self.t = 0
        return _TimeStep(self._bank[0], None, False)

    def step(self, action):
        self.t += 1
        return _TimeStep(self._bank[self.t % len(self._bank)], 0.1,
            self.t >= self.episode_length)

    def close(self):
        pass


def make_fake_dm_control(episode_length=64):
    """FakeDmControl behind environments.dm_control.wrap (7 bins)."""
    from pufferlib_tpu_torch.environments.dm_control import wrap
    return wrap(FakeDmControl(episode_length))


class FakeLab:
    """deepmind_lab.Lab's API at the binding's 72 x 96 RGB_INTERLEAVED
    frames: step(raw, num_steps) returns reward 0.1, the episode stops
    running after `episode_length` steps."""

    def __init__(self, episode_length=64, seed=0, bank=8):
        self.episode_length = episode_length
        rng = np.random.RandomState(seed)
        self._bank = rng.randint(0, 256, (bank, 72, 96, 3)).astype(np.uint8)
        self.t = 0

    def observations(self):
        return {'RGB_INTERLEAVED': self._bank[self.t % len(self._bank)]}

    def reset(self, seed=None):
        self.t = 0

    def step(self, raw_action, num_steps=1):
        self.t += 1
        return 0.1

    def is_running(self):
        return self.t < self.episode_length

    def close(self):
        pass


def make_fake_dm_lab(episode_length=64):
    """FakeLab behind environments.dm_lab.wrap."""
    from pufferlib_tpu_torch.environments.dm_lab import wrap
    return wrap(FakeLab(episode_length))


def make_fake_griddly(episode_length=64):
    """A griddly env of (5, 11, 11) uint8 vector observations (the fake's
    layout) and 5 actions, behind environments.griddly.wrap."""
    from pufferlib_tpu_torch.environments.griddly import wrap
    return wrap(FakeBankEnv(spaces.Box(0, 1, (5, 11, 11), np.uint8),
        spaces.Discrete(5), episode_length))


def make_fake_magent(num_agents=128, episode_length=64):
    """battle_v4's per-agent spaces (13 x 13 x 5 float32, 21 actions) for
    `num_agents` agents, behind environments.magent.wrap."""
    from pufferlib_tpu_torch.environments.magent import wrap
    return wrap(FakeParallelEnv(num_agents, spaces.Box(0, 2, (13, 13, 5),
        np.float32), spaces.Discrete(21), episode_length, prefix='red_'))


def make_fake_microrts(episode_length=64):
    """gym-microrts' GlobalAgentCombinedRewardEnv on a 16 x 16 map (old
    gym's API): 16 x 16 x 27 int32 feature planes, MultiDiscrete([256,
    6, 4, 4, 4, 4, 7, 49]) actions, behind environments.microrts.wrap."""
    from pufferlib_tpu_torch.environments.microrts import wrap
    return wrap(FakeBankEnv(spaces.Box(0, 1, (16, 16, 27), np.int32),
        spaces.MultiDiscrete([256, 6, 4, 4, 4, 4, 7, 49]), episode_length,
        old_api=True))


def make_fake_minerl(episode_length=64):
    """A MineRL env (old gym's API): Dict of pov (64 x 64 x 3 uint8) and
    compassAngle (1,) float32, a Dict of eight binary actions, behind
    environments.minerl.wrap."""
    from pufferlib_tpu_torch.environments.minerl import wrap
    obs = spaces.Dict({'pov': spaces.Box(0, 255, (64, 64, 3), np.uint8),
        'compassAngle': spaces.Box(-180, 180, (1,), np.float32)})
    atn = spaces.Dict({k: spaces.Discrete(2) for k in ('attack', 'back',
        'forward', 'jump', 'left', 'right', 'sneak', 'sprint')})
    return wrap(FakeBankEnv(obs, atn, episode_length, old_api=True))


class FakeMiniGrid(FakeBankEnv):
    """MiniGrid after ImgObsWrapper: 7 x 7 x 3 uint8 images (object,
    colour and state codes, each below 11), 7 actions, reward 1 at an
    episode's last step, episodes of `episode_length` steps."""

    def __init__(self, episode_length=64, seed=0, bank=16):
        super().__init__(spaces.Box(0, 10, (7, 7, 3), np.uint8),
            spaces.Discrete(7), episode_length, reward=0.0, seed=seed,
            bank=bank)

    def step(self, action):
        obs, _, done, trunc, info = super().step(action)
        return obs, float(done), done, trunc, info


def make_fake_minigrid(episode_length=64):
    """FakeMiniGrid behind environments.minigrid.wrap."""
    from pufferlib_tpu_torch.environments.minigrid import wrap
    return wrap(FakeMiniGrid(episode_length))


class FakeNocturneBase:
    """nocturne's BaseEnv API (dict observations keyed by vehicle, a
    4-tuple step, `files` of scenarios): `num_agents` vehicles of flat
    float64 observations (the fake's width) and 21 actions; vehicle 0
    reaches its goal halfway, the rest at `episode_length` steps."""

    def __init__(self, num_agents=8, width=512, episode_length=64, seed=0,
            bank=8):
        self.files = ['scenario_0.json', 'scenario_1.json']
        self.observation_space = spaces.Box(-np.inf, np.inf, (width,),
            np.float32)
        self.action_space = spaces.Discrete(21)
        self.vehicles = [f'veh_{i}' for i in range(num_agents)]
        self.episode_length = episode_length
        rng = np.random.RandomState(seed)
        self._bank = rng.randn(bank, width)
        self.t = 0

    def _obs(self, agents):
        return {a: self._bank[(self.t + i) % len(self._bank)]
            for i, a in enumerate(agents)}

    def reset(self):
        self.t = 0
        self.live = list(self.vehicles)
        return self._obs(self.live)

    def step(self, actions):
        self.t += 1
        dones = {a: self.t >= self.episode_length or (a == 'veh_0'
            and self.t >= self.episode_length // 2) for a in self.live}
        out = (self._obs(self.live), {a: 0.1 for a in self.live}, dones,
            {a: {} for a in self.live})
        self.live = [a for a in self.live if not dones[a]]
        return out

    def close(self):
        pass


def make_fake_nocturne(num_agents=8, episode_length=64):
    """FakeNocturneBase behind environments.nocturne.wrap."""
    from pufferlib_tpu_torch.environments.nocturne import wrap
    return wrap(FakeNocturneBase(num_agents, episode_length=episode_length))


class _FakeSpielState:
    """A two-player alternating game of connect_four's size: 7 columns
    of 6 cells (a move into a full column goes to the first open one),
    the last mover wins after `length` moves."""

    def __init__(self, length):
        self.length = length
        self.heights = [0] * 7
        self.moves = []

    def is_chance_node(self):
        return False

    def current_player(self):
        return len(self.moves) % 2

    def legal_actions(self, player=None):
        return [c for c in range(7) if self.heights[c] < 6]

    def apply_action(self, action):
        if self.heights[action] >= 6:
            action = self.legal_actions()[0]
        self.heights[action] += 1
        self.moves.append(int(action))

    def is_terminal(self):
        return len(self.moves) >= self.length or not self.legal_actions()

    def returns(self):
        winner = (len(self.moves) - 1) % 2
        return [1.0 if p == winner else -1.0 for p in (0, 1)]

    def observation_tensor(self, player=None):
        board = np.zeros((3, 6, 7), np.float32)
        board[2] = 1
        fill = [0] * 7
        for i, c in enumerate(self.moves):
            board[i % 2, fill[c], c] = 1
            board[2, fill[c], c] = 0
            fill[c] += 1
        return board.ravel().tolist()


class FakeSpielGame:
    """pyspiel's game API at connect_four's sizes (126 observation
    values, 7 actions, 2 players)."""

    def __init__(self, length=12):
        self.length = length

    def num_distinct_actions(self):
        return 7

    def observation_tensor_size(self):
        return 126

    def num_players(self):
        return 2

    def new_initial_state(self):
        return _FakeSpielState(self.length)


class _FirstLegalBot:
    def __init__(self, max_simulations):
        self.max_simulations = max_simulations

    def step(self, state):
        return state.legal_actions()[0]


def make_fake_open_spiel(length=12):
    """The single-agent adapter over FakeSpielGame, its graded MCTS bots
    replaced by bots that play the first legal column, behind
    environments.open_spiel.wrap."""
    from pufferlib_tpu_torch.environments.open_spiel import wrap
    from pufferlib_tpu_torch.environments.open_spiel.adapters import (
        OpenSpielSingleAgentEnv)

    class Env(OpenSpielSingleAgentEnv):
        def _create_bots(self, seed):
            return [_FirstLegalBot(n) for n in range(self.min_simulations,
                self.max_simulations + 1)]

    return wrap(Env(game=FakeSpielGame(length)))


def make_fake_slimevolley(episode_length=64):
    """SlimeVolley-v0 (old gym's API): 12 float32 observations,
    MultiBinary(3) actions, behind environments.slimevolley.wrap."""
    from pufferlib_tpu_torch.environments.slimevolley import wrap
    return wrap(FakeBankEnv(spaces.Box(-np.inf, np.inf, (12,), np.float32),
        spaces.MultiBinary(3), episode_length, old_api=True))


def make_fake_smac(num_agents=8, episode_length=64):
    """SMAC's 8m map: 8 agents of 80 float32 observations and 14 actions,
    behind environments.smac.wrap."""
    from pufferlib_tpu_torch.environments.smac import wrap
    return wrap(FakeParallelEnv(num_agents, spaces.Box(-1, 1, (80,),
        np.float32), spaces.Discrete(14), episode_length))


def make_fake_stable_retro(episode_length=64):
    """A Genesis game through stable-retro (old gym's API): 224 x 320 x 3
    uint8 frames, MultiBinary(12) buttons, behind
    environments.stable_retro.wrap."""
    from pufferlib_tpu_torch.environments.stable_retro import wrap
    return wrap(FakeBankEnv(spaces.Box(0, 255, (224, 320, 3), np.uint8),
        spaces.MultiBinary(12), episode_length, old_api=True, bank=2))


def make_fake_vizdoom(episode_length=64):
    """ViZDoom's gymnasium env: Dict of screen (240 x 320 x 3 uint8) and
    gamevariables (1,) float32, 3 actions, behind
    environments.vizdoom.wrap."""
    from pufferlib_tpu_torch.environments.vizdoom import wrap
    obs = spaces.Dict({'screen': spaces.Box(0, 255, (240, 320, 3),
        np.uint8), 'gamevariables': spaces.Box(-np.inf, np.inf, (1,),
        np.float32)})
    return wrap(FakeBankEnv(obs, spaces.Discrete(3), episode_length,
        bank=2))


#: the fakes of the bindings whose wrap needs no gymnasium (links_awaken's
#: ResizeObservation does: it is held on the CPU only)
ZOO2_FAKES = {
    'bsuite': make_fake_bsuite,
    'butterfly': make_fake_butterfly,
    'classic_control': make_fake_classic_control,
    'crafter': make_fake_crafter,
    'dm_control': make_fake_dm_control,
    'dm_lab': make_fake_dm_lab,
    'griddly': make_fake_griddly,
    'magent': make_fake_magent,
    'microrts': make_fake_microrts,
    'minerl': make_fake_minerl,
    'minigrid': make_fake_minigrid,
    'nocturne': make_fake_nocturne,
    'open_spiel': make_fake_open_spiel,
    'slimevolley': make_fake_slimevolley,
    'smac': make_fake_smac,
    'stable_retro': make_fake_stable_retro,
    'vizdoom': make_fake_vizdoom,
}
