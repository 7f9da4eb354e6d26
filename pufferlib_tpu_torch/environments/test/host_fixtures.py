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
