"""SB3-style Atari wrappers (counterpart of
pufferlib_tpu/environments/atari/wrappers.py), dependency-free so the
stack's contracts are unit-testable with a fake ALE env (ale-py is not
installed).

Reference stack (pufferlib/environments/atari/environment.py:17-41):
NoopResetEnv(30) -> MaxAndSkipEnv(4) -> EpisodicLifeEnv -> FireResetEnv
-> ClipRewardEnv(sign) -> Resize 84x84 grayscale -> FrameStack. The
reset/life-loss contract is guarded by ref tests/test_atari_reset.py:5-27.
"""
import numpy as np


class _Wrapper:
    """Minimal gymnasium-style wrapper base (avoids importing gymnasium
    at module import time so fake-env tests run anywhere)."""

    def __init__(self, env):
        self.env = env

    def __getattr__(self, name):
        return getattr(self.env, name)

    def reset(self, seed=None, options=None):
        return self.env.reset(seed=seed, options=options)

    def step(self, action):
        return self.env.step(action)

    def close(self):
        return self.env.close()


class NoopResetEnv(_Wrapper):
    """Random number of no-ops (action 0) after reset, for start-state
    diversity (SB3 NoopResetEnv semantics)."""

    def __init__(self, env, noop_max=30):
        super().__init__(env)
        self.noop_max = noop_max
        self._rng = np.random.RandomState()

    def reset(self, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.RandomState(seed)
        obs, info = self.env.reset(seed=seed, options=options)
        noops = self._rng.randint(1, self.noop_max + 1)
        for _ in range(noops):
            obs, _, terminated, truncated, info = self.env.step(0)
            if terminated or truncated:
                obs, info = self.env.reset()
        return obs, info


class MaxAndSkipEnv(_Wrapper):
    """Repeat action `skip` times, sum rewards, max over the last two
    frames (flicker removal)."""

    def __init__(self, env, skip=4):
        super().__init__(env)
        self._skip = skip

    def step(self, action):
        total = 0.0
        terminated = truncated = False
        frames = []
        obs = info = None
        for i in range(self._skip):
            obs, reward, terminated, truncated, info = self.env.step(action)
            total += reward
            if i >= self._skip - 2:
                frames.append(np.asarray(obs))
            if terminated or truncated:
                break
        obs = np.max(np.stack(frames), axis=0) if len(frames) > 1 \
            else np.asarray(obs)
        return obs, total, terminated, truncated, info


class EpisodicLifeEnv(_Wrapper):
    """End the episode on life loss but only truly reset the underlying
    env when the real game is over — in between, a no-op step advances
    past the life transition. Requires the env to expose lives via
    info['lives'] or env.unwrapped.ale.lives()."""

    def __init__(self, env):
        super().__init__(env)
        self.lives = 0
        self.was_real_done = True

    def _lives(self, info):
        if 'lives' in info:
            return info['lives']
        ale = getattr(getattr(self.env, 'unwrapped', self.env), 'ale', None)
        return ale.lives() if ale is not None else 0

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        self.was_real_done = terminated or truncated
        lives = self._lives(info)
        if 0 < lives < self.lives:
            terminated = True
        self.lives = lives
        return obs, reward, terminated, truncated, info

    def reset(self, seed=None, options=None):
        if self.was_real_done:
            obs, info = self.env.reset(seed=seed, options=options)
        else:
            obs, _, terminated, truncated, info = self.env.step(0)
            if terminated or truncated:
                obs, info = self.env.reset(seed=seed, options=options)
        self.lives = self._lives(info)
        return obs, info


class FireResetEnv(_Wrapper):
    """Press FIRE after reset for games that require it (action meanings
    contain 'FIRE' at index 1)."""

    def reset(self, seed=None, options=None):
        obs, info = self.env.reset(seed=seed, options=options)
        obs, _, terminated, truncated, info = self.env.step(1)
        if terminated or truncated:
            obs, info = self.env.reset()
        return obs, info


class ClipRewardEnv(_Wrapper):
    """Sign-clip rewards: r -> np.sign(r). The reference uses SB3
    ClipRewardEnv which is sign, NOT clamp — r=0.5 must become 1.0."""

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        return obs, float(np.sign(reward)), terminated, truncated, info


def needs_fire_reset(env):
    """True when the underlying env advertises FIRE at action index 1."""
    unwrapped = getattr(env, 'unwrapped', env)
    get = getattr(unwrapped, 'get_action_meanings', None)
    if get is None:
        return False
    meanings = get()
    return len(meanings) >= 3 and meanings[1] == 'FIRE'
