"""Procgen binding (counterpart of
pufferlib_tpu/environments/procgen/__init__.py; reference
pufferlib/environments/procgen/environment.py:22-76): procgen's native
vec env of one seen as one env, its reward clipped to [-10, 10], behind
EpisodeStats and GymnasiumPufferEnv, on the port's spaces. make needs
procgen, which is not installed here: it raises.

Policy: ProcgenResnet (reference procgen/torch.py), resolved lazily (PEP
562) as in environments.atari.
"""
import functools

import numpy as np


def __getattr__(name):
    if name == 'Policy':
        from pufferlib_tpu_torch.models import ProcgenResnet
        return ProcgenResnet
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')


def env_creator(name='bigfish'):
    return functools.partial(make, name)


class SingleFromVec:
    """A procgen vec env of one env as one env: the 'rgb' frame, the
    reward clipped to [-10, 10]."""

    render_mode = None

    def __init__(self, venv):
        from pufferlib_tpu_torch import spaces
        self.venv = venv
        self.observation_space = spaces.Box(0, 255,
            venv.observation_space['rgb'].shape, np.uint8)
        self.action_space = spaces.Discrete(int(venv.action_space.n))

    def reset(self, seed=None, options=None):
        obs = self.venv.reset()
        return obs['rgb'][0], {}

    def step(self, action):
        obs, rew, done, info = self.venv.step(np.array([action]))
        r = float(np.clip(rew[0], -10, 10))
        return obs['rgb'][0], r, bool(done[0]), False, info[0]

    def close(self):
        pass


def make(name='bigfish', num_levels=0, start_level=0,
        distribution_mode='easy', render_mode=None):
    try:
        from procgen import ProcgenEnv
    except ImportError as e:
        raise ImportError('procgen is not installed in this image') from e
    from pufferlib_tpu_torch.host_env import GymnasiumPufferEnv
    from pufferlib_tpu_torch.postprocess import EpisodeStats
    venv = ProcgenEnv(num_envs=1, env_name=name, num_levels=num_levels,
        start_level=start_level, distribution_mode=distribution_mode)
    return GymnasiumPufferEnv(env=EpisodeStats(SingleFromVec(venv)))
