"""Gym-MicroRTS binding (counterpart of
pufferlib_tpu/environments/microrts/__init__.py; reference
pufferlib/environments/microrts/environment.py:
GlobalAgentCombinedRewardEnv + int32 obs cast + old-gym compat; the
reference notes the upstream library is fragile). make needs
gym-microrts, which is not installed here: it raises.
"""
import functools

import numpy as np


class MicroRTSInt32:
    """Cast observations to int32 (reference MicroRTS wrapper,
    microrts/environment.py:36-49); old-gym 4-tuple API preserved for
    GymToGymnasium."""

    def __init__(self, env):
        self.env = env
        self.observation_space = env.observation_space
        self.action_space = env.action_space
        self.render_mode = getattr(env, 'render_mode', None)

    def reset(self):
        return np.asarray(self.env.reset(), np.int32)

    def step(self, action):
        o, r, d, i = self.env.step(action)
        return np.asarray(o, np.int32), r, d, i

    def render(self):
        return self.env.render()

    def close(self):
        return self.env.close()

    def seed(self, seed):
        if hasattr(self.env, 'seed'):
            self.env.seed(seed)


def env_creator(name='GlobalAgentCombinedRewardEnv'):
    return functools.partial(make, name)


def wrap(env):
    """The binding's stack over a gym-microrts env (old gym's API):
    MicroRTSInt32, GymToGymnasium, EpisodeStats, GymnasiumPufferEnv."""
    from pufferlib_tpu_torch.host_env import GymnasiumPufferEnv
    from pufferlib_tpu_torch.postprocess import EpisodeStats
    from pufferlib_tpu_torch.wrappers import GymToGymnasium
    env = MicroRTSInt32(env)
    env = GymToGymnasium(env)
    env = EpisodeStats(env)
    return GymnasiumPufferEnv(env=env)


def make(name='GlobalAgentCombinedRewardEnv', render_mode=None):
    try:
        from gym_microrts import envs as microrts_envs
    except ImportError as e:
        raise ImportError('gym-microrts is not installed') from e
    if not hasattr(microrts_envs, name):
        raise ValueError(f'Unknown microrts environment: {name}')
    return wrap(getattr(microrts_envs, name)())
