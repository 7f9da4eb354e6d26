"""MineRL binding (counterpart of pufferlib_tpu/environments/minerl/
__init__.py; reference pufferlib/environments/minerl). make needs minerl
and old gym, which are not installed here: it raises.
"""
import functools


def env_creator(name='MineRLBasaltFindCave-v0'):
    return functools.partial(make, name)


def wrap(env):
    """GymToGymnasium (old gym's API), EpisodeStats, GymnasiumPufferEnv."""
    from pufferlib_tpu_torch.host_env import GymnasiumPufferEnv
    from pufferlib_tpu_torch.postprocess import EpisodeStats
    from pufferlib_tpu_torch.wrappers import GymToGymnasium
    return GymnasiumPufferEnv(env=EpisodeStats(GymToGymnasium(env)))


def make(name='MineRLBasaltFindCave-v0', render_mode=None):
    try:
        import minerl  # noqa: F401
    except ImportError as e:
        raise ImportError('minerl is not installed in this image') from e
    import gym as old_gym
    return wrap(old_gym.make(name))
