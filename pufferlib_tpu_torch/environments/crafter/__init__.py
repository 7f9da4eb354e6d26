"""Crafter binding (counterpart of pufferlib_tpu/environments/crafter/
__init__.py; reference pufferlib/environments/crafter). make needs
crafter, which is not installed here: it raises.
"""
import functools


def env_creator(name='CrafterReward-v1'):
    return functools.partial(make, name)


def wrap(env):
    """GymToGymnasium (crafter keeps old gym's API), EpisodeStats,
    GymnasiumPufferEnv."""
    from pufferlib_tpu_torch.host_env import GymnasiumPufferEnv
    from pufferlib_tpu_torch.postprocess import EpisodeStats
    from pufferlib_tpu_torch.wrappers import GymToGymnasium
    return GymnasiumPufferEnv(env=EpisodeStats(GymToGymnasium(env)))


def make(name='CrafterReward-v1', render_mode=None):
    try:
        import crafter
    except ImportError as e:
        raise ImportError('crafter is not installed in this image') from e
    return wrap(crafter.Env())
