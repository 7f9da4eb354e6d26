"""Stable-Retro binding (counterpart of
pufferlib_tpu/environments/stable_retro/__init__.py; reference
pufferlib/environments/stable_retro, which targets a pre-1.0 API). make
needs stable-retro, which is not installed here: it raises.
"""
import functools


def env_creator(name='Airstriker-Genesis'):
    return functools.partial(make, name)


def wrap(env):
    """GymToGymnasium, EpisodeStats, GymnasiumPufferEnv."""
    from pufferlib_tpu_torch.host_env import GymnasiumPufferEnv
    from pufferlib_tpu_torch.postprocess import EpisodeStats
    from pufferlib_tpu_torch.wrappers import GymToGymnasium
    return GymnasiumPufferEnv(env=EpisodeStats(GymToGymnasium(env)))


def make(name='Airstriker-Genesis', render_mode=None):
    try:
        import retro
    except ImportError as e:
        raise ImportError('stable-retro is not installed') from e
    return wrap(retro.make(name))
