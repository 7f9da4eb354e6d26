"""Griddly binding (counterpart of pufferlib_tpu/environments/griddly/
__init__.py; reference pufferlib/environments/griddly). make needs
griddly, which is not installed here: it raises.
"""
import functools


def env_creator(name='GDY-Spiders-v0'):
    return functools.partial(make, name)


def wrap(env):
    """EpisodeStats, then GymnasiumPufferEnv."""
    from pufferlib_tpu_torch.host_env import GymnasiumPufferEnv
    from pufferlib_tpu_torch.postprocess import EpisodeStats
    return GymnasiumPufferEnv(env=EpisodeStats(env))


def make(name='GDY-Spiders-v0', render_mode=None):
    try:
        import griddly  # noqa: F401
    except ImportError as e:
        raise ImportError('griddly is not installed in this image') from e
    import gymnasium
    return wrap(gymnasium.make(name))
