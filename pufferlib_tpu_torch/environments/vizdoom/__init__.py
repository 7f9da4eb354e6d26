"""ViZDoom binding (counterpart of pufferlib_tpu/environments/vizdoom/
__init__.py; reference pufferlib/environments/vizdoom): vizdoom's
gymnasium env (a Dict observation, emulated as bytes) behind
EpisodeStats and GymnasiumPufferEnv. make needs vizdoom, which is not
installed here: it raises.
"""
import functools


def env_creator(name='VizdoomHealthGatheringSupreme-v0'):
    return functools.partial(make, name)


def wrap(env):
    """EpisodeStats, then GymnasiumPufferEnv."""
    from pufferlib_tpu_torch.host_env import GymnasiumPufferEnv
    from pufferlib_tpu_torch.postprocess import EpisodeStats
    return GymnasiumPufferEnv(env=EpisodeStats(env))


def make(name='VizdoomHealthGatheringSupreme-v0', render_mode=None):
    try:
        import vizdoom.gymnasium_wrapper  # noqa: F401
    except ImportError as e:
        raise ImportError('vizdoom is not installed in this image') from e
    import gymnasium
    return wrap(gymnasium.make(name))
