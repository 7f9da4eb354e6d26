"""MAgent binding (counterpart of pufferlib_tpu/environments/magent/
__init__.py; reference pufferlib/environments/magent). make needs
magent2, which is not installed here: it raises.
"""
import functools


def env_creator(name='battle_v4'):
    return functools.partial(make, name)


def wrap(env):
    """MultiagentEpisodeStats, then PettingZooPufferEnv, over a parallel
    env."""
    from pufferlib_tpu_torch.host_env import PettingZooPufferEnv
    from pufferlib_tpu_torch.postprocess import MultiagentEpisodeStats
    return PettingZooPufferEnv(env=MultiagentEpisodeStats(env))


def make(name='battle_v4', render_mode=None):
    try:
        from magent2.environments import battle_v4
    except ImportError as e:
        raise ImportError('magent2 is not installed in this image') from e
    return wrap(battle_v4.parallel_env(render_mode=render_mode))
