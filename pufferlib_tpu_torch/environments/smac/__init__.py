"""SMAC binding (counterpart of pufferlib_tpu/environments/smac/
__init__.py; reference pufferlib/environments/smac). make needs smac,
which is not installed here: it raises.
"""
import functools


def env_creator(name='smac'):
    return functools.partial(make, name)


def wrap(env):
    """PettingZooTruncatedWrapper, MultiagentEpisodeStats,
    PettingZooPufferEnv, over a parallel env."""
    from pufferlib_tpu_torch.host_env import PettingZooPufferEnv
    from pufferlib_tpu_torch.postprocess import MultiagentEpisodeStats
    from pufferlib_tpu_torch.wrappers import PettingZooTruncatedWrapper
    env = PettingZooTruncatedWrapper(env)
    env = MultiagentEpisodeStats(env)
    return PettingZooPufferEnv(env=env)


def make(name='smac', render_mode=None):
    try:
        from smac.env.pettingzoo import StarCraft2PZEnv
    except ImportError as e:
        raise ImportError('smac is not installed in this image') from e
    return wrap(StarCraft2PZEnv.parallel_env())
