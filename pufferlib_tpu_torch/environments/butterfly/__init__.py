"""PettingZoo butterfly binding (counterpart of
pufferlib_tpu/environments/butterfly/__init__.py; reference
pufferlib/environments/butterfly/environment.py:1-12). make needs
pettingzoo's butterfly extras.
"""
import functools


def env_creator(name='cooperative_pong_v5'):
    return functools.partial(make, name)


def wrap(env):
    """MultiagentEpisodeStats, then PettingZooPufferEnv, over a parallel
    env."""
    from pufferlib_tpu_torch.host_env import PettingZooPufferEnv
    from pufferlib_tpu_torch.postprocess import MultiagentEpisodeStats
    return PettingZooPufferEnv(env=MultiagentEpisodeStats(env))


def make(name='cooperative_pong_v5', render_mode=None):
    try:
        from pettingzoo.butterfly import (
            cooperative_pong_v5, knights_archers_zombies_v10)
    except ImportError as e:
        raise ImportError('pettingzoo[butterfly] extras missing') from e
    mods = {
        'cooperative_pong_v5': cooperative_pong_v5,
        'knights_archers_zombies_v10': knights_archers_zombies_v10,
    }
    return wrap(mods[name].parallel_env(render_mode=render_mode))
