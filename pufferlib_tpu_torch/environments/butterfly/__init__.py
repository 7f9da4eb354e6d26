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
    """The parallel env `name`, wrapped. pettingzoo 1.25 and later keep
    cooperative_pong_v5 only to raise DeprecatedEnv (an ImportError) on
    use: the default then builds cooperative_pong_v6, which the JAX binding
    does not (a divergence kept on purpose, ROADMAP.md)."""
    try:
        from pettingzoo.butterfly import (
            cooperative_pong_v5, knights_archers_zombies_v10)
    except ImportError as e:
        raise ImportError('pettingzoo[butterfly] extras missing') from e
    mods = {
        'cooperative_pong_v5': cooperative_pong_v5,
        'knights_archers_zombies_v10': knights_archers_zombies_v10,
    }
    try:
        env = mods[name].parallel_env(render_mode=render_mode)
    except ImportError as deprecated:
        if name != 'cooperative_pong_v5':
            raise
        try:
            from pettingzoo.butterfly import cooperative_pong_v6
        except ImportError:
            raise deprecated from None
        env = cooperative_pong_v6.parallel_env(render_mode=render_mode)
    return wrap(env)
