"""OpenSpiel binding (counterpart of
pufferlib_tpu/environments/open_spiel/__init__.py; reference
pufferlib/environments/open_spiel: single-player mode plays vs a pool of
graded MCTS bots; the adapters are in open_spiel/adapters.py). make
needs open_spiel, which is not installed here: it raises.
"""
import functools


def env_creator(name='connect_four'):
    return functools.partial(make, name)


def wrap(env):
    """PettingZooPufferEnv over the multiplayer adapter; EpisodeStats and
    GymnasiumPufferEnv over the single-agent one."""
    from pufferlib_tpu_torch.environments.open_spiel.adapters import (
        OpenSpielPettingZooEnv)
    from pufferlib_tpu_torch.host_env import (
        GymnasiumPufferEnv, PettingZooPufferEnv)
    from pufferlib_tpu_torch.postprocess import EpisodeStats
    if isinstance(env, OpenSpielPettingZooEnv):
        return PettingZooPufferEnv(env=env)
    return GymnasiumPufferEnv(env=EpisodeStats(env))


def make(name='connect_four', multiplayer=False, n_rollouts=5,
        min_simulations=10, max_simulations=50, render_mode=None):
    try:
        import pyspiel  # noqa: F401
    except ImportError as e:
        raise ImportError('open_spiel is not installed in this image') from e
    from pufferlib_tpu_torch.environments.open_spiel.adapters import (
        OpenSpielPettingZooEnv, OpenSpielSingleAgentEnv)
    if multiplayer:
        return wrap(OpenSpielPettingZooEnv(name))
    return wrap(OpenSpielSingleAgentEnv(name, n_rollouts=n_rollouts,
        min_simulations=min_simulations, max_simulations=max_simulations))
