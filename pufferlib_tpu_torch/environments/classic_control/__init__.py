"""Classic control binding (counterpart of
pufferlib_tpu/environments/classic_control/__init__.py; reference
pufferlib/environments/classic_control/environment.py:12-21): a
gymnasium env behind EpisodeStats and GymnasiumPufferEnv. make needs
gymnasium.
"""
import functools

ALIASES = {
    'cartpole': 'CartPole-v1',
    'mountaincar': 'MountainCar-v0',
    'acrobot': 'Acrobot-v1',
    'pendulum': 'Pendulum-v1',
}


def env_creator(name='cartpole'):
    return functools.partial(make, name)


def wrap(env):
    """EpisodeStats, then GymnasiumPufferEnv."""
    from pufferlib_tpu_torch.host_env import GymnasiumPufferEnv
    from pufferlib_tpu_torch.postprocess import EpisodeStats
    return GymnasiumPufferEnv(env=EpisodeStats(env))


def make(name='cartpole', render_mode=None):
    import gymnasium
    return wrap(gymnasium.make(ALIASES.get(name, name),
        render_mode=render_mode))
