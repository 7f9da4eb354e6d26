"""SlimeVolley binding (counterpart of
pufferlib_tpu/environments/slimevolley/__init__.py; reference
pufferlib/environments/slimevolley/environment.py:26-36): old gym's
API, its MultiBinary action emulated as a MultiDiscrete. make needs
slimevolleygym and old gym, which are not installed here: it raises.
"""
import functools


def env_creator(name='SlimeVolley-v0'):
    return functools.partial(make, name)


def wrap(env):
    """GymToGymnasium, EpisodeStats, GymnasiumPufferEnv."""
    from pufferlib_tpu_torch.host_env import GymnasiumPufferEnv
    from pufferlib_tpu_torch.postprocess import EpisodeStats
    from pufferlib_tpu_torch.wrappers import GymToGymnasium
    return GymnasiumPufferEnv(env=EpisodeStats(GymToGymnasium(env)))


def make(name='SlimeVolley-v0', render_mode=None):
    try:
        import slimevolleygym  # noqa: F401
    except ImportError as e:
        raise ImportError(
            'slimevolleygym is not installed in this image') from e
    import gym as old_gym
    return wrap(old_gym.make(name))
