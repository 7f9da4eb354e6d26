"""bsuite binding (counterpart of pufferlib_tpu/environments/bsuite/
__init__.py; reference pufferlib/environments/bsuite). make needs
bsuite, which is not installed here: it raises.
"""
import functools

from pufferlib_tpu_torch.exceptions import EpisodeLimitExceeded


def env_creator(name='bandit/0'):
    return functools.partial(make, name)


class BSuiteStopper:
    """Stop after the bsuite-mandated episode count (the suite's scores
    are only defined over exactly bsuite_num_episodes episodes —
    reference bsuite/environment.py:26-45, which exits the whole
    process; raising EpisodeLimitExceeded instead lets the caller stop
    cleanly: HostSerial propagates it, HostMultiprocessing surfaces it
    through the worker-death watchdog)."""

    def __init__(self, env):
        self.env = env
        self.num_episodes = 0
        self.observation_space = env.observation_space
        self.action_space = env.action_space

    def __getattr__(self, name):
        return getattr(self.env, name)

    def reset(self, *args, **kwargs):
        self.num_episodes += 1
        limit = getattr(self.env, 'bsuite_num_episodes', None)
        if limit is not None and self.num_episodes > limit:
            raise EpisodeLimitExceeded(
                f'bsuite mandates exactly {limit} episodes')
        return self.env.reset(*args, **kwargs)


def wrap(env):
    """The binding's wrapper stack over a bsuite env in old gym's API
    (bsuite's GymFromDMEnv): BSuiteStopper, GymToGymnasium, EpisodeStats,
    GymnasiumPufferEnv."""
    from pufferlib_tpu_torch.host_env import GymnasiumPufferEnv
    from pufferlib_tpu_torch.postprocess import EpisodeStats
    from pufferlib_tpu_torch.wrappers import GymToGymnasium
    env = BSuiteStopper(env)
    env = GymToGymnasium(env)
    env = EpisodeStats(env)
    return GymnasiumPufferEnv(env=env)


def make(name='bandit/0', render_mode=None):
    try:
        import bsuite
        from bsuite.utils import gym_wrapper
    except ImportError as e:
        raise ImportError('bsuite is not installed in this image') from e
    return wrap(gym_wrapper.GymFromDMEnv(bsuite.load_from_id(name)))
