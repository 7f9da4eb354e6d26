"""dm_control binding (counterpart of
pufferlib_tpu/environments/dm_control/__init__.py; reference
pufferlib/environments/dm_control).

Ships its own dm_env -> gymnasium adapter (the reference relies on
shimmy), on the port's spaces: dm_env TimeSteps become 5-tuples, the
observation spec becomes a Dict space, and continuous actions are
discretized per dimension so the flat MultiDiscrete contract holds (same
approach as the reference's slimevolley MultiDiscrete-ification,
slimevolley/environment.py:26-36). make needs dm_control.
"""
import functools

import numpy as np


def env_creator(name='walker-walk'):
    return functools.partial(make, name)


class DmControlToGymnasium:
    """Minimal dm_env -> gymnasium adapter with action discretization."""

    def __init__(self, env, bins=7):
        from pufferlib_tpu_torch import spaces
        self._env = env
        self._bins = bins
        obs_spec = env.observation_spec()
        boxes = {}
        for k, spec in obs_spec.items():
            shape = spec.shape if spec.shape else (1,)
            boxes[k] = spaces.Box(low=-np.inf, high=np.inf, shape=shape,
                dtype=np.float64)
        self.observation_space = spaces.Dict(boxes)
        act_spec = env.action_spec()
        self._act_low = np.asarray(act_spec.minimum, np.float64).ravel()
        self._act_high = np.asarray(act_spec.maximum, np.float64).ravel()
        self.action_space = spaces.MultiDiscrete([bins] * self._act_low.size)
        self.render_mode = None

    def _obs(self, timestep):
        return {k: np.asarray(v, np.float64).reshape(
            self.observation_space[k].shape)
            for k, v in timestep.observation.items()}

    def reset(self, seed=None, options=None):
        if seed is not None:
            try:
                self._env.task.random.seed(seed)
            except AttributeError:
                pass
        ts = self._env.reset()
        return self._obs(ts), {}

    def step(self, action):
        frac = np.asarray(action, np.float64) / (self._bins - 1)
        cont = self._act_low + frac * (self._act_high - self._act_low)
        ts = self._env.step(cont)
        reward = float(ts.reward or 0.0)
        truncated = bool(ts.last())  # dm_control suite episodes time out
        return self._obs(ts), reward, False, truncated, {}

    def close(self):
        self._env.close()


def _parse_name(name, suite):
    """Split 'domain-task' (or fully-underscored 'domain_task') into a
    valid (domain, task) pair. Domains may themselves contain
    underscores ('ball_in_cup-catch'), so validate candidates against
    the suite's domain list instead of splitting blindly."""
    domains = {d for d, _ in suite.ALL_TASKS}
    if '-' in name:
        domain, task = name.split('-', 1)
        if domain in domains:
            return domain, task.replace('-', '_')
    parts = name.replace('-', '_').split('_')
    for i in range(len(parts) - 1, 0, -1):
        domain = '_'.join(parts[:i])
        if domain in domains:
            return domain, '_'.join(parts[i:])
    raise ValueError(
        f'cannot parse dm_control name {name!r}; known domains: '
        f'{sorted(domains)}')


def wrap(env, bins=7):
    """The binding's stack over a dm_env Environment:
    DmControlToGymnasium, EpisodeStats, GymnasiumPufferEnv."""
    from pufferlib_tpu_torch.host_env import GymnasiumPufferEnv
    from pufferlib_tpu_torch.postprocess import EpisodeStats
    env = DmControlToGymnasium(env, bins=bins)
    return GymnasiumPufferEnv(env=EpisodeStats(env))


def make(name='walker-walk', bins=7, render_mode=None):
    try:
        from dm_control import suite
    except ImportError as e:
        raise ImportError('dm_control is not installed in this image') from e
    domain, task = _parse_name(name, suite)
    return wrap(suite.load(domain, task), bins=bins)
