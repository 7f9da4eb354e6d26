"""Ocean env registry (pufferlib_tpu/ocean/__init__.py), with EpisodeStats
wrapping. This slice ports `squared`; the other names are listed so that
asking for one says where it stands instead of that it does not exist."""
from pufferlib_tpu_torch.environment import EpisodeStats
from pufferlib_tpu_torch.ocean.ocean import Squared


def make_squared(distance_to_target=3, num_targets=1, episode_stats=True):
    env = Squared(distance_to_target=distance_to_target,
        num_targets=num_targets)
    return EpisodeStats(env) if episode_stats else env


_CREATORS = {
    'squared': make_squared,
}

_NOT_PORTED = ('bandit', 'memory', 'password', 'performance',
    'performance_empiric', 'stochastic', 'spaces', 'multiagent', 'visual')


def env_creator(name='squared'):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f'Ocean env {name!r} is not ported to PyTorch yet; see '
            'ROADMAP.md, queue 1, "The other Ocean envs"')
    if name not in _CREATORS:
        raise ValueError(
            f'Invalid environment name {name}. Valid: {sorted(_CREATORS)}')
    return _CREATORS[name]
