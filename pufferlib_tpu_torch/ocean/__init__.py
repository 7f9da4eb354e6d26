"""Ocean env registry (pufferlib_tpu/ocean/__init__.py): env_creator and
the make_* creators with the JAX package's defaults, each env wrapped in
EpisodeStats unless episode_stats=False."""
from pufferlib_tpu_torch.environment import EpisodeStats
from pufferlib_tpu_torch.ocean.ocean import (
    Bandit, Memory, Multiagent, Password, Performance, PerformanceEmpiric,
    Spaces, Squared, Stochastic, VisualTarget,
)

__all__ = ['Bandit', 'Memory', 'Multiagent', 'Password', 'Performance',
    'PerformanceEmpiric', 'Spaces', 'Squared', 'Stochastic', 'VisualTarget',
    'env_creator']


def _wrap(env, episode_stats):
    return EpisodeStats(env) if episode_stats else env


def make_squared(distance_to_target=3, num_targets=1, episode_stats=True):
    return _wrap(Squared(distance_to_target=distance_to_target,
        num_targets=num_targets), episode_stats)


def make_bandit(num_actions=10, reward_scale=1, reward_noise=1,
        episode_stats=True):
    return _wrap(Bandit(num_actions=num_actions, reward_scale=reward_scale,
        reward_noise=reward_noise), episode_stats)


def make_memory(mem_length=2, mem_delay=2, episode_stats=True):
    return _wrap(Memory(mem_length=mem_length, mem_delay=mem_delay),
        episode_stats)


def make_password(password_length=5, episode_stats=True):
    return _wrap(Password(password_length=password_length), episode_stats)


def make_performance(delay_mean=0, delay_std=0, bandwidth=1,
        episode_stats=True):
    return _wrap(Performance(delay_mean=delay_mean, delay_std=delay_std,
        bandwidth=bandwidth), episode_stats)


def make_performance_empiric(count_n=0, count_std=0, bandwidth=1,
        episode_stats=True):
    return _wrap(PerformanceEmpiric(count_n=count_n, count_std=count_std,
        bandwidth=bandwidth), episode_stats)


def make_stochastic(p=0.7, horizon=100, episode_stats=True):
    return _wrap(Stochastic(p=p, horizon=horizon), episode_stats)


def make_spaces(episode_stats=True):
    return _wrap(Spaces(), episode_stats)


def make_multiagent(episode_stats=True):
    return _wrap(Multiagent(), episode_stats)


def make_visual(grid_size=10, cell_px=4, horizon=32, episode_stats=True):
    return _wrap(VisualTarget(grid_size=grid_size, cell_px=cell_px,
        horizon=horizon), episode_stats)


_CREATORS = {
    'squared': make_squared,
    'bandit': make_bandit,
    'memory': make_memory,
    'password': make_password,
    'performance': make_performance,
    'performance_empiric': make_performance_empiric,
    'stochastic': make_stochastic,
    'spaces': make_spaces,
    'multiagent': make_multiagent,
    'visual': make_visual,
}


def env_creator(name='squared'):
    if name not in _CREATORS:
        raise ValueError(
            f'Invalid environment name {name}. Valid: {sorted(_CREATORS)}')
    return _CREATORS[name]
