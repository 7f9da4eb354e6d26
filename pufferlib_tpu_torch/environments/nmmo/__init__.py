"""Neural MMO binding (counterpart of
pufferlib_tpu/environments/nmmo/__init__.py; reference
pufferlib/environments/nmmo/environment.py:15-76). make needs nmmo,
which is not installed here: it raises. Policy resolves lazily (PEP 562).
"""
import functools

Recurrent = dict(input_size=256, hidden_size=256, num_layers=1)


def __getattr__(name):
    if name == 'Policy':
        from pufferlib_tpu_torch.environments.nmmo.policy import Policy
        return Policy
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')


def env_creator(name='nmmo'):
    return functools.partial(make, name)


def wrap(env):
    """The binding's wrapper stack over a Neural MMO parallel env:
    PettingZooTruncatedWrapper, MultiagentEpisodeStats, MeanOverAgents,
    PettingZooPufferEnv."""
    from pufferlib_tpu_torch.host_env import PettingZooPufferEnv
    from pufferlib_tpu_torch.postprocess import (
        MeanOverAgents, MultiagentEpisodeStats)
    from pufferlib_tpu_torch.wrappers import PettingZooTruncatedWrapper
    env = PettingZooTruncatedWrapper(env)
    env = MultiagentEpisodeStats(env)
    env = MeanOverAgents(env)
    return PettingZooPufferEnv(env=env)


def make(name='nmmo', render_mode=None):
    try:
        import nmmo
    except ImportError as e:
        raise ImportError('nmmo is not installed in this image') from e
    return wrap(nmmo.Env())
