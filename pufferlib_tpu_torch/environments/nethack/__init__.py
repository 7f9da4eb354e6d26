"""NetHack binding (counterpart of
pufferlib_tpu/environments/nethack/__init__.py; reference
pufferlib/environments/nethack). make needs nle, which is not installed
here: it raises. Policy (environments.nethack.policy) resolves lazily
(PEP 562), so that envpool workers, which import this package for wrap,
do not import torch.
"""
import functools

Recurrent = dict(input_size=256, hidden_size=256, num_layers=1)


def __getattr__(name):
    if name == 'Policy':
        from pufferlib_tpu_torch.environments.nethack.policy import Policy
        return Policy
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')


def env_creator(name='nethack'):
    return functools.partial(make, name)


def wrap(env):
    """The binding's wrapper stack over a NetHack env: EpisodeStats, then
    GymnasiumPufferEnv (its Dict observation emulated as bytes)."""
    from pufferlib_tpu_torch.host_env import GymnasiumPufferEnv
    from pufferlib_tpu_torch.postprocess import EpisodeStats
    return GymnasiumPufferEnv(env=EpisodeStats(env))


def make(name='nethack', render_mode=None):
    try:
        import nle  # noqa: F401
    except ImportError as e:
        raise ImportError('nle is not installed in this image') from e
    import gymnasium
    return wrap(gymnasium.make('NetHackScore-v0'))
