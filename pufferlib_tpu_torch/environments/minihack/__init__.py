"""MiniHack binding; NetHack's policy (counterpart of
pufferlib_tpu/environments/minihack/__init__.py; reference
pufferlib/environments/minihack/torch.py:4). make needs minihack, which
is not installed here: it raises.
"""
import functools

from pufferlib_tpu_torch.environments.nethack import (  # noqa: F401
    Recurrent, wrap)


def __getattr__(name):
    if name == 'Policy':
        from pufferlib_tpu_torch.environments.nethack.policy import Policy
        return Policy
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')


def env_creator(name='MiniHack-River-v0'):
    return functools.partial(make, name)


def make(name='MiniHack-River-v0', render_mode=None):
    try:
        import minihack  # noqa: F401
    except ImportError as e:
        raise ImportError('minihack is not installed in this image') from e
    import gymnasium
    return wrap(gymnasium.make(name,
        observation_keys=('glyphs', 'chars', 'colors', 'blstats')))
