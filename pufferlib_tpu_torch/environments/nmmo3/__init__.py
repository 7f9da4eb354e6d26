"""NMMO3 binding (counterpart of pufferlib_tpu/environments/nmmo3/
__init__.py; reference pufferlib/environments/nmmo3/environment.py:
19-20): the third-party env ships a native PufferEnv (`PuffEnv`) with
pre-flattened per-agent arrays, which host_env.NativePufferEnv takes as
it is, without emulation. make needs nmmo3, which is not installed here:
it raises. Policy resolves lazily (PEP 562).
"""
import functools

Recurrent = dict(input_size=256, hidden_size=256, num_layers=1)


def __getattr__(name):
    if name == 'Policy':
        from pufferlib_tpu_torch.environments.nmmo3.policy import Policy
        return Policy
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')


def env_creator(name='nmmo3'):
    return functools.partial(make, name)


def make(name='nmmo3', width=1024, height=1024, num_envs=1,
        render_mode=None):
    try:
        from nmmo3 import PuffEnv
    except ImportError as e:
        raise ImportError('nmmo3 is not installed in this image') from e
    from pufferlib_tpu_torch.host_env import NativePufferEnv
    return NativePufferEnv(env=PuffEnv(width=width, height=height,
        num_envs=num_envs))
