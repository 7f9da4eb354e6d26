"""Procgen's policy (counterpart of
pufferlib_tpu/environments/procgen/__init__.py's Policy alias):
ProcgenResnet (reference procgen/torch.py), resolved lazily (PEP 562) as
in environments.atari. The env binding itself (make, env_creator) waits
with the env zoo: it needs the procgen package, which is not installed.
"""


def __getattr__(name):
    if name == 'Policy':
        from pufferlib_tpu_torch.models import ProcgenResnet
        return ProcgenResnet
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
