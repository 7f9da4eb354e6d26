"""pufferlib_tpu_torch: the PufferLib-TPU feature set in PyTorch for CUDA.

A second package beside `pufferlib_tpu` (the JAX reference). Same module
layout, so each counterpart is found by name; inside, PyTorch idiom:

- envs step a batch of lanes as tensors on one device (environment, ocean)
- the fused PPO trainer runs rollout, GAE and update on the card
  (training.ppo)
- every Pallas TPU kernel on the path is a CUDA C++ kernel for Hopper
  (csrc/, ops/cuda/), each beside a plain PyTorch version of the same
  function

Entry points default to device='cuda' and raise when no card is present;
tests pass device='cpu', where the kernel wrappers run their plain
versions.
"""
__version__ = '0.1.0'

from pufferlib_tpu_torch.namespace import Namespace, namespace, dataclass
from pufferlib_tpu_torch.exceptions import APIUsageError, InvalidAgentError

__all__ = [
    'Namespace', 'namespace', 'dataclass',
    'APIUsageError', 'InvalidAgentError',
    'resolve_device',
]


def resolve_device(device):
    """torch.device for `device`; raises when CUDA is asked for and no
    card is present (the port never carries on on the CPU silently)."""
    import torch
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return device
