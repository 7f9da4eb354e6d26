"""GAE through the CUDA kernel csrc/gae.cu.

Replaces pufferlib_tpu/ops/pallas/gae.py (compute_gae_pallas). Its plain
version is compute_gae (ops/gae.py), imported here: the wrapper runs it
for tensors on the CPU, and chip_smoke.py holds the kernel against it on
the card. For CUDA tensors the wrapper launches the kernel or raises.
"""
import torch

from pufferlib_tpu_torch.ops.cuda._build import (
    CudaKernel, F, I, P, ptr, stream_handle)
from pufferlib_tpu_torch.ops.gae import compute_gae

__all__ = ['compute_gae_cuda', 'compute_gae', 'KERNEL']

KERNEL = CudaKernel('gae.cu', {
    'gae_forward': [P, P, P, P, P, I, I, F, F, P],
})


def _check(name, t, shape, device):
    if t.device != device:
        raise ValueError(f'{name} is on {t.device}, expected {device}')
    if t.dtype != torch.float32:
        raise ValueError(f'{name} must be float32, got {t.dtype}')
    if tuple(t.shape) != shape:
        raise ValueError(f'{name} has shape {tuple(t.shape)}, expected {shape}')
    if not t.is_contiguous():
        raise ValueError(f'{name} must be contiguous')


def compute_gae_cuda(rewards, values, dones, last_value, gamma, gae_lambda):
    """rewards/values/dones: (T, E) float32; last_value: (E,) -> adv (T, E).

    Inputs are checked on every device. CPU tensors: the plain
    compute_gae. CUDA tensors: the kernel."""
    if rewards.dim() != 2:
        raise ValueError(f'rewards must be (T, E), got {tuple(rewards.shape)}')
    T, E = rewards.shape
    device = rewards.device
    for name, t in (('rewards', rewards), ('values', values),
            ('dones', dones)):
        _check(name, t, (T, E), device)
    _check('last_value', last_value, (E,), device)
    if device.type == 'cpu':
        return compute_gae(rewards, values, dones, last_value, gamma,
            gae_lambda)
    if device.type != 'cuda':
        raise ValueError(f'no GAE kernel for device {device}')
    adv = torch.empty_like(rewards)
    if T * E == 0:
        return adv
    KERNEL.launch('gae_forward', ptr(rewards), ptr(values), ptr(dones),
        ptr(last_value), ptr(adv), T, E, float(gamma),
        float(gamma * gae_lambda), stream_handle(rewards))
    return adv
