"""The device work of the Ocean Performance envs, through the CUDA kernel
csrc/ocean_burn.cu.

Replaces the per-lane lax.fori_loop of pufferlib_tpu/ocean/ocean.py
(Performance._burn :243-251, PerformanceEmpiric.step :284-290), which
the JAX package runs on the device; no Pallas kernel. Its plain version
is burn_reference, a masked loop: the wrapper runs it for tensors on the
CPU, and chip_smoke.py holds the kernel against it on the card. For CUDA
tensors the wrapper launches the kernel or raises.
"""
import torch

from pufferlib_tpu_torch.ops.cuda._build import (
    CudaKernel, I, P, ptr, stream_handle)

__all__ = ['burn', 'burn_reference', 'KERNEL']

KERNEL = CudaKernel('ocean_burn.cu', {
    'ocean_burn': [P, P, I, P],
})


def burn_reference(x, iters):
    """x (N,) float32 after iters[i] steps of v = v * 1.0000001 + 1e-9 on
    lane i (a count <= 0 leaves the lane as it is). Reads the largest
    count on the host."""
    steps = int(iters.max().item()) if iters.numel() else 0
    for i in range(steps):
        x = torch.where(iters > i, x * 1.0000001 + 1e-9, x)
    return x


def burn(x, iters):
    """x: (N,) float32, iters: (N,) int32 on the same device -> the burnt
    x (a new tensor). CPU tensors: burn_reference. CUDA tensors: the
    kernel, which reads the counts on the device."""
    if x.dim() != 1 or x.dtype != torch.float32:
        raise ValueError(f'x must be (N,) float32, got {x.dtype} '
            f'{tuple(x.shape)}')
    if iters.shape != x.shape or iters.dtype != torch.int32:
        raise ValueError(f'iters must be {tuple(x.shape)} int32, got '
            f'{iters.dtype} {tuple(iters.shape)}')
    if iters.device != x.device:
        raise ValueError(f'iters is on {iters.device}, x on {x.device}')
    if x.device.type == 'cpu':
        return burn_reference(x, iters)
    if x.device.type != 'cuda':
        raise ValueError(f'no burn kernel for device {x.device}')
    out = x.clone()
    if out.numel() == 0:
        return out
    KERNEL.launch('ocean_burn', ptr(out), ptr(iters.contiguous()),
        out.numel(), stream_handle(out))
    return out
