"""Hand-written CUDA kernels for Hopper (sources in pufferlib_tpu_torch/
csrc/), each behind a wrapper that counts its launches and that runs the
kernel's plain PyTorch version for tensors on the CPU.

| kernel            | replaces                                   |
| ----------------- | ------------------------------------------ |
| gae.KERNEL        | pufferlib_tpu/ops/pallas/gae.py:42         |
| mlp.KERNEL        | pufferlib_tpu/ops/pallas/mlp.py:80         |
"""
from pufferlib_tpu_torch.ops.cuda import gae, mlp

KERNELS = (gae.KERNEL, mlp.KERNEL)

__all__ = ['KERNELS', 'gae', 'mlp']
