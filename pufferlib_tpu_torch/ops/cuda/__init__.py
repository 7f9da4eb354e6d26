"""Hand-written CUDA kernels for Hopper (sources in pufferlib_tpu_torch/
csrc/), each behind a wrapper that counts its launches and that runs the
kernel's plain PyTorch version for tensors on the CPU.

| kernel            | replaces                                   |
| ----------------- | ------------------------------------------ |
| gae.KERNEL        | pufferlib_tpu/ops/pallas/gae.py:42         |
| mlp.KERNEL        | pufferlib_tpu/ops/pallas/mlp.py:80         |
| lstm_enc.KERNEL   | pufferlib_tpu/ops/pallas/lstm_enc.py:170 (forward), lstm_enc5.py:147 (enc5 backward), lstm_enc.py:241 (enc backward) |
| lstm_cat.KERNEL   | pufferlib_tpu/ops/pallas/lstm_cat.py:131 (forward), :185 (backward) |
| lstm_scan.KERNEL  | pufferlib_tpu/ops/pallas/lstm.py:185 (lstm_scan forward), :236 (backward), :407 (lstm_scan_fused forward), :464 (backward) |
"""
from pufferlib_tpu_torch.ops.cuda import (
    gae, lstm_cat, lstm_enc, lstm_scan, mlp)

KERNELS = (gae.KERNEL, mlp.KERNEL, lstm_enc.KERNEL, lstm_cat.KERNEL,
    lstm_scan.KERNEL)

__all__ = ['KERNELS', 'gae', 'lstm_cat', 'lstm_enc', 'lstm_scan', 'mlp']
