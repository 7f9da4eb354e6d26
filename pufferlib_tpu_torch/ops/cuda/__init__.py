"""Hand-written CUDA kernels for Hopper (sources in pufferlib_tpu_torch/
csrc/), each behind a wrapper that counts its launches and that runs the
kernel's plain PyTorch version for tensors on the CPU.

| kernel            | replaces                                   |
| ----------------- | ------------------------------------------ |
| gae.KERNEL        | pufferlib_tpu/ops/pallas/gae.py:42         |
| mlp.KERNEL        | pufferlib_tpu/ops/pallas/mlp.py:80         |
| lstm_enc.KERNEL   | pufferlib_tpu/ops/pallas/lstm_enc.py:170 (forward), lstm_enc5.py:147 (enc5 backward), lstm_enc.py:241 (enc backward) |
| lstm_cat.KERNEL   | pufferlib_tpu/ops/pallas/lstm_cat.py:131 (forward), :185 (backward) |
| lstm_cat.STREAM_KERNEL | lstm_cat.py:131 and :185 (lstm_cat_stream_*), lstm_enc.py:170 and lstm_enc5.py:147 (lstm_enc_stream_*), at the shapes lstm_cat.KERNEL and lstm_enc.KERNEL refuse (hidden sizes past 128, cat's f32 past 256; other input and feature widths) |
| lstm_scan.KERNEL  | pufferlib_tpu/ops/pallas/lstm.py:185 (lstm_scan forward), :236 (backward), :407 (lstm_scan_fused forward), :464 (backward) |
| archive.KERNEL    | pufferlib_tpu/ops/pallas/archive/lstm_enc2.py:176 (forward), :246 (backward), lstm_enc3.py:132, lstm_enc4.py:142, lstm_enc6.py:161 (backwards), lstm_tm.py:137 (forward), :181 (backward) |

burn.KERNEL (csrc/ocean_burn.cu) replaces no Pallas kernel: it is the
device work of the Ocean Performance envs, the lax.fori_loop of
pufferlib_tpu/ocean/ocean.py:243-251 and :284-290. It is listed so that
it is built and counted with the others.

The archive's variants (archive/lstm_enc2.py, lstm_enc3.py, lstm_enc4.py,
lstm_enc6.py, lstm_tm.py) are off the production import path, as the TPU
package's are: only their kernel is listed here, so that it is built and
counted with the others.
"""
from pufferlib_tpu_torch.ops.cuda import (
    archive, burn, gae, lstm_cat, lstm_enc, lstm_scan, mlp)

KERNELS = (gae.KERNEL, mlp.KERNEL, lstm_enc.KERNEL, lstm_cat.KERNEL,
    lstm_cat.STREAM_KERNEL, lstm_scan.KERNEL, archive.KERNEL, burn.KERNEL)

__all__ = ['KERNELS', 'archive', 'burn', 'gae', 'lstm_cat', 'lstm_enc',
    'lstm_scan', 'mlp']
