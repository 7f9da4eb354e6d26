"""lstm_scan_enc5 with two interleaved recurrence chains, through
csrc/lstm_archive.cu.

Replaces pufferlib_tpu/ops/pallas/archive/lstm_enc6.py: `lstm_scan_enc6`,
whose forward is lstm_enc._impl (ops/cuda/lstm_enc.py has it) and whose
backward is lstm_enc5._hoisted_bwd with lstm_enc6._bwd_kernel. enc6 is a
schedule and not a function: it computes what enc5's backward computes,
to the last rounding point, so its plain version is enc5's
(lstm_enc.lstm_enc_backward_reference). What is its own is the kernel: a
block walks two independent half tiles of batch rows in one loop body,
each with its own dh/dc chain, so that one chain's recurrent product may
overlap the other's element-wise work and a staged chunk of W_hh^T serves
twice the rows. The gate activations of every step are computed before
the loop and kept in cdt, dx follows the loop, as in enc5's TPU kernel.

On the card in bf16 the backward is enc5's tensor-core backward itself
(csrc/lstm_tc.cuh, mode ENC6, whose reverse loop is ENC5's instance), so
its gradients are enc5's bit for bit. Its two chains are that loop's two
halves: a block's 64 rows are two halves of 32, eight warps each, each
half with its own dh/dc chain and its own named barrier, so that one
half's products run while the other works its cell math. In f32 the
backward is enc5's f32 backward itself (csrc/lstm_f32.cuh, design
'cluster', as lstm_enc's enc5 runs it), so its gradients are enc5's bit
for bit there too.
"""
import torch

from pufferlib_tpu_torch.ops.cuda import lstm_enc
from pufferlib_tpu_torch.ops.cuda.archive import (
    EncVariant, launch_tc_backward, scan_enc_variant)
from pufferlib_tpu_torch.ops.cuda.lstm_common import BACKWARD_PHASES

__all__ = ['lstm_scan_enc6', 'VARIANT']


def _launch_backward(*args, phases=BACKWARD_PHASES):
    """lstm_enc6_backward: on the tensor cores in bf16, on lstm_f32.cuh in
    f32 (archive.launch_tc_backward)."""
    return launch_tc_backward('lstm_enc6_backward', *args, phases=phases)


VARIANT = EncVariant(lstm_enc.lstm_enc_reference,
    lstm_enc._launch_enc_forward, lstm_enc.lstm_enc_backward_reference,
    _launch_backward)


def lstm_scan_enc6(feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b,
        cdt=torch.bfloat16):
    """lstm_scan_enc5's function through the two-chain backward kernel:
    see archive.scan_enc_variant."""
    return scan_enc_variant(VARIANT, feats, h0, c0, w_enc, b_enc, w_ih,
        w_hh, b, cdt)
