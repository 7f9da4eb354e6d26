"""Archived LSTM kernel variants, through csrc/lstm_archive.cu: the
counterpart of pufferlib_tpu/ops/pallas/archive/. Schedules of the LSTM
backward that the TPU kernel campaign tried and set aside (enc2, enc3,
enc4, enc6) and the time-major scan (tm), kept runnable as measured
points for kernel work and off the production import path: LSTMWrapper
takes none of them. tools/kernel_lab_torch.py times them.

This module holds what the four encoder-fused variants share: the
autograd.Function (one forward and one backward, plain for CPU tensors, a
kernel launch for CUDA tensors, no way from one to the other), the
backwards' launchers and the design each backward runs. Each variant's
module gives its plain versions, its launchers and its public function.

In bf16 the four backwards run the tensor-core kernels of
csrc/lstm_tc.cuh (backward_design): mode ENC5's path (the encoder, the P
pre-pass, a reverse loop with W_hh in shared memory, dpre and the
split-K) with each variant's roundings: enc2 and enc4 f32 activations and
db from the rounded dgates (enc2's pre-pass rounding its projection),
enc3 rounded activations and db from the unrounded dgates, enc6 enc5's
own. In f32 they run lstm_archive.cu's FMA kernel. Both designs take the
same shapes (D == H, at most 128 features, hidden sizes 32, 64 and 128;
enc6's f32 block, two tiles of dgates, also a feature width its shared
memory holds), refused before any launch.
"""
import collections

import torch

from pufferlib_tpu_torch.ops.cuda import lstm_enc
from pufferlib_tpu_torch.ops.cuda._build import CudaKernel, I, P
from pufferlib_tpu_torch.ops.cuda.lstm_common import (
    BACKWARD_PHASES, ROWS_PER_BLOCK, backward_inputs, check_encoder_inputs,
    check_fma_encoder_kernel_shape, needs_cseq)

_TC_BACKWARD = lstm_enc.KERNEL.functions['lstm_enc_backward']
KERNEL = CudaKernel('lstm_archive.cu', {
    'lstm_enc2_forward': [P] * 12 + [I] * 5 + [P],
    'lstm_enc2_backward': _TC_BACKWARD,
    'lstm_enc3_backward': _TC_BACKWARD,
    'lstm_enc4_backward': _TC_BACKWARD,
    'lstm_enc6_backward': _TC_BACKWARD,
    'lstm_tm_step_forward': [P] * 8 + [I] * 6 + [P],
    'lstm_tm_step_backward': [P] * 15 + [I] * 7 + [P],
    # not a launch: the archive's own bf16 kernels' registers and spills
    'lstm_archive_tc_usage': [I, P],
})

# the backwards with a tensor-core design in bf16
TC_BACKWARDS = ('lstm_enc2_backward', 'lstm_enc3_backward',
    'lstm_enc4_backward', 'lstm_enc6_backward')


def backward_design(fn, cdt):
    """The design the backward C function `fn` runs in cdt: 'tc'
    (lstm_tc.cuh's tensor-core kernels: TC_BACKWARDS in bf16) or 'fma'
    (lstm_archive.cu's archive_backward)."""
    return 'tc' if fn in TC_BACKWARDS and cdt == torch.bfloat16 else 'fma'

# shared memory a block may use (lstm_common.cuh MAX_SMEM)
MAX_SHARED_BYTES = 227 * 1024

# One encoder-fused variant: forward(feats, h0, c0, w_enc, b_enc, w_ih,
# w_hh, b, cdt, save_cseq) -> (outs, hT, cT, cseq) and backward(those
# eight, outs, cseq, g_outs, g_hT, g_cT, cdt) -> the seven gradients, each
# as a plain version and as a kernel launcher
EncVariant = collections.namedtuple('EncVariant',
    'forward_plain forward_launch backward_plain backward_launch')


def launch_tc_backward(fn, feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b, outs,
        cseq, g_outs, g_hT, g_cT, cdt, phases=BACKWARD_PHASES, row_tiles=1,
        acts_slab=False):
    """Launch the encoder-fused backward `fn` of lstm_archive.cu, whose
    arguments are lstm_enc_backward's: (dh0, dc0, dW_enc, db_enc, dW_ih,
    dW_hh, db). In bf16 the tensor-core kernels (backward_design) with
    their scratch, the f32 P slab and the bf16 weights; phases < 4 stops a
    bf16 call early, to time a phase. In f32 the FMA kernel, whose block
    takes row_tiles tiles of 32 rows and, with acts_slab, keeps every
    step's gate activations in a (T, B, 4H) slab."""
    F, H = feats.shape[2], h0.shape[1]
    check_fma_encoder_kernel_shape(feats, w_enc, H)
    tc = backward_design(fn, cdt) == 'tc'
    # lstm_archive.cu archive_smem: dgates tiles, a weight chunk, W_enc,
    # feats_t
    shared = 4 * (row_tiles * 4 * H * ROWS_PER_BLOCK + 16 * 4 * H
        + F * (H + ROWS_PER_BLOCK))
    if not tc and shared > MAX_SHARED_BYTES:
        raise ValueError(f'{fn} needs {shared} bytes of shared memory at '
            f'hidden size {H} with {F} features, above a block\'s '
            f'{MAX_SHARED_BYTES}')
    return lstm_enc.launch_backward(KERNEL, fn, feats, h0, c0, w_enc, b_enc,
        w_ih, w_hh, b, outs, cseq, g_outs, g_hT, g_cT, cdt, tc, phases,
        fma_rows=row_tiles * ROWS_PER_BLOCK, acts_slab=acts_slab)


class _EncVariantScan(torch.autograd.Function):

    @staticmethod
    def forward(ctx, variant, feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b,
            cdt, save_cseq):
        check_encoder_inputs(feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b, cdt)
        fn = variant.forward_plain if feats.device.type == 'cpu' \
            else variant.forward_launch
        outs, hT, cT, cseq = fn(feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b,
            cdt, save_cseq)
        ctx.save_for_backward(feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b,
            outs, cseq)
        ctx.variant, ctx.cdt = variant, cdt
        return outs, hT, cT

    @staticmethod
    def backward(ctx, g_outs, g_hT, g_cT):
        saved = ctx.saved_tensors
        outs = saved[8]
        args = (*saved, *backward_inputs(outs, g_outs, g_hT, g_cT), ctx.cdt)
        if saved[0].device.type == 'cpu':
            grads = ctx.variant.backward_plain(*args)
        else:
            grads = ctx.variant.backward_launch(*args)
        # the feats cotangent is zero by contract
        dfeats = torch.zeros_like(saved[0]) if ctx.needs_input_grad[1] \
            else None
        return (None, dfeats, *grads, None, None)


def scan_enc_variant(variant, feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b,
        cdt):
    """Encoder + LSTM over feats (T, B, F) in cdt from (h0, c0) -> (outs
    (T, B, H) in cdt, hT, cT (B, H) float32) through `variant`.
    Differentiable in every input but feats, whose gradient is zero by
    contract. A call none of whose inputs requires a gradient keeps no
    cell sequence."""
    return _EncVariantScan.apply(variant, feats, h0, c0, w_enc, b_enc, w_ih,
        w_hh, b, cdt, needs_cseq(feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b))
