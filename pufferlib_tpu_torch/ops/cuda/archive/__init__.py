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

In bf16 the enc2 and enc4 backwards run the tensor-core kernels of
csrc/lstm_tc.cuh (backward_design): mode ENC5's path (the encoder, the P
pre-pass, a reverse loop with W_hh in shared memory, dpre and the
split-K) with f32 activations and db from the rounded dgates, enc2's
pre-pass rounding its projection. Every other backward, and f32, runs
lstm_archive.cu's FMA kernel. Both designs take the same shapes (D == H,
at most 128 features, hidden sizes 32, 64 and 128), refused before any
launch.
"""
import collections
import math

import torch

from pufferlib_tpu_torch.ops.cuda import lstm_enc
from pufferlib_tpu_torch.ops.cuda._build import (
    CudaKernel, I, P, ptr, ptr_or_null, stream_handle)
from pufferlib_tpu_torch.ops.cuda.lstm_common import (
    BACKWARD_PHASES, ROWS_PER_BLOCK, backward_inputs, check_encoder_inputs,
    check_fma_encoder_kernel_shape, needs_cseq, splitk_splits)

_ENC_BACKWARD = [P] * 27 + [I] * 8 + [P]
_TC_BACKWARD = lstm_enc.KERNEL.functions['lstm_enc_backward']
KERNEL = CudaKernel('lstm_archive.cu', {
    'lstm_enc2_forward': [P] * 12 + [I] * 5 + [P],
    'lstm_enc2_backward': _TC_BACKWARD,
    'lstm_enc3_backward': _ENC_BACKWARD,
    'lstm_enc4_backward': _TC_BACKWARD,
    'lstm_enc6_backward': _ENC_BACKWARD,
    'lstm_tm_step_forward': [P] * 8 + [I] * 6 + [P],
    'lstm_tm_step_backward': [P] * 15 + [I] * 7 + [P],
    # not a launch: the archive's own bf16 kernels' registers and spills
    'lstm_archive_tc_usage': [I, P],
})

# the backwards with a tensor-core design in bf16
TC_BACKWARDS = ('lstm_enc2_backward', 'lstm_enc4_backward')


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
        cseq, g_outs, g_hT, g_cT, cdt, phases=BACKWARD_PHASES):
    """Launch enc2's or enc4's backward `fn` of lstm_archive.cu, whose
    arguments are lstm_enc_backward's: (dh0, dc0, dW_enc, db_enc, dW_ih,
    dW_hh, db). In bf16 the tensor-core kernels (backward_design) with
    their scratch, the f32 P slab and the bf16 weights; in f32 the FMA
    kernel. phases < 4 stops a bf16 call early, to time a phase."""
    check_fma_encoder_kernel_shape(feats, w_enc, h0.shape[1])
    return lstm_enc.launch_backward(KERNEL, fn, feats, h0, c0, w_enc, b_enc,
        w_ih, w_hh, b, outs, cseq, g_outs, g_hT, g_cT, cdt,
        backward_design(fn, cdt) == 'tc', phases)


def launch_enc_backward(fn, feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b, outs,
        cseq, g_outs, g_hT, g_cT, cdt, row_tiles=1, acts_slab=False):
    """Launch enc3's or enc6's backward `fn` of lstm_archive.cu, on FMA in
    both dtypes: (dh0, dc0, dW_enc, db_enc, dW_ih, dW_hh, db). A block
    takes row_tiles tiles of 32 rows; acts_slab: the kernel keeps every
    step's gate activations in a (T, B, 4H) slab."""
    T, B, F = feats.shape
    H = h0.shape[1]
    D, G = H, 4 * H
    check_fma_encoder_kernel_shape(feats, w_enc, H)
    # lstm_archive.cu archive_smem: dgates tiles, a weight chunk, W_enc, feats_t
    shared = 4 * (row_tiles * G * ROWS_PER_BLOCK + 16 * G
        + F * (H + ROWS_PER_BLOCK))
    if shared > MAX_SHARED_BYTES:
        raise ValueError(f'{fn} needs {shared} bytes of shared memory at '
            f'hidden size {H} with {F} features, above a block\'s '
            f'{MAX_SHARED_BYTES}')
    dev = feats.device
    f32 = dict(dtype=torch.float32, device=dev)
    dh0 = torch.empty_like(h0)
    dc0 = torch.empty_like(c0)
    dw_enc = torch.empty((F, D), **f32)
    db_enc = torch.empty((D,), **f32)
    dw = torch.empty((D + H, G), **f32)
    db = torch.empty((G,), **f32)
    if B == 0:
        return (dh0, dc0, dw_enc.zero_(), db_enc.zero_(), dw[:D].zero_(),
            dw[D:].zero_(), db.zero_())
    nblk = math.ceil(B / (row_tiles * ROWS_PER_BLOCK))
    splits_w = splitk_splits(D + H, G, T * B, dev)
    splits_e = splitk_splits(F, D, T * B, dev)
    xs = torch.empty((T, B, D), dtype=cdt, device=dev)
    dpre = torch.empty_like(xs)
    dg = torch.empty((T, B, G), dtype=cdt, device=dev)
    acts = torch.empty_like(dg) if acts_slab else None
    dw_part = torch.empty((splits_w, D + H, G), **f32)
    db_part = torch.empty((nblk, G), **f32)
    dwe_part = torch.empty((splits_e, F, D), **f32)
    dbe_part = torch.empty((nblk, D), **f32)
    KERNEL.launch(fn, ptr(feats), ptr(h0), ptr(c0), ptr(w_enc), ptr(b_enc),
        ptr(w_ih), ptr(w_hh), ptr(b), ptr(outs), ptr(cseq), ptr(g_outs),
        ptr(g_hT), ptr(g_cT), ptr(dh0), ptr(dc0), ptr(dw_enc), ptr(db_enc),
        ptr(dw), ptr(db), ptr(xs), ptr(dpre), ptr(dg), ptr_or_null(acts),
        ptr(dw_part), ptr(db_part), ptr(dwe_part), ptr(dbe_part), T, B, F, H,
        int(cdt == torch.bfloat16), splits_w, splits_e, nblk,
        stream_handle(feats))
    return dh0, dc0, dw_enc, db_enc, dw[:D], dw[D:], db


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
