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

Every C function that launches a kernel (F32_FUNCTIONS: enc2's pair,
the other three backwards and tm's two step kernels) has two designs, by
the compute dtype (design). In bf16 all run the tensor-core kernels of
csrc/lstm_tc.cuh ('tc'): tm mode XP's loops (lstm_scan's) one step a
launch; the backwards mode ENC5's path (the encoder, the P pre-pass, a
reverse loop with W_hh in shared memory, dpre and the split-K) with each
variant's roundings: enc2 and enc4 f32 activations and db from the
rounded dgates (enc2's pre-pass rounding its projection), enc3 rounded
activations and db from the unrounded dgates, enc6 enc5's own; enc2's
forward the encoder, its projection as a GEMM and mode XP's loop. In f32,
where every variant's roundings are the identity, all run
csrc/lstm_f32.cuh ('cluster'): enc3's, enc4's and enc6's backwards enc5's
f32 backward as lstm_enc's enc5 runs it (so their gradients are enc5's
bit for bit), enc2's pair enc5's f32 forward and backward with
lstm_scan_fused's two sums (the encoder and the projection x @ W_ih + b
as SGEMMs of their own, then fused's loops), tm's step kernels
lstm_scan's f32 forward and backward one step a launch (its outputs and
gradients lstm_scan's bit for bit). enc3, enc4 and enc6 take the shapes
of enc5's f32 kernels (D == H, at most 128 features, hidden sizes 32, 64
and 128) in both dtypes; enc2 the same in f32, in bf16 the tensor-core
kernels' (lstm_common.encoder_shape_error). Each is refused before any
launch.
"""
import collections

import torch

from pufferlib_tpu_torch.ops.cuda import lstm_enc
from pufferlib_tpu_torch.ops.cuda._build import CudaKernel, I, P
from pufferlib_tpu_torch.ops.cuda.lstm_common import (
    BACKWARD_PHASES, backward_inputs, check_encoder_inputs,
    check_encoder_kernel_shape, check_fma_encoder_kernel_shape, needs_cseq)

_TC_BACKWARD = lstm_enc.KERNEL.functions['lstm_enc_backward']
KERNEL = CudaKernel('lstm_archive.cu', {
    # enc2's forward takes lstm_enc_forward's arguments
    'lstm_enc2_forward': lstm_enc.KERNEL.functions['lstm_enc_forward'],
    'lstm_enc2_backward': _TC_BACKWARD,
    'lstm_enc3_backward': _TC_BACKWARD,
    'lstm_enc4_backward': _TC_BACKWARD,
    'lstm_enc6_backward': _TC_BACKWARD,
    'lstm_tm_step_forward': [P] * 9 + [I] * 6 + [P],
    'lstm_tm_step_backward': [P] * 16 + [I] * 8 + [P],
    # not launches: the registers and spills of the archive's own bf16
    # kernels and of tm's (mode XP's loops, lstm_scan's templates)
    'lstm_archive_tc_usage': [I, P],
    'lstm_tm_tc_usage': [I, P],
})

# the C functions that launch kernels, all of which run csrc/lstm_f32.cuh
# in f32
F32_FUNCTIONS = ('lstm_enc2_forward', 'lstm_enc2_backward',
    'lstm_enc3_backward', 'lstm_enc4_backward', 'lstm_enc6_backward',
    'lstm_tm_step_forward', 'lstm_tm_step_backward')


def design(fn, cdt):
    """The design the C function `fn` of KERNEL runs in cdt: 'tc'
    (csrc/lstm_tc.cuh's tensor-core kernels, every one in bf16) or
    'cluster' (csrc/lstm_f32.cuh, every one in f32: enc5's pair, enc2's
    with two sums, tm's lstm_scan's mode XP forward and backward)."""
    if fn not in KERNEL.functions:
        raise ValueError(f'{fn} is not a C function of {KERNEL.source}')
    if fn not in F32_FUNCTIONS:
        raise ValueError(f'{fn} is not a launch of {KERNEL.source}')
    return 'tc' if cdt == torch.bfloat16 else 'cluster'

# One encoder-fused variant: forward(feats, h0, c0, w_enc, b_enc, w_ih,
# w_hh, b, cdt, save_cseq) -> (outs, hT, cT, cseq) and backward(those
# eight, outs, cseq, g_outs, g_hT, g_cT, cdt) -> the seven gradients, each
# as a plain version and as a kernel launcher
EncVariant = collections.namedtuple('EncVariant',
    'forward_plain forward_launch backward_plain backward_launch')


def launch_tc_backward(fn, feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b, outs,
        cseq, g_outs, g_hT, g_cT, cdt, phases=BACKWARD_PHASES):
    """Launch the encoder-fused backward `fn` of lstm_archive.cu, whose
    arguments are lstm_enc_backward's: (dh0, dc0, dW_enc, db_enc, dW_ih,
    dW_hh, db), in the design that `fn` runs in cdt. 'tc': the tensor-core
    kernels with their scratch, the f32 P slab and the bf16 weights;
    'cluster': enc5's f32 kernels of lstm_f32.cuh with their scratch;
    phases < 4 stops either early, to time a phase. enc2 takes enc5's
    reach in cdt, the others enc5's f32 reach in both dtypes."""
    H = h0.shape[1]
    if fn == 'lstm_enc2_backward':
        check_encoder_kernel_shape(feats, w_enc, H, cdt)
    else:
        check_fma_encoder_kernel_shape(feats, w_enc, H)
    return lstm_enc.launch_backward(KERNEL, fn, feats, h0, c0, w_enc, b_enc,
        w_ih, w_hh, b, outs, cseq, g_outs, g_hT, g_cT, cdt, phases)


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
