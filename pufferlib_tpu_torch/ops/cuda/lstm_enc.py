"""Encoder-fused LSTM time scans (enc5 and enc), through csrc/lstm_enc.cu.

Replaces three TPU kernels of pufferlib_tpu/ops/pallas/:
- the forward of lstm_enc5.lstm_scan_enc5 and of lstm_enc.lstm_scan_enc,
  which is lstm_enc._impl / lstm_enc._fwd_kernel: per step the encoder

      x_t = relu(feats_t @ W_enc + b_enc)    rounded to cdt

  feeds the combined-operand cell of lstm_cat.py;
- its backward, lstm_enc5._hoisted_bwd / _bwd_kernel: the gate
  activations recomputed from [x | h_prev] and stored in cdt, the
  reverse dh/dc chain with dgates rounded to cdt and
  dh_prev = dgates @ W_hh^T, then dW_ih = x^T dg, dW_hh = h_prev^T dg,
  db = sum(dg), dx = dg @ W_ih^T, the relu mask, dW_enc = feats^T dpre
  and db_enc = sum(dpre), with dpre rounded to cdt;
- the backward of lstm_scan_enc, lstm_enc._bwd / _bwd_kernel, which
  recomputes the gates step by step inside the reverse loop and keeps
  their activations in f32 (enc5 rounds them to cdt, where its TPU kernel
  stores them in a slab), carries dW and db through the loop, db from the
  unrounded dgates (enc5 sums the rounded ones), and ends with the same
  relu mask, dW_enc and db_enc. The two backwards are the same function
  in f32 (on the card, the same kernels and the same bits) and differ in
  bf16.

feats (T, B, F) is in the compute dtype cdt; the feats cotangent is zero
by contract (observations are constants in RL training; the caller
detaches them), as the JAX kernel's is.

On the card, in bf16, the enc5 pair runs csrc/lstm_tc.cuh in mode ENC5:
the encoder as one GEMM over all T*B rows into a (T, B, D) bf16 buffer,
then cat's tensor-core forward on it; the backward recomputes that buffer
with the same encoder, runs the gate recompute, dpre and the weight
gradients as GEMMs around a reverse loop that keeps only dg_t @ W_hh^T.
lstm_scan_enc's step backward runs the same kernels in mode ENC, whose
reverse loop keeps the activations in f32 and sums db from the unrounded
dgates (its TPU kernel's recompute and dW inside the loop become the
pre-pass and the split-K). Both take any encoder width D that is a
multiple of 8 up to lstm_common.tc_max_input(H), and up to
lstm_common.tc_max_features() features.

In f32, the default compute dtype of both packages and of every
config.yaml section, the enc5 pair runs csrc/lstm_f32.cuh (design
'cluster'): the encoder, x @ W_ih, the backward's gate recompute, dpre
and the weight gradients as FMA SGEMMs over all T*B rows, and time loops
that keep W_hh on chip for all T steps in a thread block cluster (no
TF32: every product is an f32 FMA). Each of the forward's sums is x over
k < D from zero, then h, then b: the TPU kernel's one sum over K = D + H
in order. lstm_scan_enc's forward and the archived enc3, enc4 and enc6
forwards run the same C function. lstm_scan_enc's step backward, whose
roundings are the identity in f32, runs enc5's f32 backward too, so its
gradients are enc5's bit for bit. All take D == H and at most
KERNEL_MAX_FEATURES features.

Every other enc5 shape with a hidden size up to
lstm_common.STREAM_MAX_HIDDEN (padded to a multiple of 32 with zero
units, as cat's streamed launchers do), at any F and D, in both dtypes,
runs enc5's streamed pair in csrc/lstm_cat_stream.cu (lstm_enc_stream_forward
/ lstm_enc_stream_backward): the encoder as a GEMM over all T*B rows with
a bias + relu + round epilogue, then cat's streamed forward on its
output; the backward recomputes it, runs cat's streamed backward in enc5
mode (the activations rounded to cdt, db from the rounded dgates), then
dpre = round(relu-mask(dx)), dW_enc and db_enc as [feats | 1]^T dpre.
lstm_scan_enc5 picks the design by shape (lstm_common.enc5_design).

lstm_enc_reference, lstm_enc_backward_reference and
lstm_scan_enc_backward_reference are the plain versions: explicit PyTorch
that follows the TPU kernels' math and rounding points. The
autograd.Functions run them for tensors on the CPU; for CUDA tensors they
launch the kernels or raise.
"""
import math

import torch

from pufferlib_tpu_torch.ops.cuda._build import (
    CudaKernel, I, P, ptr, ptr_or_null, stream_handle)
from pufferlib_tpu_torch.ops.cuda.lstm_common import (
    BACKWARD_PHASES, F32_ENCODER_KERNELS, F32_KERNELS, F32_SPLIT_ROWS,
    FORWARD_PHASES, KERNEL_MAX_FEATURES, ROWS_PER_BLOCK, TC_ROWS_PER_BLOCK,
    backward_inputs, cell_backward_step, check_encoder_inputs,
    check_encoder_kernel_shape, check_fma_encoder_kernel_shape, encode,
    enc5_design, enc5_shape_error, f32_plan_of, f32_usage_of,
    forward_outputs, gate_activations, h_prev_rows, needs_cseq, pad_cell,
    pad_units, round_to, scan_forward, splitk_splits, stream_hidden,
    stream_splits, tc_slab, unpad_cell_grads)
from pufferlib_tpu_torch.ops.cuda.lstm_cat import (
    STREAM_KERNEL, check_stream, stream_backward_scratch,
    stream_forward_scratch, stream_pack, unpad_outputs)

__all__ = ['lstm_scan_enc5', 'lstm_scan_enc', 'lstm_enc_reference',
    'lstm_enc_backward_reference', 'lstm_scan_enc_backward_reference',
    'encode', 'KERNEL', 'KERNEL_MAX_FEATURES']

_BACKWARD = [P] * 27 + [I] * 10 + [P]
KERNEL = CudaKernel('lstm_enc.cu', {
    'lstm_enc_forward': [P] * 15 + [I] * 7 + [P],
    'lstm_enc_backward': _BACKWARD,
    # lstm_scan_enc's step backward takes enc5's backward's arguments
    'lstm_enc_step_backward': _BACKWARD,
    # not a launch: the bf16 kernels' registers and spills
    'lstm_enc_tc_usage': [I, P],
    # not a launch: the widest feature width enc5's bf16 encoder takes
    'lstm_enc_tc_max_features': [P],
    # not launches: enc5's f32 kernels' registers and spills, and the
    # tilings its f32 loops take at a batch size
    'lstm_enc_f32_usage': [I, P],
    'lstm_enc_f32_plan': [I, I, P],
})
# the C functions that run csrc/lstm_f32.cuh in f32: every launch
F32_FUNCTIONS = ('lstm_enc_forward', 'lstm_enc_backward',
    'lstm_enc_step_backward')


def design(fn, cdt):
    """The design the C function `fn` of KERNEL runs in cdt: 'tc'
    (csrc/lstm_tc.cuh's tensor-core kernels, in bf16) or 'cluster'
    (csrc/lstm_f32.cuh in f32: enc5's pair, and the step backward as
    enc5's backward)."""
    if fn not in F32_FUNCTIONS:
        raise ValueError(f'{fn} is not a launch of {KERNEL.source}')
    return 'tc' if cdt == torch.bfloat16 else 'cluster'


def f32_usage(H):
    """Registers and spilled bytes per thread of enc5's f32 kernels at
    hidden size H: {kernel: (registers, bytes)} (the card only)."""
    return f32_usage_of(KERNEL, 'lstm_enc_f32_usage', H,
        F32_KERNELS + F32_ENCODER_KERNELS)


def f32_plan(H, B):
    """The tilings enc5's f32 loops take at B rows on this card:
    {'forward' | 'backward': (units a block, rows a thread, clusters the
    card holds at once)} (the card only)."""
    return f32_plan_of(KERNEL, 'lstm_enc_f32_plan', H, B)


def lstm_enc_reference(feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b,
        cdt=torch.bfloat16, save_cseq=True):
    """Plain forward: (outs, hT, cT, cseq); cseq None without save_cseq."""
    x = round_to(encode(feats, w_enc, b_enc, cdt), cdt)
    return scan_forward(x, h0, c0, torch.cat([w_ih, w_hh], dim=0), b, cdt,
        save_cseq)


def lstm_enc_backward_reference(feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b,
        outs, cseq, g_outs, g_hT, g_cT, cdt=torch.bfloat16):
    """Plain backward, as lstm_enc5._bwd_kernel: (dh0, dc0, dW_enc,
    db_enc, dW_ih, dW_hh, db)."""
    T, B, F = feats.shape
    H = h0.shape[-1]
    D = w_enc.shape[-1]
    w = round_to(torch.cat([w_ih, w_hh], dim=0), cdt)
    feats2 = round_to(feats.reshape(T * B, F), cdt)
    x_all = round_to(encode(feats2, w_enc, b_enc, cdt), cdt)
    hprev_all = h_prev_rows(h0, outs, cdt)
    gates = torch.cat([x_all, hprev_all], dim=-1) @ w + b.float()
    # the activation slab is stored in cdt
    acts = [round_to(a, cdt) for a in gate_activations(gates, H)]
    dg_all = torch.empty((T * B, 4 * H), dtype=torch.float32,
        device=feats.device)
    whh_t = w[D:].t()
    dh, dc = g_hT.float(), g_cT.float()
    for t in reversed(range(T)):
        rows = slice(t * B, (t + 1) * B)
        c_prev = c0.float() if t == 0 else cseq[t - 1].float()
        dgates, dc = cell_backward_step([a[rows] for a in acts],
            dh + g_outs[t].float(), dc, cseq[t].float(), c_prev)
        dgates_c = round_to(dgates, cdt)
        dg_all[rows] = dgates_c
        dh = dgates_c @ whh_t
    dw_ih = x_all.t() @ dg_all
    dw_hh = hprev_all.t() @ dg_all
    db = dg_all.sum(dim=0)
    dx_all = dg_all @ w[:D].t()
    dpre = round_to(torch.where(x_all > 0, dx_all, 0.0), cdt)
    dw_enc = feats2.t() @ dpre
    db_enc = dpre.sum(dim=0)
    return dh, dc, dw_enc, db_enc, dw_ih, dw_hh, db


def lstm_scan_enc_backward_reference(feats, h0, c0, w_enc, b_enc, w_ih,
        w_hh, b, outs, cseq, g_outs, g_hT, g_cT, cdt=torch.bfloat16):
    """Plain backward, step by step as lstm_enc._bwd_kernel: (dh0, dc0,
    dW_enc, db_enc, dW_ih, dW_hh, db)."""
    T, B, F = feats.shape
    H = h0.shape[-1]
    D = w_enc.shape[-1]
    w = round_to(torch.cat([w_ih, w_hh], dim=0), cdt)
    bias = b.float()
    feats2 = round_to(feats.reshape(T * B, F), cdt)
    x_all = round_to(encode(feats2, w_enc, b_enc, cdt), cdt)
    dx_all = torch.empty_like(x_all)
    dw = torch.zeros_like(w)
    db = torch.zeros_like(bias)
    dh, dc = g_hT.float(), g_cT.float()
    for t in reversed(range(T)):
        rows = slice(t * B, (t + 1) * B)
        h_prev = h0 if t == 0 else outs[t - 1]
        c_prev = c0.float() if t == 0 else cseq[t - 1].float()
        xh = torch.cat([x_all[rows], round_to(h_prev, cdt)], dim=-1)
        # the activations stay in f32
        acts = gate_activations(xh @ w + bias, H)
        dgates, dc = cell_backward_step(acts, dh + g_outs[t].float(), dc,
            cseq[t].float(), c_prev)
        dgates_c = round_to(dgates, cdt)
        dxh = dgates_c @ w.t()
        dx_all[rows] = round_to(dxh[:, :D], cdt)
        dh = dxh[:, D:]
        dw += xh.t() @ dgates_c
        db += dgates.sum(dim=0)
    dpre = round_to(torch.where(x_all > 0, dx_all, 0.0), cdt)
    dw_enc = feats2.t() @ dpre
    db_enc = dpre.sum(dim=0)
    return dh, dc, dw_enc, db_enc, dw[:D], dw[D:], db


def _launch_forward(feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b, cdt,
        save_cseq=True, phases=FORWARD_PHASES):
    """lstm_enc_forward at enc5's reach (enc5's forward and
    lstm_scan_enc's): (outs, hT, cT, cseq)."""
    check_encoder_kernel_shape(feats, w_enc, h0.shape[1], cdt)
    return launch_forward(KERNEL, 'lstm_enc_forward', feats, h0, c0, w_enc,
        b_enc, w_ih, w_hh, b, cdt, save_cseq, phases, tc_slab)


def launch_forward(kernel, fn, feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b,
        cdt, save_cseq, phases, slab):
    """The forward C function `fn` of `kernel` that takes
    lstm_enc_forward's arguments (enc5's, and the archived enc2's), on a
    shape the caller has checked: (outs, hT, cT, cseq). In bf16 its scratch
    is the encoded inputs, slab(T, B, H, device) (the gate slab the loop
    reads) and the bf16 weights; in f32 (lstm_f32.cuh's forward) the
    encoded inputs and the projection x @ W_ih (enc2's x @ W_ih + b),
    (T * B * 4H)."""
    T, B, F = feats.shape
    H = h0.shape[1]
    D = w_enc.shape[1]
    outs, hT, cT, cseq = forward_outputs(T, h0, c0, cdt, save_cseq)
    if B > 0:
        tc = cdt == torch.bfloat16
        dev = feats.device
        xs = torch.empty((T, B, D), dtype=cdt, device=dev)
        xw = slab(T, B, H, dev) if tc else torch.empty((T * B * 4 * H,),
            dtype=torch.float32, device=dev)
        # [W_ih; W_hh], then W_enc, in bf16
        w16 = torch.empty(((D + H) * 4 * H + F * D,), dtype=torch.bfloat16,
            device=dev) if tc else None
        kernel.launch(fn, ptr(feats), ptr(h0), ptr(c0),
            ptr(w_enc), ptr(b_enc), ptr(w_ih), ptr(w_hh), ptr(b), ptr(outs),
            ptr_or_null(cseq), ptr(hT), ptr(cT), ptr(xs), ptr(xw),
            ptr_or_null(w16), T, B, F, D, H, int(tc), phases,
            stream_handle(feats))
    return outs, hT, cT, cseq


def _launch_enc_forward(feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b, cdt,
        save_cseq=True):
    """The same forward for the archived enc3, enc4 and enc6, which take
    only their backwards' shapes (D == H, at most KERNEL_MAX_FEATURES
    features) in both dtypes."""
    check_fma_encoder_kernel_shape(feats, w_enc, h0.shape[1])
    return _launch_forward(feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b, cdt,
        save_cseq)


def _launch_backward(feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b, outs,
        cseq, g_outs, g_hT, g_cT, cdt, phases=BACKWARD_PHASES):
    """lstm_enc_backward, enc5's: (dh0, dc0, dW_enc, db_enc, dW_ih, dW_hh,
    db)."""
    check_encoder_kernel_shape(feats, w_enc, h0.shape[1], cdt)
    return launch_backward(KERNEL, 'lstm_enc_backward', feats, h0, c0, w_enc,
        b_enc, w_ih, w_hh, b, outs, cseq, g_outs, g_hT, g_cT, cdt, phases)


def launch_backward(kernel, fn, feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b,
        outs, cseq, g_outs, g_hT, g_cT, cdt, phases=BACKWARD_PHASES):
    """The backward C function `fn` of `kernel` that takes
    lstm_enc_backward's arguments (enc5's, lstm_scan_enc's step backward,
    and the archived enc2's, enc3's, enc4's and enc6's), on a shape the
    caller has checked: (dh0, dc0, dW_enc, db_enc, dW_ih, dW_hh, db). In
    bf16 the tensor-core kernels run (with their scratch: the P slab and
    the bf16 weights); in f32 enc5's kernels of lstm_f32.cuh (their
    scratch: the activations and the transposed weights in the P slab's
    place). Both sum db_enc as row F of [feats | 1]^T dpre."""
    T, B, F = feats.shape
    H = h0.shape[1]
    D = w_enc.shape[1]
    G = 4 * H
    dev = feats.device
    f32 = dict(dtype=torch.float32, device=dev)
    dh0 = torch.empty_like(h0)
    dc0 = torch.empty_like(c0)
    # dW_enc (F, D), then db_enc (D,)
    dwe = torch.empty((F + 1, D), **f32)
    dw = torch.empty((D + H, G), **f32)
    db = torch.empty((G,), **f32)
    if B == 0:
        dwe.zero_()
        return dh0, dc0, dwe[:F], dwe[F], dw[:D].zero_(), dw[D:].zero_(), \
            db.zero_()
    tc = cdt == torch.bfloat16
    min_rows = 1024 if tc else F32_SPLIT_ROWS
    splits_w = splitk_splits(D + H, G, T * B, dev, min_rows)
    splits_e = splitk_splits(F + 1, D, T * B, dev, min_rows)
    xs = torch.empty((T, B, D), dtype=cdt, device=dev)
    dpre = torch.empty_like(xs)
    dg = torch.empty((T, B, G), dtype=cdt, device=dev)
    dw_part = torch.empty((splits_w, D + H, G), **f32)
    # bias partials, a row per block: of 64 batch rows in bf16, 32 in f32
    # (the cluster loops' smallest tile)
    part_rows = math.ceil(B / (TC_ROWS_PER_BLOCK if tc else ROWS_PER_BLOCK))
    db_part = torch.empty((part_rows, G), **f32)
    dwe_part = torch.empty((splits_e, F + 1, D), **f32)
    # bf16: the P slab; [W_ih; W_hh], W_ih^T, h0 and W_enc in bf16. f32:
    # the activations, W_ih^T and W_hh^T
    pre = tc_slab(T, B, H, dev) if tc else torch.empty(
        (T * B * G + G * (D + H),), **f32)
    w16 = torch.empty(((D + H) * G + G * D + B * H + F * D,),
        dtype=torch.bfloat16, device=dev) if tc else None
    kernel.launch(fn, ptr(feats), ptr(h0), ptr(c0),
        ptr(w_enc), ptr(b_enc), ptr(w_ih), ptr(w_hh), ptr(b), ptr(outs),
        ptr(cseq), ptr(g_outs), ptr(g_hT), ptr(g_cT), ptr(dh0), ptr(dc0),
        ptr(dwe), ptr(dw), ptr(db), ptr(xs), ptr(dpre), ptr(dg), ptr(dw_part),
        ptr(db_part), ptr(dwe_part), None, ptr(pre), ptr_or_null(w16), T, B,
        F, D, H, int(tc), splits_w, splits_e, part_rows, phases,
        stream_handle(feats))
    return dh0, dc0, dwe[:F], dwe[F], dw[:D], dw[D:], db


def _launch_step_backward(feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b, outs,
        cseq, g_outs, g_hT, g_cT, cdt, phases=BACKWARD_PHASES):
    """lstm_enc_step_backward, the un-hoisted backward of lstm_scan_enc, at
    enc5's reach: (dh0, dc0, dW_enc, db_enc, dW_ih, dW_hh, db); on the
    tensor cores in bf16, enc5's f32 backward (lstm_f32.cuh) in f32.
    phases < 4 stops a call early, to time a phase."""
    check_encoder_kernel_shape(feats, w_enc, h0.shape[1], cdt)
    return launch_backward(KERNEL, 'lstm_enc_step_backward', feats, h0, c0,
        w_enc, b_enc, w_ih, w_hh, b, outs, cseq, g_outs, g_hT, g_cT, cdt,
        phases)


def _launch_stream_forward(feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b, cdt,
        save_cseq=True):
    """enc5's streamed forward (lstm_enc_stream_forward, three or four
    kernels): (outs, hT, cT, cseq, gates), gates every step's gate
    activations at the padded hidden size stream_hidden(H), for
    _launch_stream_backward. Scratch: the encoded inputs (T, B, D) in cdt
    and the streamed forward's."""
    T, B, F = feats.shape
    H = h0.shape[1]
    D = w_enc.shape[1]
    dev = feats.device
    check_stream(dev, D, H, cdt)
    Hp = stream_hidden(H)
    h0, c0 = pad_units(h0, H, Hp), pad_units(c0, H, Hp)
    w_ih, w_hh, b = pad_cell(w_ih, w_hh, b, H, Hp)
    outs, hT, cT, cseq = forward_outputs(T, h0, c0, cdt, save_cseq)
    gates, h_first, count = stream_forward_scratch(T, B, Hp, cdt, dev)
    if B > 0:
        xs = torch.empty((T, B, D), dtype=cdt, device=dev)
        wpack = stream_pack(B, D, Hp, cdt, True, dev)
        STREAM_KERNEL.launch('lstm_enc_stream_forward', ptr(feats), ptr(h0),
            ptr(c0), ptr(w_enc), ptr(b_enc), ptr(w_ih), ptr(w_hh), ptr(b),
            ptr(outs), ptr_or_null(cseq), ptr(hT), ptr(cT), ptr(xs),
            ptr(gates), ptr(h_first), ptr(count), ptr_or_null(wpack), T, B, F,
            D, Hp, int(cdt == torch.bfloat16), stream_handle(feats))
    return (*unpad_outputs(H, outs, hT, cT, cseq), gates)


def _launch_stream_backward(feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b, outs,
        cseq, g_outs, g_hT, g_cT, cdt, gates):
    """enc5's streamed backward (lstm_enc_stream_backward, seven to nine
    kernels) from its forward's outs, cseq and gates: (dh0, dc0, dW_enc,
    db_enc, dW_ih, dW_hh, db)."""
    T, B, F = feats.shape
    H = h0.shape[1]
    D = w_enc.shape[1]
    dev = feats.device
    check_stream(dev, D, H, cdt)
    Hp = stream_hidden(H)
    G = 4 * Hp
    h0, c0, outs, cseq, g_outs, g_hT, g_cT = (pad_units(t, H, Hp)
        for t in (h0, c0, outs, cseq, g_outs, g_hT, g_cT))
    w_ih, w_hh, _ = pad_cell(w_ih, w_hh, b, H, Hp)
    f32 = dict(dtype=torch.float32, device=dev)
    dh0 = torch.empty_like(h0)
    dc0 = torch.empty_like(c0)
    # dW_enc (F, D), then db_enc (D,)
    dwe = torch.empty((F + 1, D), **f32)
    dw = torch.empty((D + Hp, G), **f32)
    db = torch.empty((G,), **f32)
    if B == 0:
        for t in (dwe, dw, db):
            t.zero_()
    else:
        xs = torch.empty((T, B, D), dtype=cdt, device=dev)
        dpre = torch.empty_like(xs)
        dg, db_part, splits_w, dw_part, count = stream_backward_scratch(T, B,
            D, Hp, cdt, dev)
        splits_e = stream_splits(F + 1, D, T * B, dev)
        dwe_part = torch.empty((splits_e, F + 1, D), **f32) if splits_e > 1 \
            else None
        wpack = stream_pack(B, D, Hp, cdt, False, dev)
        STREAM_KERNEL.launch('lstm_enc_stream_backward', ptr(feats), ptr(h0),
            ptr(c0), ptr(w_enc), ptr(b_enc), ptr(w_ih), ptr(w_hh), ptr(outs),
            ptr(cseq), ptr(gates), ptr(g_outs), ptr(g_hT), ptr(g_cT),
            ptr(dh0), ptr(dc0), ptr(dwe), ptr(dw), ptr(db), ptr(xs),
            ptr(dpre), ptr(dg), ptr(db_part), ptr_or_null(dw_part),
            ptr_or_null(dwe_part), ptr(count), ptr_or_null(wpack), splits_w,
            splits_e, T, B, F, D, Hp, int(cdt == torch.bfloat16),
            stream_handle(feats))
    return (*unpad_outputs(H, dh0, dc0), dwe[:F], dwe[F],
        *unpad_cell_grads(dw[:D], dw[D:], db, H))


def _enc5_design(feats, w_enc, H, cdt):
    """The enc5 design that serves the shape on the card: 'resident' or
    'stream'; raises where neither does."""
    F, D = feats.shape[2], w_enc.shape[1]
    err = enc5_shape_error(F, D, H, cdt)
    if err is not None:
        raise ValueError(err)
    return enc5_design(F, D, H, cdt)


class _LSTMEnc5(torch.autograd.Function):

    @staticmethod
    def forward(ctx, feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b, cdt):
        check_encoder_inputs(feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b, cdt)
        args = (feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b, cdt)
        gates = None
        if feats.device.type == 'cpu':
            outs, hT, cT, cseq = lstm_enc_reference(*args)
            ctx.launch_backward = lstm_enc_backward_reference
        elif _enc5_design(feats, w_enc, h0.shape[1], cdt) == 'resident':
            outs, hT, cT, cseq = _launch_forward(*args)
            ctx.launch_backward = _launch_backward
        else:
            # the streamed backward takes the gates its forward kept
            outs, hT, cT, cseq, gates = _launch_stream_forward(*args)
            ctx.launch_backward = _launch_stream_backward
        ctx.save_for_backward(feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b,
            outs, cseq, gates)
        ctx.cdt = cdt
        return outs, hT, cT

    @staticmethod
    def backward(ctx, g_outs, g_hT, g_cT):
        *saved, gates = ctx.saved_tensors
        outs = saved[8]
        kept = () if gates is None else (gates,)
        grads = ctx.launch_backward(*saved, *backward_inputs(outs, g_outs,
            g_hT, g_cT), ctx.cdt, *kept)
        # the feats cotangent is zero by contract
        dfeats = torch.zeros_like(saved[0]) if ctx.needs_input_grad[0] \
            else None
        return (dfeats, *grads, None)


def lstm_scan_enc5(feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b,
        cdt=torch.bfloat16):
    """Encoder + LSTM over feats (T, B, F) in cdt from (h0, c0) ->
    (outs (T, B, H) in cdt, hT, cT (B, H) float32). Differentiable in
    every input but feats, whose gradient is zero by contract."""
    return _LSTMEnc5.apply(feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b, cdt)


class _LSTMEnc(torch.autograd.Function):

    @staticmethod
    def forward(ctx, feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b, cdt,
            save_cseq):
        check_encoder_inputs(feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b, cdt)
        fn = lstm_enc_reference if feats.device.type == 'cpu' \
            else _launch_forward
        outs, hT, cT, cseq = fn(feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b,
            cdt, save_cseq)
        ctx.save_for_backward(feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b,
            outs, cseq)
        ctx.cdt = cdt
        return outs, hT, cT

    @staticmethod
    def backward(ctx, g_outs, g_hT, g_cT):
        saved = ctx.saved_tensors
        outs = saved[8]
        args = (*saved, *backward_inputs(outs, g_outs, g_hT, g_cT), ctx.cdt)
        if saved[0].device.type == 'cpu':
            grads = lstm_scan_enc_backward_reference(*args)
        else:
            grads = _launch_step_backward(*args)
        # the feats cotangent is zero by contract
        dfeats = torch.zeros_like(saved[0]) if ctx.needs_input_grad[0] \
            else None
        return (dfeats, *grads, None, None)


def lstm_scan_enc(feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b,
        cdt=torch.bfloat16):
    """lstm_scan_enc5's function with the step-by-step backward of
    pufferlib_tpu's lstm_scan_enc: the same forward, and gradients that
    differ from enc5's in bf16 rounding only (in f32 on the card, equal to
    enc5's). A call none of whose inputs requires a gradient keeps no cell
    sequence."""
    return _LSTMEnc.apply(feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b, cdt,
        needs_cseq(feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b))
