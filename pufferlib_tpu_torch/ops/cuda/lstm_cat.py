"""LSTM time scan with the encoder outside, through csrc/lstm_cat.cu.

Replaces pufferlib_tpu/ops/pallas/lstm_cat.py (lstm_scan_cat: forward
`_impl`/`_fwd_kernel`, backward `_bwd`/`_bwd_kernel`). Per timestep the
combined-operand cell

    gates = [x_t | h] @ [W_ih; W_hh] + b        (f32 accumulation)
    i, f, g, o = sigmoid, sigmoid, tanh, sigmoid (gate order of torch)
    c = f * c + i * g;  h = o * tanh(c)

with x (T, B, D) in the compute dtype cdt, h0/c0 (B, H) f32, weights in
the JAX (in, out) layout, f32. Rounding points, as the TPU kernel's: the
weights and h round to cdt as matmul operands, h and c are carried in
f32, outs and cseq are stored in cdt. The backward recomputes the gates
step by step from [x_t | h_prev] (h_prev and c_prev read back from the
stored outs and cseq), rounds dgates to cdt for the two contractions
[dx | dh_prev] = dgates @ W^T and dW = [x | h_prev]^T dgates, and sums db
from the unrounded dgates.

On the card the kernels of csrc/lstm_cat.cu run: in bf16 csrc/lstm_tc.cuh's
tensor-core kernels in mode CAT (design 'tc': x @ W_ih as a GEMM over all
T*B rows into an f32 slab, the loop's accumulators starting from it,
h @ W_hh onto them with W_hh held in shared memory, then + b; the gate
recompute, dx and dW as GEMMs around a reverse loop), at any input width
D that is a multiple of 8 up to lstm_common.tc_max_input(H). In f32, the
default compute dtype of both packages and of every config.yaml section
(exact: every product an f32 FMA, no TF32), csrc/lstm_f32.cuh (design
'cluster', enc5's f32 design without the encoder), which takes D == H:
x @ W_ih, the backward's gate recompute, dx = dg @ W_ih^T and the weight
gradients as FMA SGEMMs over all T*B rows, and time loops that keep W_hh
on chip for all T steps in a thread block cluster. Each of the forward's
sums is x over k < D from zero, then h, then b (the TPU kernel's one sum
over K = D + H in order), and it returns its x @ W_ih slab (T * B * 4H
f32, 268 MB at T 16, B 8192, H 128), which the autograd Function keeps:
the backward's gate recompute starts each sum from it and continues over
h_prev @ W_hh alone, with the activations as its epilogue (half the
products of recomputing [x | h_prev] @ [W_ih; W_hh], the same bits).
design(fn, cdt) says which runs; f32_plan and f32_usage give the f32
loops' tilings and the kernels' registers. These resident designs take
hidden sizes 32, 64 and 128, and in f32 also 256 (lstm_common.
CAT_F32_HIDDEN: its loops run clusters of 8 blocks of 32 units, one
tiling; config.yaml's nethack, minihack, nmmo and nmmo3 LSTMs). Every
other shape, at any input width and
any hidden size up to lstm_common.STREAM_MAX_HIDDEN, runs the second
design, csrc/lstm_cat_stream.cu (STREAM_KERNEL), in both dtypes (bf16 on
the tensor cores, f32 on FMA). Its launchers pad a hidden size that is no
multiple of 32 with zero units inside each gate block
(lstm_common.pad_cell) and slice the outputs and gradients back. At few
batch rows its recurrence is one persistent launch whose blocks each hold
a slice of W_hh in shared memory for every step and meet at a barrier a
step, the input products GEMMs over all T*B rows outside it; at many rows
(64-row tiles for at least half the SMs) each block owns whole row tiles
and streams the weights from L2, x @ W_ih folded into the forward loop.
The wrapper picks the design by shape (lstm_common.cat_design) and raises
where neither serves. The same file carries enc5's streamed pair
(lstm_enc.py).

lstm_cat_reference and lstm_cat_backward_reference are the plain
versions: explicit PyTorch that follows the TPU kernels' math and
rounding points (not autograd of the forward). The autograd.Function runs
them for tensors on the CPU; for CUDA tensors it launches the kernels or
raises. chip_smoke.py holds the kernels against them on the card.
"""
import ctypes
import functools

import torch

from pufferlib_tpu_torch.ops.cuda._build import CudaKernel, I, P
from pufferlib_tpu_torch.ops.cuda._build import ptr, ptr_or_null, stream_handle
from pufferlib_tpu_torch.ops.cuda.lstm_common import (
    BACKWARD_PHASES, F32_KERNELS, FORWARD_PHASES, STREAM_ROWS,
    backward_inputs, cat_cell_shape_error, cat_design, cat_shape_error,
    cell_backward_step, check_cell_inputs, f32_plan_of, f32_usage_of,
    forward_outputs,
    gate_activations, launch_cell_backward, launch_cell_forward, pad_cell,
    pad_units, round_to, scan_forward, stream_hidden, stream_shape_error,
    stream_splits, unpad_cell_grads, unpad_units)

__all__ = ['lstm_scan_cat', 'lstm_cat_reference',
    'lstm_cat_backward_reference', 'KERNEL', 'STREAM_KERNEL']

KERNEL = CudaKernel('lstm_cat.cu', {
    'lstm_cat_forward': [P] * 12 + [I] * 6 + [P],
    'lstm_cat_backward': [P] * 21 + [I] * 8 + [P],
    # not a launch: the bf16 kernels' registers and spills
    'lstm_cat_tc_usage': [I, P],
    # not a launch: the widest input lstm_tc.cuh serves at a hidden size
    'lstm_tc_max_input': [I, P],
    # not launches: the f32 kernels' registers and spills, and the tilings
    # the f32 loops take at a batch size
    'lstm_cat_f32_usage': [I, P],
    'lstm_cat_f32_plan': [I, I, P],
})
# the C functions that run csrc/lstm_f32.cuh in f32
F32_FUNCTIONS = ('lstm_cat_forward', 'lstm_cat_backward')
# the second design, for the shapes KERNEL refuses, and enc5's (lstm_enc.py)
STREAM_KERNEL = CudaKernel('lstm_cat_stream.cu', {
    'lstm_cat_stream_forward': [P] * 14 + [I] * 5 + [P],
    'lstm_cat_stream_backward': [P] * 21 + [I] * 6 + [P],
    'lstm_enc_stream_forward': [P] * 17 + [I] * 6 + [P],
    'lstm_enc_stream_backward': [P] * 26 + [I] * 8 + [P],
    # not a launch: the largest hidden size the streamed loops take and
    # the batch rows of their tiles
    'lstm_stream_limits': [I, P],
    # not a launch: the packed weights a call takes on the rows schedule
    'lstm_stream_pack': [I] * 5 + [P],
    # not a launch: the kernels the library has launched so far
    'lstm_stream_kernels': [P],
})


def design(fn, cdt):
    """The design the C function `fn` of KERNEL runs in cdt: 'tc'
    (csrc/lstm_tc.cuh's tensor-core kernels, in bf16) or 'cluster'
    (csrc/lstm_f32.cuh, the pair in f32)."""
    if fn not in F32_FUNCTIONS:
        raise ValueError(f'{fn} is not a launch of {KERNEL.source}')
    return 'tc' if cdt == torch.bfloat16 else 'cluster'


def f32_usage(H):
    """Registers and spilled bytes per thread of the pair's f32 kernels at
    hidden size H: {kernel: (registers, bytes)} (the card only)."""
    return f32_usage_of(KERNEL, 'lstm_cat_f32_usage', H, F32_KERNELS)


def f32_plan(H, B):
    """The tilings the pair's f32 loops take at B rows on this card:
    {'forward' | 'backward': (units a block, rows a thread, clusters the
    card holds at once)} (the card only)."""
    return f32_plan_of(KERNEL, 'lstm_cat_f32_plan', H, B)


def lstm_cat_reference(x, h0, c0, w_ih, w_hh, b, cdt=torch.bfloat16):
    """Plain forward: (outs, hT, cT, cseq)."""
    return scan_forward(round_to(x, cdt), h0, c0,
        torch.cat([w_ih, w_hh], dim=0), b, cdt)


def lstm_cat_backward_reference(x, h0, c0, w_ih, w_hh, b, outs, cseq,
        g_outs, g_hT, g_cT, cdt=torch.bfloat16):
    """Plain backward, step by step as lstm_cat._bwd_kernel:
    (dx, dh0, dc0, dW_ih, dW_hh, db)."""
    T, B, D = x.shape
    H = h0.shape[-1]
    w = round_to(torch.cat([w_ih, w_hh], dim=0), cdt)
    bias = b.float()
    dx = torch.empty_like(x)
    dw = torch.zeros_like(w)
    db = torch.zeros_like(bias)
    dh, dc = g_hT.float(), g_cT.float()
    for t in reversed(range(T)):
        h_prev = h0.float() if t == 0 else outs[t - 1].float()
        c_prev = c0.float() if t == 0 else cseq[t - 1].float()
        xh = torch.cat([round_to(x[t], cdt), round_to(h_prev, cdt)], dim=-1)
        acts = gate_activations(xh @ w + bias, H)
        dgates, dc = cell_backward_step(acts, dh + g_outs[t].float(), dc,
            cseq[t].float(), c_prev)
        dgates_c = round_to(dgates, cdt)
        dxh = dgates_c @ w.t()
        dx[t] = dxh[:, :D].to(x.dtype)
        dh = dxh[:, D:]
        dw += xh.t() @ dgates_c
        db += dgates.sum(dim=0)
    return dx, dh, dc, dw[:D], dw[D:], db


def _launch_forward(x, h0, c0, w_ih, w_hh, b, cdt, phases=FORWARD_PHASES):
    """lstm_cat_forward: (outs, hT, cT, cseq, xw), xw in f32 the x @ W_ih
    slab that _launch_backward takes (None in bf16)."""
    T, B, _ = x.shape
    xw = torch.empty((T * B * 4 * h0.shape[1],), dtype=torch.float32,
        device=x.device) if design('lstm_cat_forward', cdt) == 'cluster' \
        else None
    return (*launch_cell_forward(KERNEL, 'lstm_cat_forward', x, h0, c0,
        w_ih, w_hh, b, cdt, True, phases, xw, cat_cell_shape_error), xw)


def _launch_backward(x, h0, c0, w_ih, w_hh, b, outs, cseq, g_outs, g_hT,
        g_cT, cdt, xw=None, phases=BACKWARD_PHASES):
    """lstm_cat_backward from its forward's outs, cseq and, in f32, xw:
    (dx, dh0, dc0, dW_ih, dW_hh, db)."""
    if design('lstm_cat_backward', cdt) == 'cluster' and xw is None:
        raise ValueError("lstm_cat_backward in float32 takes its forward's "
            'x @ W_ih slab (the fifth output of _launch_forward)')
    return launch_cell_backward(KERNEL, 'lstm_cat_backward', x, h0, c0, w_ih,
        w_hh, b, outs, cseq, g_outs, g_hT, g_cT, cdt, phases, xw,
        cat_cell_shape_error)


def check_stream(device, D, H, cdt):
    """Raise for a launch of the streamed design that it does not serve."""
    if device.type != 'cuda':
        raise ValueError(f'no LSTM kernel for device {device}')
    err = stream_shape_error(D, H, cdt)
    if err is not None:
        raise ValueError(err)


def stream_forward_scratch(T, B, H, cdt, device):
    """The streamed forward's f32 slab (T*B*4H,), the sums over x that
    the loop leaves as the gates for the backward, and its scratch: h0
    rounded to cdt (B, H) and a barrier counter per row group (at most one
    per tile of STREAM_ROWS rows)."""
    return (torch.empty((T * B * 4 * H,), dtype=torch.float32,
        device=device), torch.empty((B, H), dtype=cdt, device=device),
        stream_counters(B, device))


def stream_counters(B, device):
    return torch.empty((-(-B // STREAM_ROWS),), dtype=torch.int32,
        device=device)


def stream_backward_scratch(T, B, D, H, cdt, device):
    """The streamed backward's scratch: the dgates (T, B, 4H) in cdt, a
    row of db partial sums per step and tile, the split count of dW and its
    partial sums (None for one split), and the barrier counters."""
    G = 4 * H
    f32 = dict(dtype=torch.float32, device=device)
    splits = stream_splits(D + H, G, T * B, device)
    return (torch.empty((T, B, G), dtype=cdt, device=device),
        torch.empty((T * -(-B // STREAM_ROWS), G), **f32), splits,
        torch.empty((splits, D + H, G), **f32) if splits > 1 else None,
        stream_counters(B, device))


def stream_pack(B, D, H, cdt, forward, device):
    """The packed weights in cdt that a streamed forward (or backward)
    call at (B, D, H) takes on its rows schedule (lstm_stream_pack), or
    None where it takes the units schedule."""
    n = _pack_elems(B, D, H, cdt == torch.bfloat16, forward,
        torch.device(device).index or 0)
    return torch.empty((n,), dtype=cdt, device=device) if n else None


@functools.lru_cache(maxsize=None)
def _pack_elems(B, D, H, bf16, forward, device_index):
    """lstm_stream_pack's answer, asked once for each shape and card (the
    host work before a launch is part of a short call's time)."""
    out = (ctypes.c_longlong * 1)()
    with torch.cuda.device(device_index):
        STREAM_KERNEL.lib().lstm_stream_pack(B, D, H, int(bf16),
            int(forward), out)
    return out[0]


def _launch_stream_forward(x, h0, c0, w_ih, w_hh, b, cdt, save_cseq=True):
    """The streamed design's forward (lstm_cat_stream_forward, two or
    three kernels): (outs, hT, cT, cseq, gates), gates the f32 slab of
    every step's gate activations, at the padded hidden size
    stream_hidden(H), that _launch_stream_backward takes."""
    T, B, D = x.shape
    H = h0.shape[1]
    check_stream(x.device, D, H, cdt)
    Hp = stream_hidden(H)
    h0, c0 = pad_units(h0, H, Hp), pad_units(c0, H, Hp)
    w_ih, w_hh, b = pad_cell(w_ih, w_hh, b, H, Hp)
    outs, hT, cT, cseq = forward_outputs(T, h0, c0, cdt, save_cseq)
    gates, h_first, count = stream_forward_scratch(T, B, Hp, cdt, x.device)
    if B > 0:
        wpack = stream_pack(B, D, Hp, cdt, True, x.device)
        STREAM_KERNEL.launch('lstm_cat_stream_forward', ptr(x), ptr(h0),
            ptr(c0), ptr(w_ih), ptr(w_hh), ptr(b), ptr(outs),
            ptr_or_null(cseq), ptr(hT), ptr(cT), ptr(gates), ptr(h_first),
            ptr(count), ptr_or_null(wpack), T, B, D, Hp,
            int(cdt == torch.bfloat16), stream_handle(x))
    return (*unpad_outputs(H, outs, hT, cT, cseq), gates)


def unpad_outputs(H, *tensors):
    """A streamed forward's outputs back at hidden size H (None stays)."""
    return tuple(None if t is None else unpad_units(t, H) for t in tensors)


def _launch_stream_backward(x, h0, c0, w_ih, w_hh, b, outs, cseq, g_outs,
        g_hT, g_cT, cdt, gates):
    """The streamed design's backward (lstm_cat_stream_backward, five or
    six kernels) from its forward's outs, cseq and gates: (dx, dh0, dc0,
    dW_ih, dW_hh, db)."""
    T, B, D = x.shape
    H = h0.shape[1]
    dev = x.device
    check_stream(dev, D, H, cdt)
    Hp = stream_hidden(H)
    G = 4 * Hp
    h0, c0, outs, cseq, g_outs, g_hT, g_cT = (pad_units(t, H, Hp)
        for t in (h0, c0, outs, cseq, g_outs, g_hT, g_cT))
    w_ih, w_hh, _ = pad_cell(w_ih, w_hh, b, H, Hp)
    dx = torch.empty_like(x)
    dh0 = torch.empty_like(h0)
    dc0 = torch.empty_like(c0)
    dw = torch.empty((D + Hp, G), dtype=torch.float32, device=dev)
    db = torch.empty((G,), dtype=torch.float32, device=dev)
    if B == 0:
        dw.zero_()
        db.zero_()
    else:
        dg, db_part, splits, dw_part, count = stream_backward_scratch(T, B,
            D, Hp, cdt, dev)
        wpack = stream_pack(B, D, Hp, cdt, False, dev)
        STREAM_KERNEL.launch('lstm_cat_stream_backward', ptr(x), ptr(h0),
            ptr(c0), ptr(w_ih), ptr(w_hh), ptr(outs), ptr(cseq), ptr(gates),
            ptr(g_outs), ptr(g_hT), ptr(g_cT), ptr(dx), ptr(dh0), ptr(dc0),
            ptr(dw), ptr(db), ptr(dg), ptr(db_part), ptr_or_null(dw_part),
            ptr(count), ptr_or_null(wpack), splits, T, B, D, Hp,
            int(cdt == torch.bfloat16), stream_handle(x))
    return (dx, *unpad_outputs(H, dh0, dc0),
        *unpad_cell_grads(dw[:D], dw[D:], db, H))


def stream_limits(cdt):
    """(largest hidden size, batch rows of a loop tile) of the streamed
    loops in cdt, from the built library (lstm_stream_limits):
    lstm_common.STREAM_MAX_HIDDEN[cdt] and STREAM_ROWS must equal them."""
    out = (ctypes.c_int * 2)()
    STREAM_KERNEL.lib().lstm_stream_limits(int(cdt == torch.bfloat16), out)
    return out[0], out[1]


def kept_for_backward(forward, backward):
    """A pair's launchers whose forward returns a fifth output, what it
    keeps for its backward, which the backward takes after the compute
    dtype (the streamed pairs' gates, this module's and lstm_enc's; the
    f32 slab of the resident cat, x @ W_ih, and of lstm_scan_fused, x @
    W_ih + b), with the other designs' signatures: the forward's fifth
    output goes to the next backward call, as the autograd Functions pass
    it."""
    last = {}

    def fwd(*args, **kwargs):
        *out, last['kept'] = forward(*args, **kwargs)
        return tuple(out)

    def bwd(*args, **kwargs):
        return backward(*args, last['kept'], **kwargs)
    return fwd, bwd


def _design(x, h0, cdt):
    """The design that serves x's shape on the card: 'resident' or
    'stream'; raises where neither does."""
    D, H = x.shape[2], h0.shape[1]
    err = cat_shape_error(D, H, cdt)
    if err is not None:
        raise ValueError(err)
    return cat_design(D, H, cdt)


class _LSTMCat(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, h0, c0, w_ih, w_hh, b, cdt):
        check_cell_inputs(x, h0, c0, w_ih, w_hh, b, cdt)
        args = (x, h0, c0, w_ih, w_hh, b, cdt)
        gates = None
        if x.device.type == 'cpu':
            outs, hT, cT, cseq = lstm_cat_reference(*args)
            ctx.launch_backward = lstm_cat_backward_reference
        elif _design(x, h0, cdt) == 'resident':
            # in f32 the backward takes the x @ W_ih slab its forward kept
            outs, hT, cT, cseq, gates = _launch_forward(*args)
            ctx.launch_backward = _launch_backward
        else:
            # the streamed backward takes the gates its forward kept
            outs, hT, cT, cseq, gates = _launch_stream_forward(*args)
            ctx.launch_backward = _launch_stream_backward
        ctx.save_for_backward(x, h0, c0, w_ih, w_hh, b, outs, cseq, gates)
        ctx.cdt = cdt
        return outs, hT, cT

    @staticmethod
    def backward(ctx, g_outs, g_hT, g_cT):
        x, h0, c0, w_ih, w_hh, b, outs, cseq, gates = ctx.saved_tensors
        kept = () if gates is None else (gates,)
        grads = ctx.launch_backward(x, h0, c0, w_ih, w_hh, b, outs, cseq,
            *backward_inputs(outs, g_outs, g_hT, g_cT), ctx.cdt, *kept)
        return (*grads, None)


def lstm_scan_cat(x, h0, c0, w_ih, w_hh, b, cdt=torch.bfloat16):
    """LSTM over x (T, B, D) in cdt from (h0, c0) -> (outs (T, B, H) in
    cdt, hT, cT (B, H) float32). Differentiable in every input."""
    return _LSTMCat.apply(x, h0, c0, w_ih, w_hh, b, cdt)
