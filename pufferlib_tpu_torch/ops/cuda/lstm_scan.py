"""LSTM time scans with the input projection kept apart from the recurrent
sum, through csrc/lstm_scan.cu.

Replaces pufferlib_tpu/ops/pallas/lstm.py:

- lstm_scan (forward `_lstm_fwd_impl`/`_fwd_kernel` and
  `_fwd_kernel_noresid`, backward `_lstm_scan_bwd`/`_bwd_kernel`): the
  projection x_proj = x @ W_ih + b is computed outside and only h @ W_hh
  recurs,

      gates = x_proj_t (f32) + h @ W_hh           (f32 accumulation)

  x_proj (T, B, 4H) is float32 or bfloat16 whatever the compute dtype
  cdt. The backward writes dx_proj = dgates in x_proj's dtype, and
  contracts dgates rounded to cdt: dh_prev = dg @ W_hh^T, dW_hh =
  h_prev^T dg.
- lstm_scan_fused (`_lstm_fused_impl`/`_fwd_fused_kernel` and `_noresid`,
  `_lstm_fused_bwd`/`_bwd_fused_kernel`): the projection runs inside each
  step as its own f32 product,

      gates = (x_t @ W_ih + b) + h @ W_hh         (two sums, then added)

  where lstm_cat.py's combined operand makes one sum over K = D + H. x
  (T, B, D) is in cdt. The backward is the cat kernel's with that gate
  recompute: dx in x's dtype, dW_ih, dW_hh, and db from the unrounded
  dgates.

Gate order, rounding points and the saved outs/cseq are lstm_cat.py's.
On the card both pairs in bf16 run csrc/lstm_tc.cuh's tensor-core
kernels, W_hh held in shared memory by the recurrent loops: lstm_scan
(mode XP) a forward loop that reads x_proj itself and a reverse loop that
recomputes each step's gates from x_proj and the stored outs, so that
neither writes a slab (SCAN_FORWARD_PHASES, SCAN_BACKWARD_PHASES);
lstm_scan_fused (mode FUSED) the projections as GEMMs over all T*B rows
with f32 scratch slabs, at any input width D that is a multiple of 8 up
to lstm_common.tc_max_input(H). In f32 (exact: every product an f32 FMA,
no TF32), which takes D == H, both pairs run csrc/lstm_f32.cuh (design
'cluster'). lstm_scan's forward is lstm_scan_fused's forward loop with
x_proj (f32 or bf16) as its slab and no SGEMM: W_hh on chip for all T
steps in a thread block cluster, each step's h @ W_hh summed from zero
and x_proj_t added after it (the TPU kernel's order), no scratch. Its
backward (SCAN_F32_BACKWARD_PHASES) computes every step's gates at once
as an FMA SGEMM, h_prev @ W_hh from zero with x_proj added in its
epilogue, the activations written where the f32 dgates go (dx_proj, or
with bf16 x_proj an f32 scratch rounded into dx_proj after the loop),
then a reverse loop on thread block clusters that writes the dgates over
them, then dW_hh as a split-K SGEMM; its scratch is W_hh^T and the
split-K's partials, no slab. lstm_scan_fused's
pair is lstm_scan_cat's f32 design with fused's two sums:
xw = x @ W_ih + b as one FMA SGEMM over all T*B rows, the bias in its
epilogue, then time loops that keep W_hh on chip for all T steps in a
thread block cluster, each step's h @ W_hh summed from zero and the slab
added after it (the TPU kernel's two sums in their order). The
forward returns its slab (T * B * 4H f32, 268 MB at T 16, B 8192, H 128),
which the autograd Function keeps for the backward: the backward's gates
are h_prev @ W_hh plus the slab, the activations in that SGEMM's
epilogue, then a reverse loop on the clusters, dx and the split-K weight
gradients as SGEMMs. design(fn, cdt) says which design a C function runs;
f32_plan and f32_usage give the f32 loops' tilings and the kernels'
registers.
A call none of whose inputs requires a gradient writes no cell sequence
(the TPU package's `_noresid` kernels); on the card the forward kernel is
then handed a null cseq.

The *_reference functions are the plain versions: explicit PyTorch that
follows the TPU kernels' math and rounding points (not autograd of the
forward). The autograd.Functions run them for tensors on the CPU; for
CUDA tensors they launch the kernels or raise.
"""
import torch

from pufferlib_tpu_torch.ops.cuda._build import (
    CudaKernel, I, P, ptr, ptr_or_null, stream_handle)
from pufferlib_tpu_torch.ops.cuda.lstm_common import (
    BACKWARD_PHASES, F32_KERNELS, FORWARD_PHASES, SCAN_BACKWARD_PHASES,
    SCAN_F32_BACKWARD_PHASES, SCAN_FORWARD_PHASES, backward_inputs,
    cell_backward_step, check_cell_inputs, check_cell_kernel_shape,
    check_scan_inputs, f32_plan_of, f32_usage_of, forward_outputs,
    gate_activations, launch_cell_backward, launch_cell_forward, needs_cseq,
    round_to, scan_backward_scratch, scan_cells)

__all__ = ['lstm_scan', 'lstm_scan_fused', 'lstm_scan_reference',
    'lstm_scan_backward_reference', 'lstm_scan_fused_reference',
    'lstm_scan_fused_backward_reference', 'KERNEL']

KERNEL = CudaKernel('lstm_scan.cu', {
    'lstm_scan_forward': [P] * 9 + [I] * 6 + [P],
    'lstm_scan_backward': [P] * 16 + [I] * 7 + [P],
    'lstm_fused_forward': [P] * 12 + [I] * 6 + [P],
    'lstm_fused_backward': [P] * 21 + [I] * 8 + [P],
    # not a launch: the bf16 kernels' registers and spills
    'lstm_fused_tc_usage': [I, P],
    'lstm_scan_tc_usage': [I, P],
    # not launches: fused's f32 kernels' registers and spills, and the
    # tilings its f32 loops take at a batch size
    'lstm_fused_f32_usage': [I, P],
    'lstm_fused_f32_plan': [I, I, P],
})
# the C functions that launch kernels, all of which run csrc/lstm_f32.cuh
# in f32
F32_FUNCTIONS = ('lstm_scan_forward', 'lstm_scan_backward',
    'lstm_fused_forward', 'lstm_fused_backward')


def design(fn, cdt):
    """The design the C function `fn` of KERNEL runs in cdt: 'tc'
    (csrc/lstm_tc.cuh's tensor-core kernels, every one in bf16) or
    'cluster' (csrc/lstm_f32.cuh: every one in f32)."""
    if fn not in F32_FUNCTIONS:
        raise ValueError(f'{fn} is not a launch of {KERNEL.source}')
    return 'tc' if cdt == torch.bfloat16 else 'cluster'


def f32_usage(H):
    """Registers and spilled bytes per thread of lstm_scan_fused's f32
    kernels at hidden size H: {kernel: (registers, bytes)} (the card
    only)."""
    return f32_usage_of(KERNEL, 'lstm_fused_f32_usage', H, F32_KERNELS)


def f32_plan(H, B):
    """The tilings lstm_scan_fused's f32 loops take at B rows on this
    card: {'forward' | 'backward': (units a block, rows a thread, clusters
    the card holds at once)} (the card only)."""
    return f32_plan_of(KERNEL, 'lstm_fused_f32_plan', H, B)


def lstm_scan_reference(x_proj, h0, c0, w_hh, cdt=torch.bfloat16,
        save_cseq=True):
    """Plain forward: (outs, hT, cT, cseq); cseq None without save_cseq."""
    w = round_to(w_hh, cdt)
    return scan_cells(lambda t, h: x_proj[t].float() + h @ w,
        x_proj.shape[0], h0, c0, cdt, save_cseq)


def lstm_scan_backward_reference(x_proj, h0, c0, w_hh, outs, cseq, g_outs,
        g_hT, g_cT, cdt=torch.bfloat16):
    """Plain backward, step by step as lstm._bwd_kernel: (dx_proj, dh0,
    dc0, dW_hh)."""
    T = x_proj.shape[0]
    H = h0.shape[-1]
    w = round_to(w_hh, cdt)
    dxp = torch.empty_like(x_proj)
    dw = torch.zeros_like(w)
    dh, dc = g_hT.float(), g_cT.float()
    for t in reversed(range(T)):
        h_prev = round_to(h0 if t == 0 else outs[t - 1], cdt)
        c_prev = c0.float() if t == 0 else cseq[t - 1].float()
        acts = gate_activations(x_proj[t].float() + h_prev @ w, H)
        dgates, dc = cell_backward_step(acts, dh + g_outs[t].float(), dc,
            cseq[t].float(), c_prev)
        dxp[t] = dgates.to(x_proj.dtype)
        dgates_c = round_to(dgates, cdt)
        dh = dgates_c @ w.t()
        dw += h_prev.t() @ dgates_c
    return dxp, dh, dc, dw


def lstm_scan_fused_reference(x, h0, c0, w_ih, w_hh, b, cdt=torch.bfloat16,
        save_cseq=True):
    """Plain forward: (outs, hT, cT, cseq); cseq None without save_cseq."""
    xc = round_to(x, cdt)
    wi, wh = round_to(w_ih, cdt), round_to(w_hh, cdt)
    bias = b.float()
    return scan_cells(lambda t, h: (xc[t] @ wi + bias) + h @ wh,
        x.shape[0], h0, c0, cdt, save_cseq)


def lstm_scan_fused_backward_reference(x, h0, c0, w_ih, w_hh, b, outs, cseq,
        g_outs, g_hT, g_cT, cdt=torch.bfloat16):
    """Plain backward, step by step as lstm._bwd_fused_kernel: (dx, dh0,
    dc0, dW_ih, dW_hh, db)."""
    T = x.shape[0]
    H = h0.shape[-1]
    wi, wh = round_to(w_ih, cdt), round_to(w_hh, cdt)
    bias = b.float()
    dx = torch.empty_like(x)
    dwi, dwh = torch.zeros_like(wi), torch.zeros_like(wh)
    db = torch.zeros_like(bias)
    dh, dc = g_hT.float(), g_cT.float()
    for t in reversed(range(T)):
        x_t = round_to(x[t], cdt)
        h_prev = round_to(h0 if t == 0 else outs[t - 1], cdt)
        c_prev = c0.float() if t == 0 else cseq[t - 1].float()
        acts = gate_activations((x_t @ wi + bias) + h_prev @ wh, H)
        dgates, dc = cell_backward_step(acts, dh + g_outs[t].float(), dc,
            cseq[t].float(), c_prev)
        dgates_c = round_to(dgates, cdt)
        dx[t] = (dgates_c @ wi.t()).to(x.dtype)
        dwi += x_t.t() @ dgates_c
        db += dgates.sum(dim=0)
        dh = dgates_c @ wh.t()
        dwh += h_prev.t() @ dgates_c
    return dx, dh, dc, dwi, dwh, db


def _launch_scan_forward(x_proj, h0, c0, w_hh, cdt, save_cseq=True,
        phases=SCAN_FORWARD_PHASES):
    T, B, _ = x_proj.shape
    H = h0.shape[1]
    check_cell_kernel_shape(H, H, cdt, x_proj.device)
    outs, hT, cT, cseq = forward_outputs(T, h0, c0, cdt, save_cseq)
    if B > 0:
        tc = cdt == torch.bfloat16
        # bf16 scratch: W_hh rounded
        w16 = torch.empty((H * 4 * H,), dtype=torch.bfloat16,
            device=x_proj.device) if tc else None
        KERNEL.launch('lstm_scan_forward', ptr(x_proj), ptr(h0), ptr(c0),
            ptr(w_hh), ptr(outs), ptr_or_null(cseq), ptr(hT), ptr(cT),
            ptr_or_null(w16), T, B, H, int(tc),
            int(x_proj.dtype == torch.bfloat16), phases,
            stream_handle(x_proj))
    return outs, hT, cT, cseq


def _launch_scan_backward(x_proj, h0, c0, w_hh, outs, cseq, g_outs, g_hT,
        g_cT, cdt, phases=None):
    """lstm_scan_backward: (dx_proj, dh0, dc0, dW_hh). phases: the whole
    backward when None (SCAN_BACKWARD_PHASES in bf16,
    SCAN_F32_BACKWARD_PHASES in f32), else its first `phases` phases."""
    T, B, G = x_proj.shape
    H = h0.shape[1]
    check_cell_kernel_shape(H, H, cdt, x_proj.device)
    dev = x_proj.device
    dxp = torch.empty_like(x_proj)
    dh0 = torch.empty_like(h0)
    dc0 = torch.empty_like(c0)
    dw = torch.empty((H, G), dtype=torch.float32, device=dev)
    if B == 0:
        return dxp, dh0, dc0, dw.zero_()
    tc = cdt == torch.bfloat16
    if phases is None:
        phases = SCAN_BACKWARD_PHASES if tc else SCAN_F32_BACKWARD_PHASES
    splits, dg, dw_part, w16 = scan_backward_scratch(T, B, H, cdt,
        x_proj.dtype, dev)
    KERNEL.launch('lstm_scan_backward', ptr(x_proj), ptr(h0), ptr(c0),
        ptr(w_hh), ptr(outs), ptr(cseq), ptr(g_outs), ptr(g_hT), ptr(g_cT),
        ptr(dxp), ptr(dh0), ptr(dc0), ptr(dw), ptr_or_null(dg),
        ptr(dw_part), ptr(w16), T, B, H, int(tc),
        int(x_proj.dtype == torch.bfloat16), splits, phases,
        stream_handle(x_proj))
    return dxp, dh0, dc0, dw


def _launch_fused_forward(x, h0, c0, w_ih, w_hh, b, cdt, save_cseq=True,
        phases=FORWARD_PHASES):
    """lstm_fused_forward: (outs, hT, cT, cseq, xw), xw in f32 the x @ W_ih
    + b slab that _launch_fused_backward takes (None in bf16)."""
    T, B, _ = x.shape
    xw = torch.empty((T * B * 4 * h0.shape[1],), dtype=torch.float32,
        device=x.device) \
        if design('lstm_fused_forward', cdt) == 'cluster' else None
    return (*launch_cell_forward(KERNEL, 'lstm_fused_forward', x, h0, c0,
        w_ih, w_hh, b, cdt, save_cseq, phases, xw), xw)


def _launch_fused_backward(x, h0, c0, w_ih, w_hh, b, outs, cseq, g_outs,
        g_hT, g_cT, cdt, xw=None, phases=BACKWARD_PHASES):
    """lstm_fused_backward from its forward's outs, cseq and, in f32, xw:
    (dx, dh0, dc0, dW_ih, dW_hh, db)."""
    if design('lstm_fused_backward', cdt) == 'cluster' and xw is None:
        raise ValueError("lstm_fused_backward in float32 takes its "
            'forward\'s x @ W_ih + b slab (the fifth output of '
            '_launch_fused_forward)')
    return launch_cell_backward(KERNEL, 'lstm_fused_backward', x, h0, c0,
        w_ih, w_hh, b, outs, cseq, g_outs, g_hT, g_cT, cdt, phases, xw)


class _LSTMScan(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x_proj, h0, c0, w_hh, cdt, save_cseq):
        check_scan_inputs(x_proj, h0, c0, w_hh, cdt)
        fn = lstm_scan_reference if x_proj.device.type == 'cpu' \
            else _launch_scan_forward
        outs, hT, cT, cseq = fn(x_proj, h0, c0, w_hh, cdt, save_cseq)
        ctx.save_for_backward(x_proj, h0, c0, w_hh, outs, cseq)
        ctx.cdt = cdt
        return outs, hT, cT

    @staticmethod
    def backward(ctx, g_outs, g_hT, g_cT):
        x_proj, h0, c0, w_hh, outs, cseq = ctx.saved_tensors
        args = (x_proj, h0, c0, w_hh, outs, cseq,
            *backward_inputs(outs, g_outs, g_hT, g_cT), ctx.cdt)
        if x_proj.device.type == 'cpu':
            grads = lstm_scan_backward_reference(*args)
        else:
            grads = _launch_scan_backward(*args)
        return (*grads, None, None)


class _LSTMScanFused(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, h0, c0, w_ih, w_hh, b, cdt, save_cseq):
        check_cell_inputs(x, h0, c0, w_ih, w_hh, b, cdt)
        args = (x, h0, c0, w_ih, w_hh, b, cdt, save_cseq)
        xw = None
        if x.device.type == 'cpu':
            outs, hT, cT, cseq = lstm_scan_fused_reference(*args)
        else:
            # in f32 the backward takes the x @ W_ih + b slab its forward
            # kept
            outs, hT, cT, cseq, xw = _launch_fused_forward(*args)
        ctx.save_for_backward(x, h0, c0, w_ih, w_hh, b, outs, cseq, xw)
        ctx.cdt = cdt
        return outs, hT, cT

    @staticmethod
    def backward(ctx, g_outs, g_hT, g_cT):
        x, h0, c0, w_ih, w_hh, b, outs, cseq, xw = ctx.saved_tensors
        args = (x, h0, c0, w_ih, w_hh, b, outs, cseq,
            *backward_inputs(outs, g_outs, g_hT, g_cT), ctx.cdt)
        if x.device.type == 'cpu':
            grads = lstm_scan_fused_backward_reference(*args)
        else:
            grads = _launch_fused_backward(*args, xw)
        return (*grads, None, None)


def lstm_scan(x_proj, h0, c0, w_hh, cdt=torch.bfloat16):
    """LSTM over the projected inputs x_proj (T, B, 4H), float32 or
    bfloat16, from (h0, c0) -> (outs (T, B, H) in cdt, hT, cT (B, H)
    float32). Differentiable in every input."""
    return _LSTMScan.apply(x_proj, h0, c0, w_hh, cdt,
        needs_cseq(x_proj, h0, c0, w_hh))


def lstm_scan_fused(x, h0, c0, w_ih, w_hh, b, cdt=torch.bfloat16):
    """LSTM over x (T, B, D) in cdt with the projection inside each step,
    from (h0, c0) -> (outs (T, B, H) in cdt, hT, cT (B, H) float32).
    Differentiable in every input."""
    return _LSTMScanFused.apply(x, h0, c0, w_ih, w_hh, b, cdt,
        needs_cseq(x, h0, c0, w_ih, w_hh, b))
