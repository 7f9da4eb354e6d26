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
On the card, lstm_scan_fused in bf16 runs csrc/lstm_tc.cuh's tensor-core
kernels (the projections as GEMMs over all T*B rows, W_hh held in shared
memory by the recurrent loops) with f32 scratch slabs of the
projections, at any input width D that is a multiple of 8 up to
lstm_common.tc_max_input(H); in f32, the exact test mode, it runs the FMA
cell kernels of lstm_common.cuh, which take D == H.
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
    BACKWARD_PHASES, FORWARD_PHASES, backward_inputs, cell_backward_step,
    check_cell_inputs, check_kernel_shape, check_scan_inputs,
    forward_outputs, gate_activations, launch_cell_backward,
    launch_cell_forward, needs_cseq, round_to, scan_cells, splitk_splits)

__all__ = ['lstm_scan', 'lstm_scan_fused', 'lstm_scan_reference',
    'lstm_scan_backward_reference', 'lstm_scan_fused_reference',
    'lstm_scan_fused_backward_reference', 'KERNEL']

KERNEL = CudaKernel('lstm_scan.cu', {
    'lstm_scan_forward': [P] * 8 + [I] * 5 + [P],
    'lstm_scan_backward': [P] * 15 + [I] * 6 + [P],
    'lstm_fused_forward': [P] * 12 + [I] * 6 + [P],
    'lstm_fused_backward': [P] * 21 + [I] * 8 + [P],
    # not a launch: the bf16 kernels' registers and spills
    'lstm_fused_tc_usage': [I, P],
})


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


def _launch_scan_forward(x_proj, h0, c0, w_hh, cdt, save_cseq=True):
    T, B, _ = x_proj.shape
    H = h0.shape[1]
    check_kernel_shape(H, H, x_proj.device)
    outs, hT, cT, cseq = forward_outputs(T, h0, c0, cdt, save_cseq)
    if B > 0:
        KERNEL.launch('lstm_scan_forward', ptr(x_proj), ptr(h0), ptr(c0),
            ptr(w_hh), ptr(outs), ptr_or_null(cseq), ptr(hT), ptr(cT), T, B,
            H, int(cdt == torch.bfloat16),
            int(x_proj.dtype == torch.bfloat16), stream_handle(x_proj))
    return outs, hT, cT, cseq


def _launch_scan_backward(x_proj, h0, c0, w_hh, outs, cseq, g_outs, g_hT,
        g_cT, cdt):
    T, B, G = x_proj.shape
    H = h0.shape[1]
    check_kernel_shape(H, H, x_proj.device)
    dev = x_proj.device
    dxp = torch.empty_like(x_proj)
    dh0 = torch.empty_like(h0)
    dc0 = torch.empty_like(c0)
    dw = torch.empty((H, G), dtype=torch.float32, device=dev)
    if B == 0:
        return dxp, dh0, dc0, dw.zero_()
    splits = splitk_splits(H, G, T * B, dev)
    # dx_proj is also the slab of dgates that dW_hh = h_prev^T dg reads,
    # rounded to cdt as it is loaded; bf16 cannot feed an f32 contraction
    separate = x_proj.dtype == torch.bfloat16 and cdt == torch.float32
    dg = torch.empty((T, B, G), dtype=cdt, device=dev) if separate else None
    dw_part = torch.empty((splits, H, G), dtype=torch.float32, device=dev)
    KERNEL.launch('lstm_scan_backward', ptr(x_proj), ptr(h0), ptr(c0),
        ptr(w_hh), ptr(outs), ptr(cseq), ptr(g_outs), ptr(g_hT), ptr(g_cT),
        ptr(dxp), ptr(dh0), ptr(dc0), ptr(dw), ptr_or_null(dg),
        ptr(dw_part), T, B, H, int(cdt == torch.bfloat16),
        int(x_proj.dtype == torch.bfloat16), splits, stream_handle(x_proj))
    return dxp, dh0, dc0, dw


def _launch_fused_forward(x, h0, c0, w_ih, w_hh, b, cdt, save_cseq=True,
        phases=FORWARD_PHASES):
    return launch_cell_forward(KERNEL, 'lstm_fused_forward', x, h0, c0, w_ih,
        w_hh, b, cdt, save_cseq, phases)


def _launch_fused_backward(x, h0, c0, w_ih, w_hh, b, outs, cseq, g_outs,
        g_hT, g_cT, cdt, phases=BACKWARD_PHASES):
    return launch_cell_backward(KERNEL, 'lstm_fused_backward', x, h0, c0,
        w_ih, w_hh, b, outs, cseq, g_outs, g_hT, g_cT, cdt, phases)


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
        fn = lstm_scan_fused_reference if x.device.type == 'cpu' \
            else _launch_fused_forward
        outs, hT, cT, cseq = fn(x, h0, c0, w_ih, w_hh, b, cdt, save_cseq)
        ctx.save_for_backward(x, h0, c0, w_ih, w_hh, b, outs, cseq)
        ctx.cdt = cdt
        return outs, hT, cT

    @staticmethod
    def backward(ctx, g_outs, g_hT, g_cT):
        x, h0, c0, w_ih, w_hh, b, outs, cseq = ctx.saved_tensors
        args = (x, h0, c0, w_ih, w_hh, b, outs, cseq,
            *backward_inputs(outs, g_outs, g_hT, g_cT), ctx.cdt)
        if x.device.type == 'cpu':
            grads = lstm_scan_fused_backward_reference(*args)
        else:
            grads = _launch_fused_backward(*args)
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
