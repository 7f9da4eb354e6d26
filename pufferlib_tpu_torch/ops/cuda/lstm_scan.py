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
projections; in f32, the exact test mode, it runs the FMA cell kernels of
lstm_common.cuh.
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
    backward_inputs, blocks, cell_backward_step, check_cdt,
    check_kernel_shape, check_placement, check_scan_inputs,
    check_state_and_weights, gate_activations, needs_cseq, round_to,
    scan_cells, splitk_splits)

__all__ = ['lstm_scan', 'lstm_scan_fused', 'lstm_scan_reference',
    'lstm_scan_backward_reference', 'lstm_scan_fused_reference',
    'lstm_scan_fused_backward_reference', 'KERNEL']

KERNEL = CudaKernel('lstm_scan.cu', {
    'lstm_scan_forward': [P] * 8 + [I] * 5 + [P],
    'lstm_scan_backward': [P] * 15 + [I] * 6 + [P],
    'lstm_fused_forward': [P] * 12 + [I] * 5 + [P],
    'lstm_fused_backward': [P] * 21 + [I] * 7 + [P],
    # not a launch: the bf16 kernels' registers and spills
    'lstm_fused_tc_usage': [I, P],
})
# batch rows per block of lstm_scan_fused's bf16 loops (lstm_tc.cuh BR)
TC_ROWS_PER_BLOCK = 64
# phases of lstm_fused_forward (pre-pass, loop) and lstm_fused_backward
# (pre-pass, loop, dx, dW + db) in bf16 (csrc/lstm_tc.cuh); a launch runs
# the first `phases` of them: all, except to time a phase
FORWARD_PHASES = 2
BACKWARD_PHASES = 4


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


def _check_fused(x, h0, c0, w_ih, w_hh, b, cdt):
    check_cdt(cdt)
    if x.dim() != 3 or x.dtype != cdt:
        raise ValueError(f'x must be (T, B, D) in {cdt}, got {x.dtype} '
            f'{tuple(x.shape)}')
    T, B, D = x.shape
    if T < 1:
        raise ValueError('x needs at least one timestep')
    check_placement('x', x, x.device)
    return check_state_and_weights(B, D, h0, c0, w_ih, w_hh, b, x.device)


def _forward_outputs(T, h0, c0, cdt, save_cseq):
    outs = torch.empty((T, *h0.shape), dtype=cdt, device=h0.device)
    cseq = torch.empty_like(outs) if save_cseq else None
    return outs, torch.empty_like(h0), torch.empty_like(c0), cseq


def _launch_scan_forward(x_proj, h0, c0, w_hh, cdt, save_cseq=True):
    T, B, _ = x_proj.shape
    H = h0.shape[1]
    check_kernel_shape(H, H, x_proj.device)
    outs, hT, cT, cseq = _forward_outputs(T, h0, c0, cdt, save_cseq)
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


def _slab(T, B, H, device):
    """The f32 slab (XW or P) of lstm_tc.cuh's bf16 kernels: the 4H gate
    columns of T steps of B rows padded to whole blocks, in the loops'
    order (slab_index)."""
    rows = -(-B // TC_ROWS_PER_BLOCK) * TC_ROWS_PER_BLOCK
    return torch.empty((T * rows * 4 * H,), dtype=torch.float32,
        device=device)


def _launch_fused_forward(x, h0, c0, w_ih, w_hh, b, cdt, save_cseq=True,
        phases=FORWARD_PHASES):
    T, B, D = x.shape
    H = h0.shape[1]
    check_kernel_shape(D, H, x.device)
    outs, hT, cT, cseq = _forward_outputs(T, h0, c0, cdt, save_cseq)
    if B > 0:
        # bf16 scratch: the XW slab and the bf16 [W_ih; W_hh]
        tc = cdt == torch.bfloat16
        xw = _slab(T, B, H, x.device) if tc else None
        w16 = torch.empty(((D + H) * 4 * H,), dtype=torch.bfloat16,
            device=x.device) if tc else None
        KERNEL.launch('lstm_fused_forward', ptr(x), ptr(h0), ptr(c0),
            ptr(w_ih), ptr(w_hh), ptr(b), ptr(outs), ptr_or_null(cseq),
            ptr(hT), ptr(cT), ptr_or_null(xw), ptr_or_null(w16), T, B, H,
            int(tc), phases, stream_handle(x))
    return outs, hT, cT, cseq


def _launch_fused_backward(x, h0, c0, w_ih, w_hh, b, outs, cseq, g_outs,
        g_hT, g_cT, cdt, phases=BACKWARD_PHASES):
    T, B, D = x.shape
    H = h0.shape[1]
    G = 4 * H
    check_kernel_shape(D, H, x.device)
    dev = x.device
    dx = torch.empty_like(x)
    dh0 = torch.empty_like(h0)
    dc0 = torch.empty_like(c0)
    dw = torch.empty((D + H, G), dtype=torch.float32, device=dev)
    db = torch.empty((G,), dtype=torch.float32, device=dev)
    if B == 0:
        return dx, dh0, dc0, dw[:D].zero_(), dw[D:].zero_(), db.zero_()
    tc = cdt == torch.bfloat16
    splits = splitk_splits(D + H, G, T * B, dev)
    dg = torch.empty((T, B, G), dtype=cdt, device=dev)
    dw_part = torch.empty((splits, D + H, G), dtype=torch.float32,
        device=dev)
    # db partials, a row per block: of 64 batch rows in bf16, 32 in f32
    part_rows = -(-B // TC_ROWS_PER_BLOCK) if tc else blocks(B)
    db_part = torch.empty((part_rows, G), dtype=torch.float32, device=dev)
    # bf16 scratch: the P slab, and [W_ih; W_hh], W_ih^T and h0 in bf16
    pre = _slab(T, B, H, dev) if tc else None
    w16 = torch.empty(((D + H) * G + G * D + B * H,), dtype=torch.bfloat16,
        device=dev) if tc else None
    KERNEL.launch('lstm_fused_backward', ptr(x), ptr(h0), ptr(c0), ptr(w_ih),
        ptr(w_hh), ptr(b), ptr(outs), ptr(cseq), ptr(g_outs), ptr(g_hT),
        ptr(g_cT), ptr(dx), ptr(dh0), ptr(dc0), ptr(dw), ptr(db), ptr(dg),
        ptr(dw_part), ptr(db_part), ptr_or_null(pre), ptr_or_null(w16), T, B,
        H, int(tc), splits, part_rows, phases, stream_handle(x))
    return dx, dh0, dc0, dw[:D], dw[D:], db


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
        _check_fused(x, h0, c0, w_ih, w_hh, b, cdt)
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
