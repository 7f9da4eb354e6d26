"""Time-major LSTM scan: one step of the whole batch at a time, through
csrc/lstm_archive.cu.

Replaces pufferlib_tpu/ops/pallas/archive/lstm_tm.py: `lstm_scan_tm`
(forward `_fwd_impl_tm` / `_fwd_kernel_tm`, backward `_lstm_tm_bwd` /
`_bwd_kernel_tm`), lstm_scan's function

    gates = x_proj_t (f32) + h @ W_hh           (f32 accumulation)

on a grid with time outermost: every batch tile does step t before any
does step t + 1, and h and c (backward: dh and dc) are carried in f32
between steps. Here a step is one kernel launch over the whole batch and
the carries are (B, H) f32 device buffers, two of each, written in turns;
stream order is the only synchronisation, since batch tiles do not talk
to each other. A call of T steps is T launches. The cell sequence is
always written. The backward writes dx_proj = dgates in x_proj's dtype
and contracts dgates rounded to cdt: dh_prev = dg @ W_hh^T per step,
dW_hh = h_prev^T dg over every step once step 0 is done.

x_proj (T, B, 4H) is float32 or bfloat16 whatever the compute dtype cdt.
"""
import torch

from pufferlib_tpu_torch.ops.cuda._build import ptr, ptr_or_null, stream_handle
from pufferlib_tpu_torch.ops.cuda.archive import KERNEL
from pufferlib_tpu_torch.ops.cuda.lstm_common import (
    backward_inputs, cell_backward_step, check_kernel_shape,
    check_scan_inputs, gate_activations, round_to, splitk_splits)

__all__ = ['lstm_scan_tm', 'lstm_tm_reference', 'lstm_tm_backward_reference']


def lstm_tm_reference(x_proj, h0, c0, w_hh, cdt=torch.bfloat16):
    """Plain forward, step by step over the whole batch as
    lstm_tm._fwd_kernel_tm: (outs, hT, cT, cseq)."""
    T, B, _ = x_proj.shape
    H = h0.shape[-1]
    w = round_to(w_hh, cdt)
    outs = torch.empty((T, B, H), dtype=cdt, device=x_proj.device)
    cseq = torch.empty_like(outs)
    h, c = h0.float(), c0.float()
    for t in range(T):
        gates = x_proj[t].float() + round_to(h, cdt) @ w
        i, f, g, o = gate_activations(gates, H)
        c = f * c + i * g
        h = o * torch.tanh(c)
        outs[t] = h.to(cdt)
        cseq[t] = c.to(cdt)
    return outs, h, c, cseq


def lstm_tm_backward_reference(x_proj, h0, c0, w_hh, outs, cseq, g_outs,
        g_hT, g_cT, cdt=torch.bfloat16):
    """Plain backward, step by step as lstm_tm._bwd_kernel_tm: (dx_proj,
    dh0, dc0, dW_hh)."""
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


def _launch_forward(x_proj, h0, c0, w_hh, cdt):
    T, B, _ = x_proj.shape
    H = h0.shape[1]
    check_kernel_shape(H, H, x_proj.device)
    outs = torch.empty((T, B, H), dtype=cdt, device=x_proj.device)
    cseq = torch.empty_like(outs)
    if B == 0:
        return outs, h0.clone(), c0.clone(), cseq
    # the carried state: step t reads what step t - 1 wrote and writes the
    # other pair; the last one written is hT, cT
    pairs = ((torch.empty_like(h0), torch.empty_like(c0)),
        (torch.empty_like(h0), torch.empty_like(c0)))
    state = (h0, c0)
    for t in range(T):
        nxt = pairs[t % 2]
        KERNEL.launch('lstm_tm_step_forward', ptr(x_proj), ptr(state[0]),
            ptr(state[1]), ptr(w_hh), ptr(outs), ptr(cseq), ptr(nxt[0]),
            ptr(nxt[1]), t, T, B, H, int(cdt == torch.bfloat16),
            int(x_proj.dtype == torch.bfloat16), stream_handle(x_proj))
        state = nxt
    return outs, state[0], state[1], cseq


def _launch_backward(x_proj, h0, c0, w_hh, outs, cseq, g_outs, g_hT, g_cT,
        cdt):
    T, B, G = x_proj.shape
    H = h0.shape[1]
    check_kernel_shape(H, H, x_proj.device)
    dev = x_proj.device
    dxp = torch.empty_like(x_proj)
    dw = torch.empty((H, G), dtype=torch.float32, device=dev)
    if B == 0:
        return dxp, torch.empty_like(h0), torch.empty_like(c0), dw.zero_()
    splits = splitk_splits(H, G, T * B, dev)
    # dx_proj is also the slab of dgates that dW_hh = h_prev^T dg reads,
    # rounded to cdt as it is loaded; bf16 cannot feed an f32 contraction
    separate = x_proj.dtype == torch.bfloat16 and cdt == torch.float32
    dg = torch.empty((T, B, G), dtype=cdt, device=dev) if separate else None
    dw_part = torch.empty((splits, H, G), dtype=torch.float32, device=dev)
    # the carried gradients, written in turns as the forward's state
    pairs = ((torch.empty_like(h0), torch.empty_like(c0)),
        (torch.empty_like(h0), torch.empty_like(c0)))
    grad = (g_hT, g_cT)
    for t in reversed(range(T)):
        nxt = pairs[t % 2]
        KERNEL.launch('lstm_tm_step_backward', ptr(x_proj), ptr(h0), ptr(c0),
            ptr(w_hh), ptr(outs), ptr(cseq), ptr(g_outs), ptr(grad[0]),
            ptr(grad[1]), ptr(dxp), ptr(nxt[0]), ptr(nxt[1]), ptr(dw),
            ptr_or_null(dg), ptr(dw_part), t, T, B, H,
            int(cdt == torch.bfloat16), int(x_proj.dtype == torch.bfloat16),
            splits, stream_handle(x_proj))
        grad = nxt
    return dxp, grad[0], grad[1], dw


class _LSTMScanTM(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x_proj, h0, c0, w_hh, cdt):
        check_scan_inputs(x_proj, h0, c0, w_hh, cdt)
        fn = lstm_tm_reference if x_proj.device.type == 'cpu' \
            else _launch_forward
        outs, hT, cT, cseq = fn(x_proj, h0, c0, w_hh, cdt)
        ctx.save_for_backward(x_proj, h0, c0, w_hh, outs, cseq)
        ctx.cdt = cdt
        return outs, hT, cT

    @staticmethod
    def backward(ctx, g_outs, g_hT, g_cT):
        x_proj, h0, c0, w_hh, outs, cseq = ctx.saved_tensors
        args = (x_proj, h0, c0, w_hh, outs, cseq,
            *backward_inputs(outs, g_outs, g_hT, g_cT), ctx.cdt)
        if x_proj.device.type == 'cpu':
            grads = lstm_tm_backward_reference(*args)
        else:
            grads = _launch_backward(*args)
        return (*grads, None)


def lstm_scan_tm(x_proj, h0, c0, w_hh, cdt=torch.bfloat16):
    """LSTM over the projected inputs x_proj (T, B, 4H), float32 or
    bfloat16, from (h0, c0) -> (outs (T, B, H) in cdt, hT, cT (B, H)
    float32), one launch per timestep. Differentiable in every input."""
    return _LSTMScanTM.apply(x_proj, h0, c0, w_hh, cdt)
