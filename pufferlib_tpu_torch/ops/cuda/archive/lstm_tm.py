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

In bf16 (archive.design) a step runs lstm_scan's tensor-core loops
(csrc/lstm_tc.cuh mode XP) over that one step: W_hh rounded once per call
(by the first step) into a bf16 scratch and staged into every block's
shared memory by every launch, h @ W_hh and dg_t @ W_hh^T on mma.sync,
and, after step 0, dW_hh by the ring split-K over all T*B rows. The carry
is what lstm_scan's loops keep in registers (c and dh/dc in f32, h in f32
rounded as it enters the product), so the outputs and gradients equal
lstm_scan's bf16 kernels' bit for bit. In f32, the exact test mode, both
run lstm_scan's f32 kernels (csrc/lstm_f32.cuh, design 'cluster') one
step a launch. A forward step is lstm_scan's cluster loop at one step on
step t's rows, W_hh staged into shared memory by every launch, the f32 h
and c carried exactly. In the backward the first step (t = T - 1) runs
its pre-pass over all T*B rows, since the gate recompute from x_proj and
h_prev needs no carry, and transposes W_hh into the scratch; each step
runs the cluster reverse loop over its rows, staging W_hh^T's slices into
shared memory; the last (t = 0) rounds the dgates into a bf16 dx_proj and
runs dW_hh, the split-K SGEMM with lstm_scan's splits. Its outputs and
gradients are lstm_scan's f32 ones bit for bit.

x_proj (T, B, 4H) is float32 or bfloat16 whatever the compute dtype cdt.
"""
import torch

from pufferlib_tpu_torch.ops.cuda._build import ptr, ptr_or_null, stream_handle
from pufferlib_tpu_torch.ops.cuda.archive import KERNEL, design
from pufferlib_tpu_torch.ops.cuda.lstm_common import (
    SCAN_BACKWARD_PHASES, backward_inputs, cell_backward_step,
    check_kernel_shape, check_scan_inputs, gate_activations, round_to,
    scan_backward_scratch)

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
    tc = design('lstm_tm_step_forward', cdt) == 'tc'
    # bf16 scratch: W_hh rounded by the step at t = 0
    w16 = torch.empty((H * 4 * H,), dtype=torch.bfloat16,
        device=x_proj.device) if tc else None
    # the carried state: step t reads what step t - 1 wrote and writes the
    # other pair; the last one written is hT, cT. The pointers that stay
    # the same from step to step are made once, so that the host issues a
    # step faster than the card runs it
    pairs = ((torch.empty_like(h0), torch.empty_like(c0)),
        (torch.empty_like(h0), torch.empty_like(c0)))
    pair_ptrs = [(ptr(h), ptr(c)) for h, c in pairs]
    xp, w, o, cs = ptr(x_proj), ptr(w_hh), ptr(outs), ptr(cseq)
    w16p = ptr_or_null(w16)
    flags = (T, B, H, int(cdt == torch.bfloat16),
        int(x_proj.dtype == torch.bfloat16), stream_handle(x_proj))
    state = (ptr(h0), ptr(c0))
    for t in range(T):
        nxt = pair_ptrs[t % 2]
        KERNEL.launch('lstm_tm_step_forward', xp, *state, w, o, cs, *nxt,
            w16p, t, *flags)
        state = nxt
    hT, cT = pairs[(T - 1) % 2]
    return outs, hT, cT, cseq


def _launch_backward(x_proj, h0, c0, w_hh, outs, cseq, g_outs, g_hT, g_cT,
        cdt, phases=SCAN_BACKWARD_PHASES):
    T, B, G = x_proj.shape
    H = h0.shape[1]
    check_kernel_shape(H, H, x_proj.device)
    dev = x_proj.device
    dxp = torch.empty_like(x_proj)
    dw = torch.empty((H, G), dtype=torch.float32, device=dev)
    if B == 0:
        return dxp, torch.empty_like(h0), torch.empty_like(c0), dw.zero_()
    # lstm_scan's scratch, written by the step at t = T - 1 (bf16: W_hh and
    # h0 rounded; f32: W_hh^T, and every step's activations where its
    # dgates go) and read by the later ones; dW_hh's splits are lstm_scan's
    splits, dg, dw_part, w16 = scan_backward_scratch(T, B, H, cdt,
        x_proj.dtype, dev)
    # the carried gradients, written in turns as the forward's state
    pairs = ((torch.empty_like(h0), torch.empty_like(c0)),
        (torch.empty_like(h0), torch.empty_like(c0)))
    pair_ptrs = [(ptr(dh), ptr(dc)) for dh, dc in pairs]
    inputs = [ptr(a) for a in (x_proj, h0, c0, w_hh, outs, cseq, g_outs)]
    dxp_p = ptr(dxp)
    rest = (ptr(dw), ptr_or_null(dg), ptr(dw_part), ptr(w16))
    flags = (T, B, H, int(cdt == torch.bfloat16),
        int(x_proj.dtype == torch.bfloat16), splits, phases,
        stream_handle(x_proj))
    grad = (ptr(g_hT), ptr(g_cT))
    for t in reversed(range(T)):
        nxt = pair_ptrs[t % 2]
        KERNEL.launch('lstm_tm_step_backward', *inputs, *grad, dxp_p, *nxt,
            *rest, t, *flags)
        grad = nxt
    return dxp, pairs[0][0], pairs[0][1], dw


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
