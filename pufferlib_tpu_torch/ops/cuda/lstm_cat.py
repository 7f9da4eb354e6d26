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

lstm_cat_reference and lstm_cat_backward_reference are the plain
versions: explicit PyTorch that follows the TPU kernels' math and
rounding points (not autograd of the forward). The autograd.Function runs
them for tensors on the CPU; for CUDA tensors it launches the kernels or
raises. chip_smoke.py holds the kernels against them on the card.
"""
import torch

from pufferlib_tpu_torch.ops.cuda._build import (
    CudaKernel, I, P, ptr, stream_handle)
from pufferlib_tpu_torch.ops.cuda.lstm_common import (
    CDTS, backward_inputs, blocks, cell_backward_step, check_kernel_shape,
    check_placement, check_state_and_weights, gate_activations, round_to,
    scan_forward, splitk_splits)

__all__ = ['lstm_scan_cat', 'lstm_cat_reference',
    'lstm_cat_backward_reference', 'KERNEL']

KERNEL = CudaKernel('lstm_cat.cu', {
    'lstm_cat_forward': [P] * 10 + [I] * 4 + [P],
    'lstm_cat_backward': [P] * 19 + [I] * 6 + [P],
})


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


def _check(x, h0, c0, w_ih, w_hh, b, cdt):
    if cdt not in CDTS:
        raise ValueError(f'compute dtype must be one of {CDTS}, got {cdt}')
    if x.dim() != 3 or x.dtype != cdt:
        raise ValueError(f'x must be (T, B, D) in {cdt}, got {x.dtype} '
            f'{tuple(x.shape)}')
    T, B, D = x.shape
    if T < 1:
        raise ValueError('x needs at least one timestep')
    check_placement('x', x, x.device)
    return check_state_and_weights(B, D, h0, c0, w_ih, w_hh, b, x.device)


def _launch_forward(x, h0, c0, w_ih, w_hh, b, cdt):
    T, B, D = x.shape
    H = h0.shape[1]
    check_kernel_shape(D, H, x.device)
    outs = torch.empty((T, B, H), dtype=cdt, device=x.device)
    cseq = torch.empty_like(outs)
    hT = torch.empty_like(h0)
    cT = torch.empty_like(c0)
    if B > 0:
        KERNEL.launch('lstm_cat_forward', ptr(x), ptr(h0), ptr(c0),
            ptr(w_ih), ptr(w_hh), ptr(b), ptr(outs), ptr(cseq), ptr(hT),
            ptr(cT), T, B, H, int(cdt == torch.bfloat16), stream_handle(x))
    return outs, hT, cT, cseq


def _launch_backward(x, h0, c0, w_ih, w_hh, b, outs, cseq, g_outs, g_hT,
        g_cT, cdt):
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
    splits = splitk_splits(D + H, G, T * B, dev)
    dg = torch.empty((T, B, G), dtype=cdt, device=dev)
    dw_part = torch.empty((splits, D + H, G), dtype=torch.float32,
        device=dev)
    db_part = torch.empty((blocks(B), G), dtype=torch.float32, device=dev)
    KERNEL.launch('lstm_cat_backward', ptr(x), ptr(h0), ptr(c0), ptr(w_ih),
        ptr(w_hh), ptr(b), ptr(outs), ptr(cseq), ptr(g_outs), ptr(g_hT),
        ptr(g_cT), ptr(dx), ptr(dh0), ptr(dc0), ptr(dw), ptr(db), ptr(dg),
        ptr(dw_part), ptr(db_part), T, B, H, int(cdt == torch.bfloat16),
        splits, blocks(B), stream_handle(x))
    return dx, dh0, dc0, dw[:D], dw[D:], db


class _LSTMCat(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, h0, c0, w_ih, w_hh, b, cdt):
        _check(x, h0, c0, w_ih, w_hh, b, cdt)
        if x.device.type == 'cpu':
            outs, hT, cT, cseq = lstm_cat_reference(x, h0, c0, w_ih, w_hh,
                b, cdt)
        else:
            outs, hT, cT, cseq = _launch_forward(x, h0, c0, w_ih, w_hh, b,
                cdt)
        ctx.save_for_backward(x, h0, c0, w_ih, w_hh, b, outs, cseq)
        ctx.cdt = cdt
        return outs, hT, cT

    @staticmethod
    def backward(ctx, g_outs, g_hT, g_cT):
        x, h0, c0, w_ih, w_hh, b, outs, cseq = ctx.saved_tensors
        args = (x, h0, c0, w_ih, w_hh, b, outs, cseq,
            *backward_inputs(outs, g_outs, g_hT, g_cT), ctx.cdt)
        if x.device.type == 'cpu':
            grads = lstm_cat_backward_reference(*args)
        else:
            grads = _launch_backward(*args)
        return (*grads, None)


def lstm_scan_cat(x, h0, c0, w_ih, w_hh, b, cdt=torch.bfloat16):
    """LSTM over x (T, B, D) in cdt from (h0, c0) -> (outs (T, B, H) in
    cdt, hT, cT (B, H) float32). Differentiable in every input."""
    return _LSTMCat.apply(x, h0, c0, w_ih, w_hh, b, cdt)
