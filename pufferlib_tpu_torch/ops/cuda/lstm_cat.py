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
import math

import torch

from pufferlib_tpu_torch.ops.cuda._build import (
    CudaKernel, I, P, ptr, stream_handle)

__all__ = ['lstm_scan_cat', 'lstm_cat_reference',
    'lstm_cat_backward_reference', 'KERNEL']

KERNEL = CudaKernel('lstm_cat.cu', {
    'lstm_cat_forward': [P] * 10 + [I] * 4 + [P],
    'lstm_cat_backward': [P] * 19 + [I] * 6 + [P],
})

CDTS = (torch.float32, torch.bfloat16)
# What the CUDA kernels serve (csrc/lstm_common.cuh): hidden sizes whose
# units tile the 256-thread block, and an input width equal to the hidden
# size (layer 0 with input_size == hidden_size, and every later layer)
KERNEL_HIDDEN = (32, 64, 128)
# batch rows per block of the recurrent kernels (lstm_common.cuh BT)
ROWS_PER_BLOCK = 32


def round_to(t, cdt):
    """t rounded to cdt, carried in float32: an f32 matmul of such values
    accumulates in f32, as the JAX preferred_element_type=f32 does."""
    return t.to(cdt).float()


def gate_activations(gates, H):
    """i, f, g, o from (B, 4H) gate pre-activations."""
    return (torch.sigmoid(gates[:, :H]), torch.sigmoid(gates[:, H:2 * H]),
        torch.tanh(gates[:, 2 * H:3 * H]), torch.sigmoid(gates[:, 3 * H:]))


def scan_forward(x, h0, c0, w, b, cdt):
    """The cell loop over T. x (T, B, D): float32 values already rounded
    to cdt; w = [W_ih; W_hh] (D+H, 4H). Returns outs (T, B, H) and cseq
    (T, B, H) in cdt, hT and cT (B, H) in float32."""
    T, B, _ = x.shape
    H = h0.shape[-1]
    w = round_to(w, cdt)
    bias = b.float()
    h, c = h0.float(), c0.float()
    outs = torch.empty((T, B, H), dtype=cdt, device=x.device)
    cseq = torch.empty((T, B, H), dtype=cdt, device=x.device)
    for t in range(T):
        xh = torch.cat([x[t], round_to(h, cdt)], dim=-1)
        i, f, g, o = gate_activations(xh @ w + bias, H)
        c = f * c + i * g
        h = o * torch.tanh(c)
        outs[t] = h.to(cdt)
        cseq[t] = c.to(cdt)
    return outs, h, c, cseq


def cell_backward_step(acts, dh, dc, c_t, c_prev):
    """dgates (f32, (B, 4H)) and dc_prev of one reverse step, in the
    order of operations of the TPU kernels' _bwd_kernel."""
    i, f, g, o = acts
    tc = torch.tanh(c_t)
    do = dh * tc
    dc = dc + dh * o * (1.0 - tc * tc)
    di, dg = dc * g, dc * i
    df = dc * c_prev
    dgates = torch.cat([di * i * (1.0 - i), df * f * (1.0 - f),
        dg * (1.0 - g * g), do * o * (1.0 - o)], dim=-1)
    return dgates, dc * f


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


def check_state_and_weights(B, D, h0, c0, w_ih, w_hh, b, device):
    """Shapes, dtypes, device and contiguity of the LSTM state and
    weights (all float32); returns H."""
    if h0.dim() != 2 or h0.shape[0] != B:
        raise ValueError(f'h0 must be ({B}, H), got {tuple(h0.shape)}')
    H = h0.shape[1]
    for name, t, shape in (('h0', h0, (B, H)), ('c0', c0, (B, H)),
            ('w_ih', w_ih, (D, 4 * H)), ('w_hh', w_hh, (H, 4 * H)),
            ('b', b, (4 * H,))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f'{name} must be float32 {shape}, got '
                f'{t.dtype} {tuple(t.shape)}')
        check_placement(name, t, device)
    return H


def check_placement(name, t, device):
    if t.device != device:
        raise ValueError(f'{name} is on {t.device}, expected {device}')
    if not t.is_contiguous():
        raise ValueError(f'{name} must be contiguous')


def check_kernel_shape(D, H, device):
    """Raise for a CUDA launch the kernels do not serve."""
    if device.type != 'cuda':
        raise ValueError(f'no LSTM kernel for device {device}')
    if H not in KERNEL_HIDDEN or D != H:
        raise ValueError(f'the CUDA LSTM kernels take hidden sizes '
            f'{KERNEL_HIDDEN} with input width equal to the hidden size; '
            f'got input {D}, hidden {H}')


def splitk_splits(M, N, K, device):
    """K-splits of a post-loop (M, N) weight-gradient contraction over
    K = T*B rows: about four blocks per SM, at least 1024 rows each. The
    partial sums are added in split order by a second pass, so the result
    does not depend on the schedule."""
    # output tiles of 64 x 64 (lstm_common.cuh gemm_tn_splitk)
    tiles = math.ceil(M / 64) * math.ceil(N / 64)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(math.ceil(4 * sms / tiles), math.ceil(K / 1024)))


def blocks(B):
    return math.ceil(B / ROWS_PER_BLOCK)


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


def backward_inputs(outs, g_outs, g_hT, g_cT):
    """The incoming gradients, contiguous and in the saved dtypes."""
    return (g_outs.to(outs.dtype).contiguous(), g_hT.float().contiguous(),
        g_cT.float().contiguous())


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
