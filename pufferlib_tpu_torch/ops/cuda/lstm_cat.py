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
tensor-core kernels in mode CAT (x @ W_ih as a GEMM over all T*B rows
into an f32 slab, the loop's accumulators starting from it, h @ W_hh
onto them with W_hh held in shared memory, then + b; the gate recompute,
dx and dW as GEMMs around a reverse loop), at any input width D that is
a multiple of 8 up to lstm_common.tc_max_input(H); in f32, the exact test
mode, lstm_common.cuh's FMA cell kernels, which take D == H.

lstm_cat_reference and lstm_cat_backward_reference are the plain
versions: explicit PyTorch that follows the TPU kernels' math and
rounding points (not autograd of the forward). The autograd.Function runs
them for tensors on the CPU; for CUDA tensors it launches the kernels or
raises. chip_smoke.py holds the kernels against them on the card.
"""
import torch

from pufferlib_tpu_torch.ops.cuda._build import CudaKernel, I, P
from pufferlib_tpu_torch.ops.cuda.lstm_common import (
    BACKWARD_PHASES, FORWARD_PHASES, backward_inputs, cell_backward_step,
    check_cell_inputs, gate_activations, launch_cell_backward,
    launch_cell_forward, round_to, scan_forward)

__all__ = ['lstm_scan_cat', 'lstm_cat_reference',
    'lstm_cat_backward_reference', 'KERNEL']

KERNEL = CudaKernel('lstm_cat.cu', {
    'lstm_cat_forward': [P] * 12 + [I] * 6 + [P],
    'lstm_cat_backward': [P] * 21 + [I] * 8 + [P],
    # not a launch: the bf16 kernels' registers and spills
    'lstm_cat_tc_usage': [I, P],
    # not a launch: the widest input lstm_tc.cuh serves at a hidden size
    'lstm_tc_max_input': [I, P],
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


def _launch_forward(x, h0, c0, w_ih, w_hh, b, cdt, phases=FORWARD_PHASES):
    return launch_cell_forward(KERNEL, 'lstm_cat_forward', x, h0, c0, w_ih,
        w_hh, b, cdt, True, phases)


def _launch_backward(x, h0, c0, w_ih, w_hh, b, outs, cseq, g_outs, g_hT,
        g_cT, cdt, phases=BACKWARD_PHASES):
    return launch_cell_backward(KERNEL, 'lstm_cat_backward', x, h0, c0, w_ih,
        w_hh, b, outs, cseq, g_outs, g_hT, g_cT, cdt, phases)


class _LSTMCat(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, h0, c0, w_ih, w_hh, b, cdt):
        check_cell_inputs(x, h0, c0, w_ih, w_hh, b, cdt)
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
