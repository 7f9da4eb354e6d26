"""Encoder-fused LSTM time scan (enc5), through csrc/lstm_enc.cu.

Replaces two TPU kernels of pufferlib_tpu/ops/pallas/:
- the forward of lstm_enc5.lstm_scan_enc5, which is lstm_enc._impl /
  lstm_enc._fwd_kernel: per step the encoder

      x_t = relu(feats_t @ W_enc + b_enc)    rounded to cdt

  feeds the combined-operand cell of lstm_cat.py;
- its backward, lstm_enc5._hoisted_bwd / _bwd_kernel: the gate
  activations recomputed from [x | h_prev] and stored in cdt, the
  reverse dh/dc chain with dgates rounded to cdt and
  dh_prev = dgates @ W_hh^T, then dW_ih = x^T dg, dW_hh = h_prev^T dg,
  db = sum(dg), dx = dg @ W_ih^T, the relu mask, dW_enc = feats^T dpre
  and db_enc = sum(dpre), with dpre rounded to cdt.

feats (T, B, F) is in the compute dtype cdt; the feats cotangent is zero
by contract (observations are constants in RL training; the caller
detaches them), as the JAX kernel's is.

lstm_enc_reference and lstm_enc_backward_reference are the plain
versions: explicit PyTorch that follows the TPU kernels' math and
rounding points. The autograd.Function runs them for tensors on the CPU;
for CUDA tensors it launches the kernels or raises.
"""
import torch

from pufferlib_tpu_torch.ops.cuda._build import (
    CudaKernel, I, P, ptr, stream_handle)
from pufferlib_tpu_torch.ops.cuda.lstm_cat import (
    CDTS, backward_inputs, blocks, cell_backward_step, check_kernel_shape,
    check_placement, check_state_and_weights, gate_activations, round_to,
    scan_forward, splitk_splits)

__all__ = ['lstm_scan_enc5', 'lstm_enc_reference',
    'lstm_enc_backward_reference', 'KERNEL']

KERNEL = CudaKernel('lstm_enc.cu', {
    'lstm_enc_forward': [P] * 12 + [I] * 5 + [P],
    'lstm_enc_backward': [P] * 26 + [I] * 8 + [P],
})

# feature widths whose W_enc the kernels hold in shared memory
# (lstm_common.cuh forward_smem / backward_smem)
KERNEL_MAX_FEATURES = 128


def encode(feats, w_enc, b_enc, cdt):
    """relu(feats @ W_enc + b_enc) in f32 (not yet rounded), feats and
    W_enc rounded to cdt: lstm_enc._encode_block."""
    pre = round_to(feats, cdt) @ round_to(w_enc, cdt) + b_enc.float()
    return torch.relu(pre)


def lstm_enc_reference(feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b,
        cdt=torch.bfloat16):
    """Plain forward: (outs, hT, cT, cseq)."""
    x = round_to(encode(feats, w_enc, b_enc, cdt), cdt)
    return scan_forward(x, h0, c0, torch.cat([w_ih, w_hh], dim=0), b, cdt)


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
    hprev_all = torch.cat([round_to(h0, cdt),
        round_to(outs[:T - 1].reshape((T - 1) * B, H), cdt)], dim=0)
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


def _check(feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b, cdt):
    if cdt not in CDTS:
        raise ValueError(f'compute dtype must be one of {CDTS}, got {cdt}')
    if feats.dim() != 3 or feats.dtype != cdt:
        raise ValueError(f'feats must be (T, B, F) in {cdt}, got '
            f'{feats.dtype} {tuple(feats.shape)}')
    T, B, F = feats.shape
    if T < 1:
        raise ValueError('feats needs at least one timestep')
    dev = feats.device
    check_placement('feats', feats, dev)
    if w_enc.dim() != 2 or w_enc.shape[0] != F:
        raise ValueError(f'w_enc must be ({F}, D), got {tuple(w_enc.shape)}')
    D = w_enc.shape[1]
    for name, t, shape in (('w_enc', w_enc, (F, D)), ('b_enc', b_enc, (D,))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f'{name} must be float32 {shape}, got '
                f'{t.dtype} {tuple(t.shape)}')
        check_placement(name, t, dev)
    return check_state_and_weights(B, D, h0, c0, w_ih, w_hh, b, dev)


def _check_kernel(feats, w_enc, H):
    check_kernel_shape(w_enc.shape[1], H, feats.device)
    if feats.shape[2] > KERNEL_MAX_FEATURES:
        raise ValueError(f'the CUDA enc5 kernels take at most '
            f'{KERNEL_MAX_FEATURES} features, got {feats.shape[2]}')


def _launch_forward(feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b, cdt):
    T, B, F = feats.shape
    H = h0.shape[1]
    _check_kernel(feats, w_enc, H)
    outs = torch.empty((T, B, H), dtype=cdt, device=feats.device)
    cseq = torch.empty_like(outs)
    hT = torch.empty_like(h0)
    cT = torch.empty_like(c0)
    if B > 0:
        KERNEL.launch('lstm_enc_forward', ptr(feats), ptr(h0), ptr(c0),
            ptr(w_enc), ptr(b_enc), ptr(w_ih), ptr(w_hh), ptr(b), ptr(outs),
            ptr(cseq), ptr(hT), ptr(cT), T, B, F, H,
            int(cdt == torch.bfloat16), stream_handle(feats))
    return outs, hT, cT, cseq


def _launch_backward(feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b, outs,
        cseq, g_outs, g_hT, g_cT, cdt):
    T, B, F = feats.shape
    H = h0.shape[1]
    D, G = H, 4 * H
    _check_kernel(feats, w_enc, H)
    dev = feats.device
    f32 = dict(dtype=torch.float32, device=dev)
    dh0 = torch.empty_like(h0)
    dc0 = torch.empty_like(c0)
    dw_enc = torch.empty((F, D), **f32)
    db_enc = torch.empty((D,), **f32)
    dw = torch.empty((D + H, G), **f32)
    db = torch.empty((G,), **f32)
    if B == 0:
        return (dh0, dc0, dw_enc.zero_(), db_enc.zero_(), dw[:D].zero_(),
            dw[D:].zero_(), db.zero_())
    splits_w = splitk_splits(D + H, G, T * B, dev)
    splits_e = splitk_splits(F, D, T * B, dev)
    xs = torch.empty((T, B, D), dtype=cdt, device=dev)
    dpre = torch.empty_like(xs)
    dg = torch.empty((T, B, G), dtype=cdt, device=dev)
    dw_part = torch.empty((splits_w, D + H, G), **f32)
    db_part = torch.empty((blocks(B), G), **f32)
    dwe_part = torch.empty((splits_e, F, D), **f32)
    dbe_part = torch.empty((blocks(B), D), **f32)
    KERNEL.launch('lstm_enc_backward', ptr(feats), ptr(h0), ptr(c0),
        ptr(w_enc), ptr(b_enc), ptr(w_ih), ptr(w_hh), ptr(b), ptr(outs),
        ptr(cseq), ptr(g_outs), ptr(g_hT), ptr(g_cT), ptr(dh0), ptr(dc0),
        ptr(dw_enc), ptr(db_enc), ptr(dw), ptr(db), ptr(xs), ptr(dpre),
        ptr(dg), ptr(dw_part), ptr(db_part), ptr(dwe_part), ptr(dbe_part),
        T, B, F, H, int(cdt == torch.bfloat16), splits_w, splits_e,
        blocks(B), stream_handle(feats))
    return dh0, dc0, dw_enc, db_enc, dw[:D], dw[D:], db


class _LSTMEnc5(torch.autograd.Function):

    @staticmethod
    def forward(ctx, feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b, cdt):
        _check(feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b, cdt)
        args = (feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b, cdt)
        if feats.device.type == 'cpu':
            outs, hT, cT, cseq = lstm_enc_reference(*args)
        else:
            outs, hT, cT, cseq = _launch_forward(*args)
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
            grads = lstm_enc_backward_reference(*args)
        else:
            grads = _launch_backward(*args)
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
