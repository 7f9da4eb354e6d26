"""Encoder-fused LSTM with every non-recurrent product hoisted out of the
time loop, through csrc/lstm_archive.cu.

Replaces pufferlib_tpu/ops/pallas/archive/lstm_enc2.py: `lstm_scan_enc2`.
Forward (`_impl` / `_fwd_kernel`): the encoder and the input projection
run for every step before the loop,

    x  = relu(feats @ W_enc + b_enc)       rounded to cdt
    xp = x @ W_ih + b                      f32 sum, stored rounded to cdt

and only gates_t = xp_t + h @ W_hh (K = H, its own f32 sum) recurs. xp
passes through the compute dtype on its way, which lstm_scan_enc's single
sum over K = D + H never does: in bf16 enc2's forward is another function
than enc's, in f32 the two agree to the order of the sums.
Backward (`_bwd` / `_bwd_kernel`): x and xp recomputed and rounded as in
the forward, the gates recomputed inside the reverse loop with f32
activations, the dgates rounded to cdt and kept, dh_prev = dgates @ W_hh^T
(N = H) the loop's only product; after it, from the kept dgates,
dW_ih = x^T dg, dW_hh = h_prev^T dg, db = sum(dg), dx = dg @ W_ih^T
unrounded, the relu mask, dpre rounded to cdt, dW_enc and db_enc.

feats (T, B, F) is in cdt; its cotangent is zero by contract.

On the card the forward runs on FMA in both dtypes; the backward in bf16
runs csrc/lstm_tc.cuh's tensor-core kernels on enc4's path: the encoder as
a GEMM over all T*B rows, the gate recompute as the P pre-pass
cdt(x @ W_ih + b) + h_prev @ W_hh (the projection rounded in its
epilogue), a reverse loop with W_hh in shared memory, f32 activations and
db from the rounded dgates, then dpre and the weight gradients as enc5's
backward runs them. In f32 the backward runs on FMA.
"""
import torch

from pufferlib_tpu_torch.ops.cuda._build import (
    ptr, ptr_or_null, stream_handle)
from pufferlib_tpu_torch.ops.cuda.archive import (
    KERNEL, EncVariant, launch_tc_backward, scan_enc_variant)
from pufferlib_tpu_torch.ops.cuda.lstm_common import (
    BACKWARD_PHASES, cell_backward_step, check_fma_encoder_kernel_shape,
    encode, forward_outputs, gate_activations, h_prev_rows, round_to,
    scan_cells)

__all__ = ['lstm_scan_enc2', 'lstm_enc2_reference',
    'lstm_enc2_backward_reference', 'VARIANT']


def _projection(feats, w_enc, b_enc, w_ih, b, cdt):
    """x and xp of lstm_enc2._pre, both rounded to cdt as the TPU kernel
    stores them, carried in f32."""
    x = round_to(encode(feats, w_enc, b_enc, cdt), cdt)
    return x, round_to(x @ round_to(w_ih, cdt) + b.float(), cdt)


def lstm_enc2_reference(feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b,
        cdt=torch.bfloat16, save_cseq=True):
    """Plain forward: (outs, hT, cT, cseq); cseq None without save_cseq."""
    _, xp = _projection(feats, w_enc, b_enc, w_ih, b, cdt)
    whh = round_to(w_hh, cdt)
    return scan_cells(lambda t, h: xp[t] + h @ whh, feats.shape[0], h0, c0,
        cdt, save_cseq)


def lstm_enc2_backward_reference(feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b,
        outs, cseq, g_outs, g_hT, g_cT, cdt=torch.bfloat16):
    """Plain backward, as lstm_enc2._bwd_kernel: (dh0, dc0, dW_enc,
    db_enc, dW_ih, dW_hh, db)."""
    T, B, F = feats.shape
    H = h0.shape[-1]
    feats2 = round_to(feats.reshape(T * B, F), cdt)
    x_all, xp_all = _projection(feats2, w_enc, b_enc, w_ih, b, cdt)
    whh = round_to(w_hh, cdt)
    hprev_all = h_prev_rows(h0, outs, cdt)
    dg_all = torch.empty((T * B, 4 * H), dtype=torch.float32,
        device=feats.device)
    dh, dc = g_hT.float(), g_cT.float()
    for t in reversed(range(T)):
        rows = slice(t * B, (t + 1) * B)
        c_prev = c0.float() if t == 0 else cseq[t - 1].float()
        # the activations stay in f32
        acts = gate_activations(xp_all[rows] + hprev_all[rows] @ whh, H)
        dgates, dc = cell_backward_step(acts, dh + g_outs[t].float(), dc,
            cseq[t].float(), c_prev)
        dgates_c = round_to(dgates, cdt)
        dg_all[rows] = dgates_c
        dh = dgates_c @ whh.t()
    dw_ih = x_all.t() @ dg_all
    dw_hh = hprev_all.t() @ dg_all
    db = dg_all.sum(dim=0)
    dx_all = dg_all @ round_to(w_ih, cdt).t()
    dpre = round_to(torch.where(x_all > 0, dx_all, 0.0), cdt)
    dw_enc = feats2.t() @ dpre
    db_enc = dpre.sum(dim=0)
    return dh, dc, dw_enc, db_enc, dw_ih, dw_hh, db


def _launch_forward(feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b, cdt,
        save_cseq=True):
    """lstm_enc2_forward, on FMA in both dtypes: (outs, hT, cT, cseq)."""
    T, B, F = feats.shape
    H = h0.shape[1]
    check_fma_encoder_kernel_shape(feats, w_enc, H)
    outs, hT, cT, cseq = forward_outputs(T, h0, c0, cdt, save_cseq)
    if B > 0:
        KERNEL.launch('lstm_enc2_forward', ptr(feats), ptr(h0), ptr(c0),
            ptr(w_enc), ptr(b_enc), ptr(w_ih), ptr(w_hh), ptr(b), ptr(outs),
            ptr_or_null(cseq), ptr(hT), ptr(cT), T, B, F, H,
            int(cdt == torch.bfloat16), stream_handle(feats))
    return outs, hT, cT, cseq


def _launch_backward(*args, phases=BACKWARD_PHASES):
    """lstm_enc2_backward: on the tensor cores in bf16, on FMA in f32
    (archive.launch_tc_backward)."""
    return launch_tc_backward('lstm_enc2_backward', *args, phases=phases)


VARIANT = EncVariant(lstm_enc2_reference, _launch_forward,
    lstm_enc2_backward_reference, _launch_backward)


def lstm_scan_enc2(feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b,
        cdt=torch.bfloat16):
    """Encoder + LSTM with the projection rounded apart from the recurrent
    sum: see archive.scan_enc_variant."""
    return scan_enc_variant(VARIANT, feats, h0, c0, w_enc, b_enc, w_ih,
        w_hh, b, cdt)
