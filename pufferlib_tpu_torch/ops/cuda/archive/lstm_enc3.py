"""lstm_scan_enc with the gate recompute hoisted out of the reverse loop,
through csrc/lstm_archive.cu.

Replaces pufferlib_tpu/ops/pallas/archive/lstm_enc3.py: `lstm_scan_enc3`,
whose forward is lstm_enc._impl (ops/cuda/lstm_enc.py has it) and whose
backward is lstm_enc3._bwd / _bwd_kernel: the whole h sequence is known in
the backward, so every step's gates [x_t | h_prev] @ [W_ih; W_hh] + b are
computed in one pass before the reverse loop and their activations
stored in the compute dtype cdt. The loop reads them back and runs
[dx | dh_prev] = dgates @ [W_ih; W_hh]^T with the dgates rounded to cdt;
dx is stored rounded; dW is carried step by step from the rounded dgates
and db from the unrounded ones; the relu mask, dpre rounded to cdt, dW_enc
and db_enc close it. Same function as enc and enc5 in f32; in bf16 it
rounds at its own places.

On the card in bf16 the backward is enc5's tensor-core backward
(csrc/lstm_tc.cuh, mode ENC3) with db summed from the unrounded dgates:
the encoder and the gate recompute as GEMMs over all T*B rows (the P
pre-pass, (x @ W_ih + h_prev @ W_hh) + b), a reverse loop with W_hh in
shared memory that rounds the activations and keeps only dh_prev =
dg_t @ W_hh^T, then dx = dg @ W_ih^T as a GEMM with the relu mask and
dpre in its epilogue, and dW = [x | h_prev]^T dg and dW_enc by the
split-K. [W_ih; W_hh] in bf16 (256 KiB at D = H = 128) is more than a
block's shared memory, so [dx | dh_prev] cannot stay in the loop as on
the TPU; the function is the same, only the order of f32 sums differs.
In f32, where its roundings are the identity and its function is enc5's,
the backward is enc5's f32 backward (csrc/lstm_f32.cuh), so its
gradients are enc5's bit for bit.
"""
import torch

from pufferlib_tpu_torch.ops.cuda import lstm_enc
from pufferlib_tpu_torch.ops.cuda.archive import (
    EncVariant, launch_tc_backward, scan_enc_variant)
from pufferlib_tpu_torch.ops.cuda.lstm_common import (
    BACKWARD_PHASES, cell_backward_step, encode, gate_activations,
    h_prev_rows, round_to)

__all__ = ['lstm_scan_enc3', 'lstm_enc3_backward_reference', 'VARIANT']


def lstm_enc3_backward_reference(feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b,
        outs, cseq, g_outs, g_hT, g_cT, cdt=torch.bfloat16):
    """Plain backward, as lstm_enc3._bwd_kernel: (dh0, dc0, dW_enc,
    db_enc, dW_ih, dW_hh, db)."""
    T, B, F = feats.shape
    H = h0.shape[-1]
    D = w_enc.shape[-1]
    w = round_to(torch.cat([w_ih, w_hh], dim=0), cdt)
    bias = b.float()
    feats2 = round_to(feats.reshape(T * B, F), cdt)
    x_all = round_to(encode(feats2, w_enc, b_enc, cdt), cdt)
    xh_all = torch.cat([x_all, h_prev_rows(h0, outs, cdt)], dim=-1)
    # the activation slab is stored in cdt
    acts = [round_to(a, cdt) for a in gate_activations(xh_all @ w + bias, H)]
    dx_all = torch.empty_like(x_all)
    dw = torch.zeros_like(w)
    db = torch.zeros_like(bias)
    dh, dc = g_hT.float(), g_cT.float()
    for t in reversed(range(T)):
        rows = slice(t * B, (t + 1) * B)
        c_prev = c0.float() if t == 0 else cseq[t - 1].float()
        dgates, dc = cell_backward_step([a[rows] for a in acts],
            dh + g_outs[t].float(), dc, cseq[t].float(), c_prev)
        dgates_c = round_to(dgates, cdt)
        dxh = dgates_c @ w.t()
        dx_all[rows] = round_to(dxh[:, :D], cdt)
        dh = dxh[:, D:]
        dw += xh_all[rows].t() @ dgates_c
        db += dgates.sum(dim=0)
    dpre = round_to(torch.where(x_all > 0, dx_all, 0.0), cdt)
    dw_enc = feats2.t() @ dpre
    db_enc = dpre.sum(dim=0)
    return dh, dc, dw_enc, db_enc, dw[:D], dw[D:], db


def _launch_backward(*args, phases=BACKWARD_PHASES):
    """lstm_enc3_backward: on the tensor cores in bf16, enc5's f32
    backward in f32 (archive.launch_tc_backward)."""
    return launch_tc_backward('lstm_enc3_backward', *args, phases=phases)


VARIANT = EncVariant(lstm_enc.lstm_enc_reference,
    lstm_enc._launch_enc_forward, lstm_enc3_backward_reference,
    _launch_backward)


def lstm_scan_enc3(feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b,
        cdt=torch.bfloat16):
    """lstm_scan_enc's function with the enc3 backward: see
    archive.scan_enc_variant."""
    return scan_enc_variant(VARIANT, feats, h0, c0, w_enc, b_enc, w_ih,
        w_hh, b, cdt)
