"""lstm_scan_enc with the weight-gradient and dx products hoisted out of
the reverse loop, through csrc/lstm_archive.cu.

Replaces pufferlib_tpu/ops/pallas/archive/lstm_enc4.py: `lstm_scan_enc4`,
whose forward is lstm_enc._impl (ops/cuda/lstm_enc.py has it) and whose
backward is lstm_enc5._hoisted_bwd with lstm_enc4._bwd_kernel: inside the
reverse loop the gates are recomputed from [x_t | h_prev] as one sum over
K = D + H and their activations stay in f32 (enc5 takes them from a slab
in the compute dtype), the dgates are rounded to cdt and kept, and only
dh_prev = dgates @ W_hh^T recurs. After the loop, from the kept dgates:
dW_ih = x^T dg, dW_hh = h_prev^T dg, db = sum(dg) (the rounded ones),
dx = dg @ W_ih^T unrounded, the relu mask, dpre rounded to cdt, dW_enc and
db_enc. Same function as enc and enc5 in f32; in bf16 it rounds at its
own places.

On the card in bf16 the backward is enc5's tensor-core backward
(csrc/lstm_tc.cuh) with the reverse loop's activations in f32: the gate
recompute moves out of the loop into enc5's P pre-pass, (x @ W_ih +
h_prev @ W_hh) + b over all T*B rows, since [W_ih; W_hh] in bf16 (256 KiB
at D = H = 128) is more than a block's shared memory. The function is
the same. In f32 the backward runs on FMA.
"""
import torch

from pufferlib_tpu_torch.ops.cuda import lstm_enc
from pufferlib_tpu_torch.ops.cuda.archive import (
    EncVariant, launch_tc_backward, scan_enc_variant)
from pufferlib_tpu_torch.ops.cuda.lstm_common import (
    BACKWARD_PHASES, cell_backward_step, encode, gate_activations,
    h_prev_rows, round_to)

__all__ = ['lstm_scan_enc4', 'lstm_enc4_backward_reference', 'VARIANT']


def lstm_enc4_backward_reference(feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b,
        outs, cseq, g_outs, g_hT, g_cT, cdt=torch.bfloat16):
    """Plain backward, as lstm_enc4._bwd_kernel: (dh0, dc0, dW_enc,
    db_enc, dW_ih, dW_hh, db)."""
    T, B, F = feats.shape
    H = h0.shape[-1]
    D = w_enc.shape[-1]
    w = round_to(torch.cat([w_ih, w_hh], dim=0), cdt)
    bias = b.float()
    feats2 = round_to(feats.reshape(T * B, F), cdt)
    x_all = round_to(encode(feats2, w_enc, b_enc, cdt), cdt)
    hprev_all = h_prev_rows(h0, outs, cdt)
    dg_all = torch.empty((T * B, 4 * H), dtype=torch.float32,
        device=feats.device)
    whh_t = w[D:].t()
    dh, dc = g_hT.float(), g_cT.float()
    for t in reversed(range(T)):
        rows = slice(t * B, (t + 1) * B)
        c_prev = c0.float() if t == 0 else cseq[t - 1].float()
        xh = torch.cat([x_all[rows], hprev_all[rows]], dim=-1)
        # the activations stay in f32
        acts = gate_activations(xh @ w + bias, H)
        dgates, dc = cell_backward_step(acts, dh + g_outs[t].float(), dc,
            cseq[t].float(), c_prev)
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


def _launch_backward(*args, phases=BACKWARD_PHASES):
    """lstm_enc4_backward: on the tensor cores in bf16, on FMA in f32
    (archive.launch_tc_backward)."""
    return launch_tc_backward('lstm_enc4_backward', *args, phases=phases)


VARIANT = EncVariant(lstm_enc.lstm_enc_reference,
    lstm_enc._launch_enc_forward, lstm_enc4_backward_reference,
    _launch_backward)


def lstm_scan_enc4(feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b,
        cdt=torch.bfloat16):
    """lstm_scan_enc's function with the enc4 backward: see
    archive.scan_enc_variant."""
    return scan_enc_variant(VARIANT, feats, h0, c0, w_enc, b_enc, w_ih,
        w_hh, b, cdt)
