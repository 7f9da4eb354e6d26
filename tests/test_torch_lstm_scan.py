"""lstm_scan, lstm_scan_fused and lstm_scan_enc of the PyTorch port, and the
tensor-core schedules of every resident bf16 kernel pair (lstm_scan_enc's
step backward, the archived enc2 pair, the archived enc3, enc4 and enc6
backwards and the archived tm's step kernels among them), against the JAX
package, on the CPU.

The port's side runs the kernels' plain versions (explicit forward and
backward in PyTorch, what the autograd.Functions run for CPU tensors).
The JAX side runs as the JAX package's own tests run it: the Pallas
kernels under pltpu.force_tpu_interpret_mode(), and the pure references
lstm_scan_reference, lstm_scan_fused_reference, lstm_scan_enc_reference.
Inputs come from numpy.random.default_rng(seed) and go into both.

Loss: sum(outs ** 2) + sum(hT * cT), as tests/test_pallas.py. Tolerances:
float32, 1e-5 on outputs and 5e-4 on gradients (the JAX tests' own: the
same f32 products summed in another order); bfloat16, 2e-2 of
max(1, max |reference|) per tensor: h, c and dgates round to bf16 inside
the recurrence, so a sum on the other side of a rounding boundary rounds
one ulp (2^-8) the other way and carries on.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from pufferlib_tpu.ops.pallas import lstm as jax_lstm
from pufferlib_tpu.ops.pallas import lstm_enc as jax_lstm_enc
from pufferlib_tpu.ops.pallas.lstm_cat import lstm_scan_cat as jax_scan_cat
from pufferlib_tpu.ops.pallas.lstm_enc5 import lstm_scan_enc5 as jax_scan_enc5
from pufferlib_tpu.ops.pallas.archive import lstm_enc2 as jax_archive_enc2
from pufferlib_tpu.ops.pallas.archive import lstm_enc3 as jax_archive_enc3
from pufferlib_tpu.ops.pallas.archive import lstm_enc4 as jax_archive_enc4
from pufferlib_tpu.ops.pallas.archive import lstm_enc6 as jax_archive_enc6
from pufferlib_tpu.ops.pallas.archive import lstm_tm as jax_lstm_tm

from pufferlib_tpu_torch.ops.cuda import (
    archive, lstm_cat, lstm_common, lstm_enc, lstm_scan)
from pufferlib_tpu_torch.ops.cuda.archive import (
    lstm_enc2, lstm_enc3, lstm_enc4, lstm_enc6, lstm_tm)

torch.set_num_threads(1)

T, F = 3, 7
JD = {'float32': jnp.float32, 'bfloat16': jnp.bfloat16}
TD = {'float32': torch.float32, 'bfloat16': torch.bfloat16}

# name -> (JAX kernel, JAX reference, the port's function, shapes of the
# arguments as functions of (B, H), index of the first differentiable
# argument, gradient names)
KINDS = {
    'scan': (jax_lstm.lstm_scan, jax_lstm.lstm_scan_reference,
        lstm_scan.lstm_scan,
        lambda B, H: ((T, B, 4 * H), (B, H), (B, H), (H, 4 * H)), 0,
        ('dx_proj', 'dh0', 'dc0', 'dw_hh')),
    'fused': (jax_lstm.lstm_scan_fused, jax_lstm.lstm_scan_fused_reference,
        lstm_scan.lstm_scan_fused,
        lambda B, H: ((T, B, H), (B, H), (B, H), (H, 4 * H), (H, 4 * H),
            (4 * H,)), 0,
        ('dx', 'dh0', 'dc0', 'dw_ih', 'dw_hh', 'db')),
    'enc': (jax_lstm_enc.lstm_scan_enc, jax_lstm_enc.lstm_scan_enc_reference,
        lstm_enc.lstm_scan_enc,
        lambda B, H: ((T, B, F), (B, H), (B, H), (F, H), (H,), (H, 4 * H),
            (H, 4 * H), (4 * H,)), 1,
        ('dh0', 'dc0', 'dw_enc', 'db_enc', 'dw_ih', 'dw_hh', 'db')),
}


def make_inputs(kind, B, H, seed, seq_dtype):
    """numpy float32 arguments; the sequence (argument 0) holds values of
    seq_dtype, so that both packages start from the same bits."""
    rng = np.random.default_rng(seed)
    shapes = KINDS[kind][3](B, H)
    scales = [0.5] + [0.3] * (len(shapes) - 1)
    arrays = [(rng.standard_normal(s) * k).astype(np.float32)
        for s, k in zip(shapes, scales)]
    arrays[0] = np.array(jnp.asarray(arrays[0]).astype(JD[seq_dtype])
        .astype(jnp.float32))
    return arrays


def to_np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def jax_run(fn, arrays, cdt, seq_dtype, first):
    """(outs, hT, cT) and the gradients of the loss from argument `first`
    on."""
    args = [jnp.asarray(arrays[0]).astype(JD[seq_dtype])] + [
        jnp.asarray(a) for a in arrays[1:]]

    def loss(*a):
        o, h, c = fn(*a, JD[cdt])
        return jnp.sum(o.astype(jnp.float32) ** 2) + jnp.sum(h * c)
    outs = fn(*args, JD[cdt])
    grads = jax.grad(loss, argnums=tuple(range(first, len(args))))(*args)
    return outs, grads


def torch_run(fn, arrays, cdt, seq_dtype, first):
    tensors = [torch.from_numpy(arrays[0]).to(TD[seq_dtype])] + [
        torch.from_numpy(a) for a in arrays[1:]]
    for t in tensors[first:]:
        t.requires_grad_()
    outs = fn(*tensors, TD[cdt])
    (outs[0].float().square().sum() + (outs[1] * outs[2]).sum()).backward()
    return outs, [t.grad for t in tensors[first:]]


def assert_close(got, want, tol, relative, what):
    want = to_np(want)
    if relative:
        tol = tol * max(1.0, np.abs(want).max())
    np.testing.assert_allclose(to_np(got), want, rtol=0, atol=tol,
        err_msg=what)


def compare(kind, got, want, bf16):
    """Outputs and gradients of one run against another, at the
    tolerances of the module docstring."""
    (outs, grads), (jouts, jgrads) = got, want
    out_tol, grad_tol = (2e-2, 2e-2) if bf16 else (1e-5, 5e-4)
    for name, a, w in zip(('outs', 'hT', 'cT'), outs, jouts):
        assert_close(a, w, out_tol, bf16, f'{kind} {name}')
    names = KINDS[kind][5]
    assert len(grads) == len(jgrads) == len(names)
    for name, a, w in zip(names, grads, jgrads):
        assert a.shape == tuple(w.shape), name
        assert_close(a, w, grad_tol, bf16, f'{kind} {name}')


@pytest.mark.parametrize('cdt', sorted(TD))
@pytest.mark.parametrize('H', [32, 128])
@pytest.mark.parametrize('kind', sorted(KINDS))
def test_plain_matches_pallas_kernel(kind, H, cdt):
    """The port against the Pallas kernel in interpret mode (B % 8 == 0),
    sequences stored in the compute dtype."""
    jfn, _, tfn, _, first, _ = KINDS[kind]
    arrays = make_inputs(kind, 16, H, 1, cdt)
    with pltpu.force_tpu_interpret_mode():
        want = jax_run(jfn, arrays, cdt, cdt, first)
    got = torch_run(tfn, arrays, cdt, cdt, first)
    assert got[0][0].dtype == TD[cdt] and got[0][1].dtype == torch.float32
    compare(kind, got, want, cdt == 'bfloat16')


@pytest.mark.parametrize('seq,cdt', [('float32', 'bfloat16'),
    ('bfloat16', 'float32')])
def test_scan_x_proj_dtype_apart_from_compute_dtype(seq, cdt):
    """x_proj in one dtype under the other compute dtype: dx_proj comes
    back in x_proj's dtype, as the Pallas kernel's. 2e-2 of the scale:
    one of the two is bf16."""
    arrays = make_inputs('scan', 16, 32, 2, seq)
    with pltpu.force_tpu_interpret_mode():
        want = jax_run(jax_lstm.lstm_scan, arrays, cdt, seq, 0)
    got = torch_run(lstm_scan.lstm_scan, arrays, cdt, seq, 0)
    assert got[1][0].dtype == TD[seq] and got[0][0].dtype == TD[cdt]
    compare('scan', got, want, True)


@pytest.mark.parametrize('B', [16, 12])
@pytest.mark.parametrize('kind', sorted(KINDS))
def test_plain_matches_jax_reference(kind, B):
    """The port against jax.grad of the pure-JAX reference, in f32; the
    ragged B = 12 has no interpret-mode counterpart (B % 8)."""
    _, jref, tfn, _, first, _ = KINDS[kind]
    arrays = make_inputs(kind, B, 32, 3, 'float32')
    want = jax_run(jref, arrays, 'float32', 'float32', first)
    got = torch_run(tfn, arrays, 'float32', 'float32', first)
    compare(kind, got, want, False)


PLAIN = {
    'scan': (lstm_scan.lstm_scan_reference,
        lstm_scan.lstm_scan_backward_reference),
    'fused': (lstm_scan.lstm_scan_fused_reference,
        lstm_scan.lstm_scan_fused_backward_reference),
    'enc': (lstm_enc.lstm_enc_reference,
        lstm_enc.lstm_scan_enc_backward_reference),
}


@pytest.mark.parametrize('kind', sorted(KINDS))
def test_explicit_backward_matches_autograd(kind):
    """The hand-written plain backward against torch.autograd through the
    plain forward, f32, to 1e-5 (the same math in another order)."""
    fwd, bwd = PLAIN[kind]
    first = KINDS[kind][4]
    B, H = 12, 32
    arrays = make_inputs(kind, B, H, 4, 'float32')
    tensors = [torch.from_numpy(a) for a in arrays]
    for t in tensors[first:]:
        t.requires_grad_()
    outs, hT, cT, cseq = fwd(*tensors, torch.float32)
    rng = np.random.default_rng(5)
    cot = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
        for s in ((T, B, H), (B, H), (B, H))]
    want = torch.autograd.grad([outs, hT, cT], tensors[first:], cot)
    with torch.no_grad():
        got = bwd(*tensors, outs, cseq, *cot, torch.float32)
    assert len(got) == len(want)
    for name, a, w in zip(KINDS[kind][5], got, want):
        assert_close(a, w, 1e-5, False, f'{kind} {name}')


def test_fused_is_scan_of_the_projection():
    """lstm_scan_fused(x) == lstm_scan(x @ W_ih + b) in f32, to 1e-6:
    the same two sums, added in the same order."""
    x, h0, c0, w_ih, w_hh, b = (torch.from_numpy(a) for a in make_inputs(
        'fused', 12, 32, 6, 'float32'))
    fused = lstm_scan.lstm_scan_fused(x, h0, c0, w_ih, w_hh, b, torch.float32)
    scan = lstm_scan.lstm_scan(x @ w_ih + b, h0, c0, w_hh, torch.float32)
    for name, a, w in zip(('outs', 'hT', 'cT'), fused, scan):
        assert_close(a, w, 1e-6, False, name)


@pytest.mark.parametrize('cdt', sorted(TD))
def test_enc_forward_is_enc5_forward(cdt):
    """One forward kernel serves both: bit for bit. Their backwards round
    at different places in bf16 and agree to 1e-5 in f32."""
    arrays = make_inputs('enc', 16, 32, 7, cdt)
    enc = torch_run(lstm_enc.lstm_scan_enc, arrays, cdt, cdt, 1)
    enc5 = torch_run(lstm_enc.lstm_scan_enc5, arrays, cdt, cdt, 1)
    for a, w in zip(enc[0], enc5[0]):
        assert torch.equal(a, w)
    if cdt == 'float32':
        for name, a, w in zip(KINDS['enc'][5], enc[1], enc5[1]):
            assert_close(a, w, 1e-5, True, name)
    else:
        # not the same function in bf16: some gradient differs
        assert any(not torch.equal(a, w) for a, w in zip(enc[1], enc5[1]))


@pytest.mark.parametrize('B,H', [(16, 32), (10, 32), (12, 64)])
def test_enc_f32_gradients_are_enc5_gradients(B, H):
    """In f32 the step backward's roundings (f32 activations, db from the
    unrounded dgates) are the identity, so lstm_scan_enc's backward
    computes enc5's function, and on the card it runs enc5's f32 backward
    (lstm_enc.design 'cluster'): its plain f32 outputs equal enc5's, its
    gradients lie within 1e-6 of max(1, max |enc5's|) of enc5's (the gate
    recompute and dW a step at a time are the same products summed in
    another order), and dh0, dc0, dW_enc and db_enc are equal."""
    arrays = make_inputs('enc', B, H, 29 + B + H, 'float32')
    enc = torch_run(lstm_enc.lstm_scan_enc, arrays, 'float32', 'float32', 1)
    enc5 = torch_run(lstm_enc.lstm_scan_enc5, arrays, 'float32', 'float32',
        1)
    for a, w in zip(enc[0], enc5[0]):
        assert torch.equal(a, w)
    names = KINDS['enc'][5]
    for name, a, w in zip(names, enc[1], enc5[1]):
        assert_close(a, w, 1e-6, True, f'enc f32 {name}')
        if name in ('dh0', 'dc0', 'dw_enc', 'db_enc'):
            assert torch.equal(a, w), name
    assert lstm_enc.design('lstm_enc_step_backward', torch.float32) == \
        'cluster'


@pytest.mark.parametrize('kind', sorted(KINDS))
def test_no_cell_sequence_without_gradients(kind, monkeypatch):
    """A call that needs no gradient asks the forward for no cseq (the
    kernel is then handed a null pointer) and returns the same outputs;
    one that needs a gradient asks for it."""
    fwd, _ = PLAIN[kind]
    mod = lstm_enc if kind == 'enc' else lstm_scan
    seen = []

    def recording(*args):
        seen.append(args[-1])
        result = fwd(*args)
        assert (result[3] is None) == (not args[-1])
        return result
    monkeypatch.setattr(mod, fwd.__name__, recording)
    tfn, first = KINDS[kind][2], KINDS[kind][4]
    tensors = [torch.from_numpy(a) for a in make_inputs(kind, 12, 32, 8,
        'float32')]
    primal = tfn(*tensors, torch.float32)
    tensors[-1].requires_grad_()
    with torch.no_grad():
        tfn(*tensors, torch.float32)
    saving = tfn(*tensors, torch.float32)
    assert seen == [False, False, True]
    assert saving[0].requires_grad and not primal[0].requires_grad
    for a, w in zip(primal, saving):
        assert torch.equal(a, w)


def test_launchers_refuse_what_the_kernels_do_not_serve():
    """No kernel launch for CPU tensors, for hidden sizes off {32, 64,
    128}, or for an input width other than the hidden size: ValueError
    that names the limit."""
    scan = [torch.from_numpy(a) for a in make_inputs('scan', 8, 32, 9,
        'float32')]
    fused = [torch.from_numpy(a) for a in make_inputs('fused', 8, 32, 9,
        'float32')]
    enc = [torch.from_numpy(a) for a in make_inputs('enc', 8, 32, 9,
        'float32')]
    with pytest.raises(ValueError, match='no LSTM kernel for device cpu'):
        lstm_scan._launch_scan_forward(*scan, torch.float32)
    with pytest.raises(ValueError, match='no LSTM kernel for device cpu'):
        lstm_scan._launch_fused_forward(*fused, torch.float32)
    outs, _, _, cseq = lstm_enc.lstm_enc_reference(*enc, torch.float32)
    cot = (torch.zeros(T, 8, 32), torch.zeros(8, 32), torch.zeros(8, 32))
    with pytest.raises(ValueError, match='no LSTM kernel for device cpu'):
        lstm_enc._launch_step_backward(*enc, outs, cseq, *cot, torch.float32)
    cuda = torch.device('cuda')
    for D, H in ((96, 96), (256, 256), (64, 128)):
        with pytest.raises(ValueError, match=r'\(32, 64, 128\)'):
            lstm_common.check_kernel_shape(D, H, cuda)


def test_wrappers_check_their_inputs():
    x_proj, h0, c0, w_hh = (torch.from_numpy(a) for a in make_inputs(
        'scan', 8, 32, 10, 'float32'))
    with pytest.raises(ValueError, match='x_proj'):
        lstm_scan.lstm_scan(x_proj.double(), h0, c0, w_hh, torch.float32)
    with pytest.raises(ValueError, match='h0'):
        lstm_scan.lstm_scan(x_proj[:, :, :64].contiguous(), h0, c0, w_hh,
            torch.float32)
    with pytest.raises(ValueError, match='w_hh'):
        lstm_scan.lstm_scan(x_proj, h0, c0, w_hh.t(), torch.float32)
    with pytest.raises(ValueError, match='compute dtype'):
        lstm_scan.lstm_scan(x_proj, h0, c0, w_hh, torch.float16)
    x, h0, c0, w_ih, w_hh, b = (torch.from_numpy(a) for a in make_inputs(
        'fused', 8, 32, 10, 'float32'))
    with pytest.raises(ValueError, match='x must be'):
        lstm_scan.lstm_scan_fused(x, h0, c0, w_ih, w_hh, b, torch.bfloat16)
    with pytest.raises(ValueError, match='contiguous'):
        lstm_scan.lstm_scan_fused(x.transpose(0, 1).contiguous().transpose(
            0, 1), h0, c0, w_ih, w_hh, b, torch.float32)


def tc_schedule(x, h0, c0, w_ih, w_hh, b, cdt, rows=64, cat=False,
        round_xw=False, round_acts=False, round_db=False, encoder=False,
        splits=None):
    """What the bf16 tensor-core kernels (csrc/lstm_tc.cuh) compute, in
    their order, in plain torch: lstm_scan_fused's (mode FUSED) or, with
    cat, lstm_scan_cat's (mode CAT). Forward: the slab over all T*B rows
    (FUSED XW = x @ W_ih + b, CAT S = x @ W_ih), then the loop gates =
    XW_t + h @ W_hh, or (S_t + h @ W_hh) + b. Returns (outs, hT, cT, cseq)
    and the backward as a function of the upstream gradients: the P slab
    over all rows ((x @ W_ih + b) + h_prev @ W_hh, or (x @ W_ih + h_prev @
    W_hh) + b), the reverse loop that produces only dh_prev and the dg
    slab, then dx = dg @ W_ih^T and dW = [x | h_prev]^T dg after it, and
    db from the unrounded dgates summed per block of `rows` batch rows,
    the blocks then added in order. round_xw (the archived mode ENC2, on
    FUSED's order): x @ W_ih + b is rounded to cdt before h @ W_hh is
    added, in both slabs. The reverse loop's two roundings are flags
    (lstm_tc.cuh backward_loop): round_acts rounds the activations to cdt
    (mode ENC5 and the archived ENC3 and ENC6), round_db sums db from the
    rounded dgates (ENC5 and the archived ENC2, ENC4 and ENC6). With
    encoder dx comes back in f32 for the relu
    mask; with splits dW is summed split by split in the ring's partition
    (lstm_common.splitk_reference)."""
    T, B, D = x.shape
    H = h0.shape[1]

    def rd(t):
        return t.to(cdt).float()
    xc, wi, wh, bias = rd(x).reshape(T * B, D), rd(w_ih), rd(w_hh), b.float()

    def acts(gates):
        return (torch.sigmoid(gates[:, :H]), torch.sigmoid(gates[:, H:2 * H]),
            torch.tanh(gates[:, 2 * H:3 * H]), torch.sigmoid(gates[:, 3 * H:]))
    xw = xc @ wi + (0 if cat else bias)
    if round_xw:
        xw = rd(xw)
    xw = xw.reshape(T, B, 4 * H)
    h, c = h0.float(), c0.float()
    outs, cseq = [], []
    for t in range(T):
        i, f, g, o = acts((xw[t] + rd(h) @ wh) + bias if cat
            else xw[t] + rd(h) @ wh)
        c = f * c + i * g
        h = o * torch.tanh(c)
        outs.append(h.to(cdt))
        cseq.append(c.to(cdt))
    outs, cseq = torch.stack(outs), torch.stack(cseq)

    def backward(g_outs, g_hT, g_cT):
        h_prev = torch.cat([rd(h0)[None], outs[:T - 1].float()]).reshape(
            T * B, H)
        pre = ((xc @ wi + h_prev @ wh) + bias if cat
            else xw.reshape(T * B, -1) + h_prev @ wh).reshape(T, B, 4 * H)
        blocks = -(-B // rows)
        db_blocks = torch.zeros(blocks, 4 * H)
        dg = torch.empty((T, B, 4 * H), dtype=cdt)
        dh, dc = g_hT.float(), g_cT.float()
        for t in reversed(range(T)):
            i, f, g, o = acts(pre[t])
            if round_acts:
                i, f, g, o = rd(i), rd(f), rd(g), rd(o)
            c_prev = c0.float() if t == 0 else cseq[t - 1].float()
            dhv = dh + g_outs[t].float()
            tc = torch.tanh(cseq[t].float())
            dcv = dc + dhv * o * (1 - tc * tc)
            dgates = torch.cat([dcv * g * i * (1 - i), dcv * c_prev * f * (1 - f),
                dcv * i * (1 - g * g), dhv * tc * o * (1 - o)], dim=-1)
            dc = dcv * f
            dg[t] = dgates.to(cdt)
            padded = torch.zeros(blocks * rows, 4 * H)
            padded[:B] = rd(dgates) if round_db else dgates
            db_blocks += padded.reshape(blocks, rows, 4 * H).sum(dim=1)
            dh = dg[t].float() @ wh.t()
        dgf = dg.float().reshape(T * B, 4 * H)
        dx = (dgf @ wi.t()).reshape(T, B, D)
        if not encoder:
            dx = dx.to(x.dtype)
        db = torch.zeros(4 * H)
        for k in range(blocks):
            db = db + db_blocks[k]
        if splits is None:
            return dx, dh, dc, xc.t() @ dgf, h_prev.t() @ dgf, db
        dw = lstm_common.splitk_reference(torch.cat([xc, h_prev], dim=1), dgf,
            splits)
        return dx, dh, dc, dw[:D], dw[D:], db
    return (outs, h, c, cseq), backward


@pytest.mark.parametrize('cdt', sorted(TD))
@pytest.mark.parametrize('B', [16, 72])
@pytest.mark.parametrize('H', [32, 64])
def test_tensor_core_schedule_keeps_the_function(H, B, cdt):
    """The bf16 kernels' schedule (hoisted XW and P slabs, a reverse loop
    that keeps only dh_prev, dx and dW after it, db by blocks of 64 rows)
    against the plain forward and backward on the same inputs (1e-5 in
    f32, 2e-2 of max(1, max |plain|) in bf16), and against the Pallas
    kernel in interpret mode under the loss sum(outs ** 2) + sum(hT * cT)
    (the tolerances of compare). B = 72 leaves a second block of 8 rows."""
    arrays = make_inputs('fused', B, H, 11, cdt)
    x = torch.from_numpy(arrays[0]).to(TD[cdt])
    rest = [torch.from_numpy(a) for a in arrays[1:]]
    fwd, backward = tc_schedule(x, *rest, TD[cdt])
    plain = lstm_scan.lstm_scan_fused_reference(x, *rest, TD[cdt])
    bf16 = cdt == 'bfloat16'
    tol = 2e-2 if bf16 else 1e-5
    for name, a, w in zip(('outs', 'hT', 'cT', 'cseq'), fwd, plain):
        assert a.dtype == w.dtype
        assert_close(a, w, tol, bf16, f'schedule {name}')
    rng = np.random.default_rng(12)
    cot = (torch.from_numpy(rng.standard_normal((T, B, H)).astype(
        np.float32)).to(TD[cdt]), *(torch.from_numpy(rng.standard_normal(
        (B, H)).astype(np.float32)) for _ in range(2)))
    grads = backward(*cot)
    want = lstm_scan.lstm_scan_fused_backward_reference(x, *rest, plain[0],
        plain[3], *cot, TD[cdt])
    for name, a, w in zip(KINDS['fused'][5], grads, want):
        assert a.dtype == w.dtype and a.shape == w.shape
        assert_close(a, w, tol, bf16, f'schedule {name}')
    # the loss of the JAX tests: g_outs = 2 outs, g_hT = cT, g_cT = hT
    outs, hT, cT, _ = fwd
    loss_grads = backward((2 * outs.float()).to(TD[cdt]), cT, hT)
    with pltpu.force_tpu_interpret_mode():
        jax_want = jax_run(jax_lstm.lstm_scan_fused, arrays, cdt, cdt, 0)
    compare('fused', (fwd[:3], loss_grads), jax_want, bf16)


@pytest.mark.parametrize('cdt', sorted(TD))
@pytest.mark.parametrize('B,D,H', [(16, 96, 128), (72, 40, 32)])
def test_cat_tensor_core_schedule_keeps_the_function(B, D, H, cdt):
    """The cat kernels' schedule on the tensor cores (tc_schedule with
    cat: the bias after the one sum of x @ W_ih and h @ W_hh, in the
    forward loop and in the backward slab), at input widths other than
    the hidden size, against the plain cat versions (1e-5 in f32, 2e-2 of
    max(1, max |plain|) in bf16) and the Pallas cat kernel in interpret
    mode (the tolerances of compare)."""
    rng = np.random.default_rng(13)
    arrays = [(rng.standard_normal(shape) * k).astype(np.float32)
        for shape, k in (((T, B, D), 0.5), ((B, H), 0.3), ((B, H), 0.3),
            ((D, 4 * H), 0.3), ((H, 4 * H), 0.3), ((4 * H,), 0.3))]
    arrays[0] = np.array(jnp.asarray(arrays[0]).astype(JD[cdt]).astype(
        jnp.float32))
    x = torch.from_numpy(arrays[0]).to(TD[cdt])
    rest = [torch.from_numpy(a) for a in arrays[1:]]
    fwd, backward = tc_schedule(x, *rest, TD[cdt], cat=True)
    plain = lstm_cat.lstm_cat_reference(x, *rest, TD[cdt])
    bf16 = cdt == 'bfloat16'
    tol = 2e-2 if bf16 else 1e-5
    for name, a, w in zip(('outs', 'hT', 'cT', 'cseq'), fwd, plain):
        assert a.dtype == w.dtype
        assert_close(a, w, tol, bf16, f'cat schedule {name}')
    cot = (torch.from_numpy(rng.standard_normal((T, B, H)).astype(
        np.float32)).to(TD[cdt]), *(torch.from_numpy(rng.standard_normal(
        (B, H)).astype(np.float32)) for _ in range(2)))
    grads = backward(*cot)
    want = lstm_cat.lstm_cat_backward_reference(x, *rest, plain[0], plain[3],
        *cot, TD[cdt])
    for name, a, w in zip(KINDS['fused'][5], grads, want):
        assert a.dtype == w.dtype and a.shape == w.shape
        assert_close(a, w, tol, bf16, f'cat schedule {name}')
    outs, hT, cT, _ = fwd
    loss_grads = backward((2 * outs.float()).to(TD[cdt]), cT, hT)
    with pltpu.force_tpu_interpret_mode():
        jax_want = jax_run(jax_scan_cat, arrays, cdt, cdt, 0)
    compare('fused', (fwd[:3], loss_grads), jax_want, bf16)


def enc5_tc_schedule(feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b, cdt,
        rows=64, **cell):
    """What the enc5 pair's bf16 kernels (csrc/lstm_tc.cuh, mode ENC5)
    compute, in their order, in plain torch: the encoder over all T*B rows
    as one product, xs = cdt(relu(feats @ W_enc + b_enc)), then
    tc_schedule's CAT forward on xs. The backward recomputes xs the same
    way, runs tc_schedule's CAT backward with ENC5's roundings (rounded
    activations, db from the rounded dgates), masks dx with xs > 0 into
    dpre rounded to cdt, and takes dW_enc and db_enc as one contraction
    [feats | 1]^T dpre. cell: tc_schedule's options for the cell behind
    the encoder, where they differ from ENC5's (the archived enc2, enc3
    and enc4)."""
    T, B, F = feats.shape

    def rd(t):
        return t.to(cdt).float()
    f2 = rd(feats).reshape(T * B, F)
    xs = rd(torch.relu(f2 @ rd(w_enc) + b_enc.float())).to(cdt).reshape(
        T, B, -1)
    fwd, cell_backward = tc_schedule(xs, h0, c0, w_ih, w_hh, b, cdt, rows,
        encoder=True, **{'cat': True, 'round_acts': True, 'round_db': True,
            **cell})

    def backward(g_outs, g_hT, g_cT):
        dx, dh, dc, dw_ih, dw_hh, db = cell_backward(g_outs, g_hT, g_cT)
        dpre = rd(torch.where(xs.float() > 0, dx, 0.0)).reshape(T * B, -1)
        dwe = torch.cat([f2, torch.ones(T * B, 1)], dim=1).t() @ dpre
        return dh, dc, dwe[:F], dwe[F], dw_ih, dw_hh, db
    return fwd, backward


# (B, F, D, H): B = 65 leaves a second 64-row block of one row; F = 49 has
# 98-byte bf16 rows, F = 200 is past the FMA kernels' 128; D != H
ENC5_SCHEDULES = [(16, 49, 128, 128), (65, 200, 96, 128), (16, 200, 96, 32),
    (65, 49, 128, 32)]


@pytest.mark.parametrize('cdt', sorted(TD))
@pytest.mark.parametrize('B,F,D,H', ENC5_SCHEDULES)
def test_enc5_tensor_core_schedule_keeps_the_function(B, F, D, H, cdt):
    """The enc5 pair's schedule on the tensor cores (enc5_tc_schedule)
    against the plain enc5 versions on the same inputs, and against the
    JAX package's enc5 under the same loss: at B % 8 == 0 its Pallas kernel
    in interpret mode, at B = 65, which no Pallas LSTM kernel tiles, its
    pure reference lstm_scan_enc_reference (f32 only: in bf16 that
    reference rounds as lstm_scan_enc, not as enc5). The tolerances of
    the enc5 parity test (tests/test_torch_lstm.py): 1e-5 in f32, 1e-2 in
    bf16 against the plain versions and the kernel; 1e-4 on gradients
    against the pure reference; each of max(1, max |reference|) per
    tensor, as chip_smoke.py and the card tests scale theirs: with up to
    200 features of order 1, dW_enc reaches tens, where the same f32
    products summed in another order differ by more than 1e-5, and other
    gradients pass 2, where a dgate one bf16 ulp the other way moves a
    value by more than 1e-2."""
    rng = np.random.default_rng(14)
    arrays = [(rng.standard_normal(shape) * k).astype(np.float32)
        for shape, k in (((T, B, F), 0.9), ((B, H), 0.3), ((B, H), 0.3),
            ((F, D), 0.3), ((D,), 0.3), ((D, 4 * H), 0.3), ((H, 4 * H), 0.3),
            ((4 * H,), 0.3))]
    arrays[0] = np.array(jnp.asarray(arrays[0]).astype(JD[cdt]).astype(
        jnp.float32))
    feats = torch.from_numpy(arrays[0]).to(TD[cdt])
    rest = [torch.from_numpy(a) for a in arrays[1:]]
    bf16 = cdt == 'bfloat16'
    tol = 1e-2 if bf16 else 1e-5
    fwd, backward = enc5_tc_schedule(feats, *rest, TD[cdt])
    plain = lstm_enc.lstm_enc_reference(feats, *rest, TD[cdt])
    for name, a, w in zip(('outs', 'hT', 'cT', 'cseq'), fwd, plain):
        assert a.dtype == w.dtype
        assert_close(a, w, tol, True, f'enc5 schedule {name}')
    cot = (torch.from_numpy(rng.standard_normal((T, B, H)).astype(
        np.float32)).to(TD[cdt]), *(torch.from_numpy(rng.standard_normal(
        (B, H)).astype(np.float32)) for _ in range(2)))
    grads = backward(*cot)
    want = lstm_enc.lstm_enc_backward_reference(feats, *rest, plain[0],
        plain[3], *cot, TD[cdt])
    for name, a, w in zip(KINDS['enc'][5], grads, want):
        assert a.dtype == w.dtype and a.shape == w.shape
        assert_close(a, w, tol, True, f'enc5 schedule {name}')
    # the loss of the JAX tests: g_outs = 2 outs, g_hT = cT, g_cT = hT
    outs, hT, cT, _ = fwd
    loss_grads = backward((2 * outs.float()).to(TD[cdt]), cT, hT)
    if B % 8 == 0:
        with pltpu.force_tpu_interpret_mode():
            jouts, jgrads = jax_run(jax_scan_enc5, arrays, cdt, cdt, 1)
        grad_tol = tol
    elif not bf16:
        jouts, jgrads = jax_run(jax_lstm_enc.lstm_scan_enc_reference, arrays,
            cdt, cdt, 1)
        grad_tol = 1e-4
    else:
        return
    for name, a, w in zip(('outs', 'hT', 'cT'), fwd, jouts):
        assert_close(a, w, tol, True, f'enc5 schedule {name} against JAX')
    for name, a, w in zip(KINDS['enc'][5], loss_grads, jgrads):
        assert a.shape == tuple(w.shape), name
        assert_close(a, w, grad_tol, True, f'enc5 schedule {name} against '
            'JAX')


def enc5_f32_schedule(*inputs, encoder=True, two_sums=False, splits=3,
        units=32, rows=32):
    """What the f32 kernels of csrc/lstm_f32.cuh compute, in their order,
    in plain torch: enc5's pair on (feats, h0, c0, w_enc, b_enc, w_ih,
    w_hh, b), or with encoder=False cat's, which is enc5's without the
    encoder, on (x, h0, c0, w_ih, w_hh, b), and with two_sums too
    lstm_scan_fused's, which is cat's with its sums split in two. Forward:
    enc5's encoder over all T*B rows as one product, xs = relu(feats @
    W_enc + b_enc) (cat and fused: xs = x), then the slab xw = xs @ W_ih
    over all rows (fused: xs @ W_ih + b); the loop starts each step's sums
    from the slab, adds h @ W_hh, then b (fused: h @ W_hh from zero, the
    slab added to it). Backward: xs again; the pre-pass's activations of
    [xs | h_prev] @ [W_ih; W_hh] + b as one slab (cat: the forward's slab
    kept, plus h_prev @ W_hh, then b, each sum the forward's; fused: the
    kept slab plus h_prev @ W_hh from zero); a reverse loop with only the
    recurrent product in it: dh_prev
    the partials of the cluster's blocks, each block's `units` units' four
    gate columns of dg times those rows of W_hh^T, added in rank order,
    and db summed per tile of `rows` batch rows over the steps, the tiles
    added in order; dx = dg @ W_ih^T after the loop (enc5: masked by xs > 0
    into dpre); [dW_ih; dW_hh] = [xs | h_prev]^T dg (and enc5's [dW_enc;
    db_enc] = [feats | 1]^T dpre) as the split-K over `splits` splits,
    partials added in split order (lstm_common.splitk_reference, the
    kernel's split boundaries). The backward returns the plain versions'
    gradients: enc5's (dh0, dc0, dW_enc, db_enc, dW_ih, dW_hh, db), cat's
    and fused's (dx, dh0, dc0, dW_ih, dW_hh, db)."""
    assert not (encoder and two_sums), 'two sums are fused\'s, without an encoder'
    if encoder:
        feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b = inputs
        T, B, F = feats.shape
        f2 = feats.float().reshape(T * B, F)
        xs = torch.relu(f2 @ w_enc + b_enc)
    else:
        x, h0, c0, w_ih, w_hh, b = inputs
        T, B, _ = x.shape
        xs = x.reshape(T * B, -1)
    H = h0.shape[1]
    D = xs.shape[1]
    xw = ((xs @ w_ih + b) if two_sums else xs @ w_ih).reshape(T, B, 4 * H)
    # the bias the loop adds after the recurrent sum (fused's is in xw)
    after = 0.0 if two_sums else b
    h, c = h0, c0
    outs = torch.empty((T, B, H))
    cseq = torch.empty((T, B, H))
    for t in range(T):
        i, f, g, o = lstm_common.gate_activations(xw[t] + h @ w_hh + after,
            H)
        c = f * c + i * g
        h = o * torch.tanh(c)
        outs[t], cseq[t] = h, c
    # each block's gate columns: gates g of units s * units .. + units
    cols = [torch.cat([torch.arange(g * H + s * units, g * H + (s + 1) * units)
        for g in range(4)]) for s in range(H // units)]

    def backward(g_outs, g_hT, g_cT):
        h_prev = lstm_common.h_prev_rows(h0, outs, torch.float32)
        xh = torch.cat([xs, h_prev], dim=1)
        gates = xh @ torch.cat([w_ih, w_hh], dim=0) if encoder else \
            xw.reshape(T * B, 4 * H) + h_prev @ w_hh
        acts = lstm_common.gate_activations(gates + after, H)
        dg = torch.empty((T * B, 4 * H))
        db_tiles = torch.zeros((math.ceil(B / rows), 4 * H))
        dh, dc = g_hT, g_cT
        for t in reversed(range(T)):
            r = slice(t * B, (t + 1) * B)
            c_prev = c0 if t == 0 else cseq[t - 1]
            d, dc = lstm_common.cell_backward_step([a[r] for a in acts],
                dh + g_outs[t].float(), dc, cseq[t], c_prev)
            dg[r] = d
            for k in range(db_tiles.shape[0]):
                db_tiles[k] += d[k * rows:(k + 1) * rows].sum(dim=0)
            dh = d[:, cols[0]] @ w_hh[:, cols[0]].t()
            for s in cols[1:]:
                dh = dh + d[:, s] @ w_hh[:, s].t()
        db = db_tiles[0].clone()
        for k in range(1, db_tiles.shape[0]):
            db += db_tiles[k]
        dx = dg @ w_ih.t()
        dw = lstm_common.splitk_reference(xh, dg, splits)
        if not encoder:
            return dx.reshape(T, B, D), dh, dc, dw[:D], dw[D:], db
        dpre = torch.where(xs > 0, dx, 0.0)
        dwe = lstm_common.splitk_reference(torch.cat([f2, torch.ones(T * B,
            1)], dim=1), dpre, splits)
        return dh, dc, dwe[:F], dwe[F], dw[:D], dw[D:], db
    return (outs, h, c, cseq), backward


# (T, B, F, H, units a loop block, rows a cluster): both tilings of each
# hidden size (lstm_f32.cuh LoopConfigs), memory's CLI shape (T 8, B 512,
# F 1), ragged batches whose last tile is short
ENC5_F32_SCHEDULES = [(8, 512, 1, 128, 32, 32), (3, 65, 49, 128, 64, 64),
    (3, 16, 49, 64, 64, 64), (3, 33, 20, 64, 32, 32), (3, 24, 7, 32, 32, 128),
    (4, 45, 128, 32, 32, 32)]


@pytest.mark.parametrize('T,B,F,H,units,rows', ENC5_F32_SCHEDULES)
def test_enc5_f32_schedule_keeps_the_function(T, B, F, H, units, rows):
    """The enc5 pair's f32 schedule (enc5_f32_schedule) against the plain
    enc5 versions on the same inputs, and against the JAX package's enc5
    in f32 under the loss of its tests: at B % 8 == 0 its Pallas kernel in
    interpret mode, else its pure reference lstm_scan_enc_reference (the
    same function in f32). Tolerances, each of max(1, max |reference|) per
    tensor: 1e-5 (the same f32 products summed in another order), 1e-4 on
    gradients against the pure reference (the enc5 parity test's)."""
    rng = np.random.default_rng(24)
    D = H
    arrays = [(rng.standard_normal(shape) * k).astype(np.float32)
        for shape, k in (((T, B, F), 0.9), ((B, H), 0.3), ((B, H), 0.3),
            ((F, D), 0.3), ((D,), 0.3), ((D, 4 * H), 0.3), ((H, 4 * H), 0.3),
            ((4 * H,), 0.3))]
    feats, *rest = [torch.from_numpy(a) for a in arrays]
    tol = 1e-5
    fwd, backward = enc5_f32_schedule(feats, *rest, units=units, rows=rows)
    plain = lstm_enc.lstm_enc_reference(feats, *rest, torch.float32)
    for name, a, w in zip(('outs', 'hT', 'cT', 'cseq'), fwd, plain):
        assert a.dtype == w.dtype == torch.float32
        assert_close(a, w, tol, True, f'enc5 f32 schedule {name}')
    cot = tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32))
        for s in ((T, B, H), (B, H), (B, H)))
    grads = backward(*cot)
    want = lstm_enc.lstm_enc_backward_reference(feats, *rest, plain[0],
        plain[3], *cot, torch.float32)
    for name, a, w in zip(KINDS['enc'][5], grads, want):
        assert a.dtype == w.dtype and a.shape == w.shape
        assert_close(a, w, tol, True, f'enc5 f32 schedule {name}')
    # the loss of the JAX tests: g_outs = 2 outs, g_hT = cT, g_cT = hT
    outs, hT, cT, _ = fwd
    loss_grads = backward(2 * outs, cT, hT)
    if B % 8 == 0:
        with pltpu.force_tpu_interpret_mode():
            jouts, jgrads = jax_run(jax_scan_enc5, arrays, 'float32',
                'float32', 1)
        grad_tol = tol
    else:
        jouts, jgrads = jax_run(jax_lstm_enc.lstm_scan_enc_reference, arrays,
            'float32', 'float32', 1)
        grad_tol = 1e-4
    for name, a, w in zip(('outs', 'hT', 'cT'), fwd, jouts):
        assert_close(a, w, tol, True, f'enc5 f32 schedule {name} against JAX')
    for name, a, w in zip(KINDS['enc'][5], loss_grads, jgrads):
        assert a.shape == tuple(w.shape), name
        assert_close(a, w, grad_tol, True, f'enc5 f32 schedule {name} '
            'against JAX')


def test_enc5_f32_design():
    """enc5's f32 C functions run csrc/lstm_f32.cuh ('cluster'), with the
    argument lists of the bf16 ones: lstm_enc_forward's 23 (the encoded
    inputs and the x @ W_ih slab in the bf16 scratch's places) and
    lstm_enc_backward's 38 (the activations and transposed weights in
    the P slab's place); lstm_scan_enc's step backward runs enc5's f32
    backward ('cluster') with those arguments, the bf16 ones the tensor
    cores ('tc'). The query functions are no launch."""
    for fn in ('lstm_enc_forward', 'lstm_enc_backward',
            'lstm_enc_step_backward'):
        assert lstm_enc.design(fn, torch.float32) == 'cluster'
        assert lstm_enc.design(fn, torch.bfloat16) == 'tc'
    with pytest.raises(ValueError, match='not a launch'):
        lstm_enc.design('lstm_enc_f32_plan', torch.float32)
    assert len(lstm_enc.KERNEL.functions['lstm_enc_forward']) == 23
    assert len(lstm_enc.KERNEL.functions['lstm_enc_backward']) == 38
    # the same reach as the FMA pair's: D == H in 32, 64, 128 and at most
    # 128 features, the rest to the streamed pair
    for F, D, H in ((1, 128, 128), (49, 128, 128), (128, 32, 32),
            (49, 64, 64)):
        assert lstm_common.enc5_design(F, D, H, torch.float32) == 'resident'
    for F, D, H in ((129, 128, 128), (49, 96, 128), (49, 256, 256)):
        assert lstm_common.enc5_design(F, D, H, torch.float32) == 'stream'


# (T, B, H, units a loop block, rows a cluster): cat's f32 pair at both
# loop tilings of each hidden size (lstm_f32.cuh LoopConfigs: big 64 units
# and 64 rows at H 64 and 128, 32 and 128 at H 32; small 32 and 32; H 256
# one, 32 units and 36 rows in clusters of 8 blocks), at batches that are
# whole tiles, short last tiles, and ragged (B % 8 != 0)
CAT_F32_SCHEDULES = [(3, 64, 128, 64, 64), (3, 65, 128, 32, 32),
    (3, 40, 64, 64, 64), (3, 33, 64, 32, 32), (3, 136, 32, 32, 128),
    (4, 45, 32, 32, 32), (3, 72, 256, 32, 36), (3, 41, 256, 32, 36)]


@pytest.mark.parametrize('T,B,H,units,rows', CAT_F32_SCHEDULES)
def test_cat_f32_schedule_keeps_the_function(T, B, H, units, rows):
    """Cat's f32 schedule (enc5_f32_schedule without the encoder) against
    the plain cat versions on the same inputs, and at B % 8 == 0 against
    the JAX package's lstm_scan_cat in f32, its Pallas kernel in
    interpret mode, under the loss of its tests. Tolerance 1e-5 of max(1,
    max |reference|) per tensor: the same f32 products summed in another
    order."""
    rng = np.random.default_rng(25)
    D = H
    arrays = [(rng.standard_normal(shape) * k).astype(np.float32)
        for shape, k in (((T, B, D), 0.5), ((B, H), 0.3), ((B, H), 0.3),
            ((D, 4 * H), 0.3), ((H, 4 * H), 0.3), ((4 * H,), 0.3))]
    x, *rest = [torch.from_numpy(a) for a in arrays]
    tol = 1e-5
    fwd, backward = enc5_f32_schedule(x, *rest, encoder=False, units=units,
        rows=rows)
    plain = lstm_cat.lstm_cat_reference(x, *rest, torch.float32)
    for name, a, w in zip(('outs', 'hT', 'cT', 'cseq'), fwd, plain):
        assert a.dtype == w.dtype == torch.float32
        assert_close(a, w, tol, True, f'cat f32 schedule {name}')
    cot = tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32))
        for s in ((T, B, H), (B, H), (B, H)))
    grads = backward(*cot)
    want = lstm_cat.lstm_cat_backward_reference(x, *rest, plain[0], plain[3],
        *cot, torch.float32)
    for name, a, w in zip(KINDS['fused'][5], grads, want):
        assert a.dtype == w.dtype and a.shape == w.shape
        assert_close(a, w, tol, True, f'cat f32 schedule {name}')
    if B % 8:
        return
    # the loss of the JAX tests: g_outs = 2 outs, g_hT = cT, g_cT = hT
    outs, hT, cT, _ = fwd
    loss_grads = backward(2 * outs, cT, hT)
    with pltpu.force_tpu_interpret_mode():
        jouts, jgrads = jax_run(jax_scan_cat, arrays, 'float32', 'float32',
            0)
    for name, a, w in zip(('outs', 'hT', 'cT'), fwd, jouts):
        assert_close(a, w, tol, True, f'cat f32 schedule {name} against JAX')
    for name, a, w in zip(KINDS['fused'][5], loss_grads, jgrads):
        assert a.shape == tuple(w.shape), name
        assert_close(a, w, tol, True, f'cat f32 schedule {name} against JAX')


def test_cat_f32_design():
    """Cat's f32 C functions run csrc/lstm_f32.cuh ('cluster') with the
    argument lists of the bf16 ones: lstm_cat_forward's 19 (the x @ W_ih
    slab in the bf16 slab's place) and lstm_cat_backward's 30 (the
    activations and transposed weights in the P slab's place); the bf16
    ones run the tensor cores ('tc'). The f32 reach is D == H in 32, 64,
    128 (the FMA cell's it replaced) and 256 (clusters of 8 blocks)
    resident, the rest streamed; bf16 at H 256 streamed."""
    for fn in ('lstm_cat_forward', 'lstm_cat_backward'):
        assert lstm_cat.design(fn, torch.float32) == 'cluster'
        assert lstm_cat.design(fn, torch.bfloat16) == 'tc'
    with pytest.raises(ValueError, match='not a launch'):
        lstm_cat.design('lstm_cat_f32_plan', torch.float32)
    assert len(lstm_cat.KERNEL.functions['lstm_cat_forward']) == 19
    assert len(lstm_cat.KERNEL.functions['lstm_cat_backward']) == 30
    f32 = torch.float32
    for H in (32, 64, 128, 256):
        assert lstm_common.cat_design(H, H, f32) == 'resident'
    for D, H in ((96, 128), (128, 64), (9, 256), (200, 128), (512, 512)):
        assert lstm_common.cat_design(D, H, f32) == 'stream'
    assert lstm_common.cat_design(96, 128, torch.bfloat16) == 'resident'
    assert lstm_common.cat_design(256, 256, torch.bfloat16) == 'stream'


@pytest.mark.parametrize('T,B,H,units,rows', CAT_F32_SCHEDULES)
def test_fused_f32_schedule_keeps_the_function(T, B, H, units, rows):
    """lstm_scan_fused's f32 schedule (enc5_f32_schedule with two sums:
    the bias in the projection's slab, the recurrent sum from zero with
    the slab added after it) against the plain fused versions on the same
    inputs, and at B % 8 == 0 against the JAX package's lstm_scan_fused in
    f32, its Pallas kernel in interpret mode, under the loss of its tests.
    Tolerance 1e-5 of max(1, max |reference|) per tensor: the same f32
    products summed in another order."""
    rng = np.random.default_rng(26)
    D = H
    arrays = [(rng.standard_normal(shape) * k).astype(np.float32)
        for shape, k in (((T, B, D), 0.5), ((B, H), 0.3), ((B, H), 0.3),
            ((D, 4 * H), 0.3), ((H, 4 * H), 0.3), ((4 * H,), 0.3))]
    x, *rest = [torch.from_numpy(a) for a in arrays]
    tol = 1e-5
    fwd, backward = enc5_f32_schedule(x, *rest, encoder=False,
        two_sums=True, units=units, rows=rows)
    plain = lstm_scan.lstm_scan_fused_reference(x, *rest, torch.float32)
    for name, a, w in zip(('outs', 'hT', 'cT', 'cseq'), fwd, plain):
        assert a.dtype == w.dtype == torch.float32
        assert_close(a, w, tol, True, f'fused f32 schedule {name}')
    cot = tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32))
        for s in ((T, B, H), (B, H), (B, H)))
    grads = backward(*cot)
    want = lstm_scan.lstm_scan_fused_backward_reference(x, *rest, plain[0],
        plain[3], *cot, torch.float32)
    for name, a, w in zip(KINDS['fused'][5], grads, want):
        assert a.dtype == w.dtype and a.shape == w.shape
        assert_close(a, w, tol, True, f'fused f32 schedule {name}')
    if B % 8:
        return
    # the loss of the JAX tests: g_outs = 2 outs, g_hT = cT, g_cT = hT
    outs, hT, cT, _ = fwd
    loss_grads = backward(2 * outs, cT, hT)
    with pltpu.force_tpu_interpret_mode():
        jouts, jgrads = jax_run(jax_lstm.lstm_scan_fused, arrays, 'float32',
            'float32', 0)
    for name, a, w in zip(('outs', 'hT', 'cT'), fwd, jouts):
        assert_close(a, w, tol, True, f'fused f32 schedule {name} against '
            'JAX')
    for name, a, w in zip(KINDS['fused'][5], loss_grads, jgrads):
        assert a.shape == tuple(w.shape), name
        assert_close(a, w, tol, True, f'fused f32 schedule {name} against '
            'JAX')


def test_fused_f32_design():
    """lstm_scan_fused's f32 C functions run csrc/lstm_f32.cuh ('cluster')
    with the argument lists of the bf16 ones: lstm_fused_forward's 19 (the
    x @ W_ih + b slab in the bf16 slab's place) and lstm_fused_backward's
    30 (the activations and transposed weights in the P slab's place, the
    slab in the bf16 scratch's); the bf16 ones run the tensor cores
    ('tc'); lstm_scan's f32 pair runs lstm_f32.cuh too ('cluster': its
    forward with its 16 arguments, the scratch null; its backward with its
    24, W_hh^T in the bf16 scratch's place). The reach is the FMA cell's
    it replaced: D == H in 32, 64, 128 in f32 (anything else refused
    before a launch), input widths that are multiples of 8 in bf16."""
    for fn in ('lstm_fused_forward', 'lstm_fused_backward',
            'lstm_scan_backward'):
        assert lstm_scan.design(fn, torch.float32) == 'cluster'
        assert lstm_scan.design(fn, torch.bfloat16) == 'tc'
    assert lstm_scan.design('lstm_scan_forward', torch.float32) == 'cluster'
    assert lstm_scan.design('lstm_scan_forward', torch.bfloat16) == 'tc'
    assert len(lstm_scan.KERNEL.functions['lstm_scan_forward']) == 16
    assert len(lstm_scan.KERNEL.functions['lstm_scan_backward']) == 24
    for fn in ('lstm_fused_f32_plan', 'lstm_fused_f32_usage',
            'lstm_fused_tc_usage'):
        with pytest.raises(ValueError, match='not a launch'):
            lstm_scan.design(fn, torch.float32)
    assert len(lstm_scan.KERNEL.functions['lstm_fused_forward']) == 19
    assert len(lstm_scan.KERNEL.functions['lstm_fused_backward']) == 30
    f32, bf16 = torch.float32, torch.bfloat16
    for H in (32, 64, 128):
        assert lstm_common.cell_shape_error(H, H, f32) is None
    for D, H in ((96, 128), (128, 64), (256, 256), (48, 48)):
        assert 'input width equal' in lstm_common.cell_shape_error(D, H, f32)
    assert lstm_common.cell_shape_error(96, 128, bf16) is None
    # the f32 backward launcher asks for its forward's slab before it
    # checks the device, so no launch either way
    x, h0, c0, w_ih, w_hh, b = (torch.from_numpy(a) for a in make_inputs(
        'fused', 8, 32, 11, 'float32'))
    outs, _, _, cseq = lstm_scan.lstm_scan_fused_reference(x, h0, c0, w_ih,
        w_hh, b, f32)
    cot = (torch.zeros(T, 8, 32), torch.zeros(8, 32), torch.zeros(8, 32))
    with pytest.raises(ValueError, match=r'x @ W_ih \+ b slab'):
        lstm_scan._launch_fused_backward(x, h0, c0, w_ih, w_hh, b, outs, cseq,
            *cot, f32)


def xp_tc_schedule(x_proj, h0, c0, w_hh, cdt, splits):
    """What lstm_scan's bf16 kernels (csrc/lstm_tc.cuh, mode XP) compute,
    in their order, in plain torch. Forward: no pre-pass; the loop reads
    x_proj itself, gates = x_proj_t + h @ W_hh (the recurrent sum in f32
    from zero, x_proj added after it). Returns (outs, hT, cT, cseq) and
    the backward as a function of the upstream gradients: no pre-pass
    either; the reverse loop recomputes each step's gates the same way
    from x_proj and h_prev (h0 rounded, then the stored outs), produces
    dh_prev and the dgates (no db), dx_proj = the f32 dgates in x_proj's
    dtype (with bf16 x_proj the rounded dgates slab itself), and after the
    loop dW_hh = h_prev^T dg over the rounded dgates, split by split in the
    ring's partition and added in split order
    (lstm_common.splitk_reference)."""
    T, B, G = x_proj.shape
    H = h0.shape[1]

    def rd(t):
        return t.to(cdt).float()
    wh = rd(w_hh)

    def gates(t, h):
        return x_proj[t].float() + h @ wh
    h, c = h0.float(), c0.float()
    outs, cseq = [], []
    for t in range(T):
        i, f, g, o = lstm_common.gate_activations(gates(t, rd(h)), H)
        c = f * c + i * g
        h = o * torch.tanh(c)
        outs.append(h.to(cdt))
        cseq.append(c.to(cdt))
    outs, cseq = torch.stack(outs), torch.stack(cseq)

    def backward(g_outs, g_hT, g_cT):
        h_prev = torch.cat([rd(h0)[None], outs[:T - 1].float()])
        dxp = torch.empty_like(x_proj)
        dg = torch.empty((T, B, G), dtype=cdt)
        dh, dc = g_hT.float(), g_cT.float()
        for t in reversed(range(T)):
            acts = lstm_common.gate_activations(gates(t, h_prev[t]), H)
            c_prev = c0.float() if t == 0 else cseq[t - 1].float()
            dgates, dc = lstm_common.cell_backward_step(acts,
                dh + g_outs[t].float(), dc, cseq[t].float(), c_prev)
            dxp[t] = dgates.to(x_proj.dtype)
            dg[t] = dgates.to(cdt)
            dh = dg[t].float() @ wh.t()
        dw = lstm_common.splitk_reference(h_prev.reshape(T * B, H),
            dg.float().reshape(T * B, G), splits)
        return dxp, dh, dc, dw
    return (outs, h, c, cseq), backward


@pytest.mark.parametrize('seq', ['bfloat16', 'float32'])
@pytest.mark.parametrize('B', [8, 65])
@pytest.mark.parametrize('H', [32, 64, 128])
def test_xp_tensor_core_schedule_keeps_the_function(H, B, seq):
    """lstm_scan's bf16 schedule (xp_tc_schedule, x_proj in bf16 and in
    f32 under bf16 compute) against the plain forward and backward on the
    same inputs, 2e-2 of max(1, max |plain|) per tensor; and against the
    JAX package under the loss sum(outs ** 2) + sum(hT * cT): at B = 8 its
    Pallas kernel in interpret mode (the tolerances of compare), at B = 65,
    which no Pallas LSTM kernel tiles (B % 8), the forward of its pure
    reference lstm_scan_reference (whose autodiff backward rounds at other
    points than the kernel). dW_hh is split three ways, so that the
    partition is exercised at this size."""
    cdt = 'bfloat16'
    arrays = make_inputs('scan', B, H, 15, seq)
    x_proj = torch.from_numpy(arrays[0]).to(TD[seq])
    rest = [torch.from_numpy(a) for a in arrays[1:]]
    fwd, backward = xp_tc_schedule(x_proj, *rest, TD[cdt], splits=3)
    plain = lstm_scan.lstm_scan_reference(x_proj, *rest, TD[cdt])
    for name, a, w in zip(('outs', 'hT', 'cT', 'cseq'), fwd, plain):
        assert a.dtype == w.dtype
        assert_close(a, w, 2e-2, True, f'xp schedule {name}')
    rng = np.random.default_rng(16)
    cot = (torch.from_numpy(rng.standard_normal((T, B, H)).astype(
        np.float32)).to(TD[cdt]), *(torch.from_numpy(rng.standard_normal(
        (B, H)).astype(np.float32)) for _ in range(2)))
    grads = backward(*cot)
    want = lstm_scan.lstm_scan_backward_reference(x_proj, *rest, plain[0],
        plain[3], *cot, TD[cdt])
    for name, a, w in zip(KINDS['scan'][5], grads, want):
        assert a.dtype == w.dtype and a.shape == w.shape
        assert_close(a, w, 2e-2, True, f'xp schedule {name}')
    outs, hT, cT, _ = fwd
    if B % 8:
        jouts = jax_lstm.lstm_scan_reference(
            jnp.asarray(arrays[0]).astype(JD[seq]),
            *(jnp.asarray(a) for a in arrays[1:]), JD[cdt])
        for name, a, w in zip(('outs', 'hT', 'cT'), fwd, jouts):
            assert_close(a, w, 2e-2, True, f'xp schedule {name} against JAX')
        return
    loss_grads = backward((2 * outs.float()).to(TD[cdt]), cT, hT)
    with pltpu.force_tpu_interpret_mode():
        jax_want = jax_run(jax_lstm.lstm_scan, arrays, cdt, seq, 0)
    compare('scan', (fwd[:3], loss_grads), jax_want, True)


def xp_f32_schedule(x_proj, h0, c0, w_hh, outs, cseq, splits=3, units=32,
        one_step=False):
    """What the f32 backward of lstm_scan (csrc/lstm_f32.cuh,
    xp_backward_steps) computes, in its order, in plain torch, from the
    forward's outs and cseq (x_proj in f32 or bf16): the pre-pass over all
    T*B rows, the activations of h_prev @ W_hh summed from zero with
    x_proj added after it (the forward's two sums); the reverse loop
    without db: the dgates from the activations, dh_prev the partials of
    the cluster's blocks, each block's `units` units' four gate columns of
    dg times those rows of W_hh^T, added in rank order; dx_proj the f32
    dgates in x_proj's dtype (with bf16 x_proj rounded after the loop);
    dW_hh = h_prev^T dg over the f32 dgates as the split-K, `splits`
    splits added in split order (lstm_common.splitk_reference). one_step:
    the archived tm's f32 schedule, the same pieces with the loop one step
    a call and dh, dc handed from call to call. Returns the backward as a
    function of the upstream gradients."""
    T, B, G = x_proj.shape
    H = h0.shape[1]
    h_prev = lstm_common.h_prev_rows(h0, outs, torch.float32)
    acts = lstm_common.gate_activations(
        h_prev @ w_hh + x_proj.float().reshape(T * B, G), H)
    cols = [torch.cat([torch.arange(g * H + s * units, g * H + (s + 1) * units)
        for g in range(4)]) for s in range(H // units)]

    def loop(steps, dh, dc, g_outs, dg):
        for t in steps:
            r = slice(t * B, (t + 1) * B)
            c_prev = c0 if t == 0 else cseq[t - 1].float()
            d, dc = lstm_common.cell_backward_step([a[r] for a in acts],
                dh + g_outs[t].float(), dc, cseq[t].float(), c_prev)
            dg[r] = d
            dh = d[:, cols[0]] @ w_hh[:, cols[0]].t()
            for c in cols[1:]:
                dh = dh + d[:, c] @ w_hh[:, c].t()
        return dh, dc

    def backward(g_outs, g_hT, g_cT):
        dg = torch.empty((T * B, G))
        dh, dc = g_hT.float(), g_cT.float()
        if one_step:
            for t in reversed(range(T)):
                dh, dc = loop([t], dh, dc, g_outs, dg)
        else:
            dh, dc = loop(reversed(range(T)), dh, dc, g_outs, dg)
        dxp = dg.reshape(T, B, G).to(x_proj.dtype)
        dw = lstm_common.splitk_reference(h_prev, dg, splits)
        return dxp, dh, dc, dw
    return backward


# (T, B, H, units a loop block, x_proj's dtype): both loop tilings of each
# hidden size (lstm_f32.cuh LoopConfigs), batches that are whole tiles,
# short last tiles and ragged (B % 8 != 0), x_proj in f32 and in bf16
XP_F32_SCHEDULES = [(3, 64, 128, 64, 'float32'), (3, 65, 128, 32, 'bfloat16'),
    (3, 40, 64, 64, 'bfloat16'), (3, 33, 64, 32, 'float32'),
    (4, 24, 32, 32, 'bfloat16'), (5, 10, 32, 32, 'float32')]


@pytest.mark.parametrize('T,B,H,units,seq', XP_F32_SCHEDULES)
def test_xp_f32_schedule_keeps_the_function(T, B, H, units, seq):
    """lstm_scan's f32 backward schedule (xp_f32_schedule, from the plain
    forward's outs and cseq) against the plain backward on the same
    inputs, and at B % 8 == 0 against the JAX package's lstm_scan in f32,
    its Pallas kernel in interpret mode, under the loss of its tests;
    tm's schedule (the loop one step a call) equal to it bit for bit.
    Tolerance 1e-5 of max(1, max |reference|) per tensor (the same f32
    products summed in another order), 2e-2 for a bf16 dx_proj (a dgate
    one f32 ulp apart rounds to the next bf16 value)."""
    rng = np.random.default_rng(27)
    arrays = [(rng.standard_normal(shape) * k).astype(np.float32)
        for shape, k in (((T, B, 4 * H), 0.5), ((B, H), 0.3), ((B, H), 0.3),
            ((H, 4 * H), 0.3))]
    arrays[0] = np.array(jnp.asarray(arrays[0]).astype(JD[seq])
        .astype(jnp.float32))
    x_proj = torch.from_numpy(arrays[0]).to(TD[seq])
    rest = [torch.from_numpy(a) for a in arrays[1:]]
    f32 = torch.float32
    outs, hT, cT, cseq = lstm_scan.lstm_scan_reference(x_proj, *rest, f32)
    backward = xp_f32_schedule(x_proj, *rest, outs, cseq, units=units)
    tm_backward = xp_f32_schedule(x_proj, *rest, outs, cseq, units=units,
        one_step=True)
    cot = tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32))
        for s in ((T, B, H), (B, H), (B, H)))
    grads = backward(*cot)
    for name, a, w in zip(KINDS['scan'][5], tm_backward(*cot), grads):
        assert a.dtype == w.dtype and torch.equal(a, w), f'tm {name}'
    want = lstm_scan.lstm_scan_backward_reference(x_proj, *rest, outs, cseq,
        *cot, f32)

    def close(got, want, what):
        for name, a, w in zip(KINDS['scan'][5], got, want):
            assert a.shape == tuple(w.shape), name
            tol = 2e-2 if a.dtype == torch.bfloat16 else 1e-5
            assert_close(a, w, tol, True, f'xp f32 schedule {name} {what}')
    assert grads[0].dtype == TD[seq]
    close(grads, want, '')
    if B % 8:
        return
    # the loss of the JAX tests: g_outs = 2 outs, g_hT = cT, g_cT = hT
    loss_grads = backward(2 * outs, cT, hT)
    with pltpu.force_tpu_interpret_mode():
        _, jgrads = jax_run(jax_lstm.lstm_scan, arrays, 'float32', seq, 0)
    close(loss_grads, jgrads, 'against JAX')


def test_f32_fma_backward_is_gone():
    """The FMA backward of lstm_common.cuh (its reverse cell kernel, the
    host functions that launched it and the f32 split-K) is gone: every f32
    backward runs csrc/lstm_f32.cuh. Its reverse loop may write the
    dgates over their activations (mode XP), so that pair of pointers is
    not __restrict__."""
    import os
    import re
    csrc = os.path.join(os.path.dirname(lstm_common.__file__), '..', '..',
        'csrc')

    def source(name):
        with open(os.path.join(csrc, name)) as f:
            return f.read()
    common = source('lstm_common.cuh')
    for name in ('cell_backward', 'run_backward_steps', 'run_backward',
            'gemm_tn_splitk', 'backward_smem', 'cols_gemm'):
        assert not re.search(rf'\b{name}\s*\(', common), name
    f32 = source('lstm_f32.cuh')
    loop = re.search(r'backward_loop\((.*?)\)\s*\{', f32, re.S).group(1)
    params = {p.split()[-1]: p for p in (q.strip() for q in loop.split(','))}
    for name in ('acts', 'dg'):
        assert '__restrict__' not in params[name], params[name]
    assert '__restrict__' in params['w_hh_t']
    for cu in ('lstm_scan.cu', 'lstm_archive.cu'):
        assert 'f32::xp_backward_steps<H, S>' in source(cu), cu


def xp_f32_forward_schedule(x_proj, h0, c0, w_hh, rows, one_step=False):
    """What the f32 forward of lstm_scan (csrc/lstm_f32.cuh xp_forward:
    fused's two-sums cluster loop with x_proj as its slab) computes, in
    its order, in plain torch: the batch in tiles of `rows` rows, a
    cluster's (the last one short at a ragged B), each tile walking the
    steps with its own h and c; a step's h @ W_hh summed from zero, then
    x_proj_t (f32, or bf16 widened) added to it, then the cell. one_step:
    the archived tm's f32 forward, one launch a step over every tile, the
    f32 h and c handed from call to call. Returns (outs, hT, cT, cseq)."""
    T, B, _ = x_proj.shape
    H = h0.shape[1]
    outs = torch.empty((T, B, H))
    cseq = torch.empty((T, B, H))
    hT, cT = torch.empty((B, H)), torch.empty((B, H))

    def walk(steps, h_in, c_in):
        """steps over every tile from the state (h_in, c_in) before the
        first: the state after the last."""
        h_out, c_out = torch.empty_like(h_in), torch.empty_like(c_in)
        for r0 in range(0, B, rows):
            r = slice(r0, min(B, r0 + rows))
            h, c = h_in[r], c_in[r]
            for t in steps:
                acc = h @ w_hh
                acc = x_proj[t, r].float() + acc
                i, f, g, o = lstm_common.gate_activations(acc, H)
                c = f * c + i * g
                h = o * torch.tanh(c)
                outs[t, r], cseq[t, r] = h, c
            h_out[r], c_out[r] = h, c
        return h_out, c_out
    if one_step:
        h, c = h0, c0
        for t in range(T):
            h, c = walk([t], h, c)
    else:
        h, c = walk(range(T), h0, c0)
    hT[:], cT[:] = h, c
    return outs, hT, cT, cseq


# (T, B, H, rows a cluster, x_proj's dtype): both loop tilings of each
# hidden size (lstm_f32.cuh LoopConfigs: big 64 rows at H 64 and 128, 128
# at H 32; small 32), whole tiles, short last tiles and ragged batches (B
# % 8 != 0), x_proj in f32 and in bf16 under f32 compute. The batches that
# B % 8 lets the Pallas kernels take are powers of two: the time-major
# Pallas grid runs in interpret mode only as one batch tile (it revisits
# its (B, H) state blocks every step)
XP_F32_FORWARDS = [(3, 64, 128, 64, 'float32'), (3, 65, 128, 32, 'bfloat16'),
    (3, 32, 64, 64, 'bfloat16'), (3, 33, 64, 32, 'float32'),
    (4, 128, 32, 128, 'float32'), (5, 10, 32, 32, 'bfloat16')]


@pytest.mark.parametrize('T,B,H,rows,seq', XP_F32_FORWARDS)
def test_xp_f32_forward_schedule_keeps_the_function(T, B, H, rows, seq):
    """lstm_scan's f32 forward schedule (xp_f32_forward_schedule) against
    the plain lstm_scan and lstm_scan_tm forwards on the same inputs, and
    against the JAX package in f32: at B % 8 == 0 its Pallas lstm_scan and
    lstm_scan_tm in interpret mode, else its pure reference
    lstm_scan_reference (tm's function is lstm_scan's). Tolerance 1e-5 of
    max(1, max |reference|) per tensor (the same f32 products summed in
    another order). tm's schedule (one step a call) equal to scan's bit
    for bit."""
    rng = np.random.default_rng(29)
    arrays = [(rng.standard_normal(shape) * k).astype(np.float32)
        for shape, k in (((T, B, 4 * H), 0.5), ((B, H), 0.3), ((B, H), 0.3),
            ((H, 4 * H), 0.3))]
    arrays[0] = np.array(jnp.asarray(arrays[0]).astype(JD[seq])
        .astype(jnp.float32))
    x_proj = torch.from_numpy(arrays[0]).to(TD[seq])
    rest = [torch.from_numpy(a) for a in arrays[1:]]
    f32 = torch.float32
    got = xp_f32_forward_schedule(x_proj, *rest, rows)
    tm = xp_f32_forward_schedule(x_proj, *rest, rows, one_step=True)
    names = ('outs', 'hT', 'cT', 'cseq')
    for name, a, w in zip(names, tm, got):
        assert a.dtype == w.dtype and torch.equal(a, w), f'tm {name}'
    for plain in (lstm_scan.lstm_scan_reference(x_proj, *rest, f32),
            lstm_tm.lstm_tm_reference(x_proj, *rest, f32)):
        for name, a, w in zip(names, got, plain):
            assert a.dtype == w.dtype == f32 and a.shape == w.shape
            assert_close(a, w, 1e-5, True, f'xp f32 forward schedule {name}')
    args = [jnp.asarray(arrays[0]).astype(JD[seq])] + [
        jnp.asarray(a) for a in arrays[1:]]
    if B % 8:
        wants = [jax_lstm.lstm_scan_reference(*args, jnp.float32)]
    else:
        with pltpu.force_tpu_interpret_mode():
            wants = [jax_lstm.lstm_scan(*args, jnp.float32),
                jax_lstm_tm.lstm_scan_tm(*args, jnp.float32)]
    for want in wants:
        for name, a, w in zip(names, got, want):
            assert_close(a, w, 1e-5, True, f'xp f32 forward schedule {name} '
                'against JAX')


def test_f32_fma_xp_forward_is_gone():
    """Mode XP of lstm_common.cuh's FMA cell (its x_proj load, its branch
    of the cell kernel, the x_proj type parameter and the step-range
    launcher) is gone: lstm_scan's and tm's f32 forwards run
    csrc/lstm_f32.cuh's xp_forward (and the rest of the FMA cell went with
    enc2's f32 forward: test_f32_fma_cell_is_gone)."""
    import os
    import re
    csrc = os.path.join(os.path.dirname(lstm_common.__file__), '..', '..',
        'csrc')

    def source(name):
        with open(os.path.join(csrc, name)) as f:
            return f.read()
    common = source('lstm_common.cuh')
    for name in ('load_x_proj', 'run_forward_steps'):
        assert not re.search(rf'\b{name}\b', common), name
    assert 'MODE == XP' not in common and 'MODE != XP' not in common
    for name in os.listdir(csrc):
        if name.endswith(('.cu', '.cuh')):
            text = source(name)
            assert not re.search(r'run_forward(_steps)?<[^>]*XP>', text), name
            launches = re.findall(r'\brun_forward<([^>]*)>', text)
            assert all(a.split(',')[-1].strip() == 'ENC2' for a in launches), (
                name, launches)
    for cu in ('lstm_scan.cu', 'lstm_archive.cu'):
        assert 'f32::xp_forward<H, S>' in source(cu), cu


def test_f32_fma_cell_is_gone():
    """lstm_common.cuh's FMA cell (the cell kernel, its launcher, its
    shared-memory size, its gate sums, its encoder and its weight staging)
    is gone from every CUDA source: the archived enc2's f32 forward, its
    last caller, runs csrc/lstm_f32.cuh's enc5 forward with fused's two
    sums."""
    import os
    import re
    csrc = os.path.join(os.path.dirname(lstm_common.__file__), '..', '..',
        'csrc')

    def source(name):
        with open(os.path.join(csrc, name)) as f:
            return f.read()
    for name in os.listdir(csrc):
        if not name.endswith(('.cu', '.cuh')):
            continue
        text = source(name)
        assert not re.search(r'\brun_forward\s*<', text), name
        assert not re.search(r'\bcell_forward\s*<\s*H\s*,\s*E\b', text), name
        for gone in ('gate_sums', 'gates_gemm', 'encode_rows', 'forward_smem',
                'RowChunk', 'fetch_rows', 'put_rows'):
            assert not re.search(rf'\b{gone}\b', text), (name, gone)
        assert not re.search(r'\bstruct\s+Tile\b', text), name
    assert 'f32::enc5_forward<H, true>' in source('lstm_archive.cu')


def enc2_f32_forward_schedule(feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b,
        rows):
    """What the archived enc2's f32 forward (csrc/lstm_f32.cuh
    enc5_forward<H, true>) computes, in its order, in plain torch: the
    encoder over all T*B rows as one product, xs = relu(feats @ W_enc +
    b_enc); the projection xw = xs @ W_ih + b as one more; then fused's
    loop on xw (xp_f32_forward_schedule: tiles of `rows` batch rows, each
    step's h @ W_hh summed from zero and xw_t added after it). Returns
    (outs, hT, cT, cseq)."""
    T, B, F = feats.shape
    H = h0.shape[1]
    xs = torch.relu(feats.float().reshape(T * B, F) @ w_enc + b_enc)
    xw = (xs @ w_ih + b).reshape(T, B, 4 * H)
    return xp_f32_forward_schedule(xw, h0, c0, w_hh, rows)


# (T, B, F, H, rows a cluster): both loop tilings of each hidden size
# (lstm_f32.cuh LoopConfigs: big 64 rows at H 64 and 128, 128 at H 32;
# small 32), whole tiles and short last tiles at B % 8 == 0 (held to the
# JAX kernel), ragged batches (B % 8 != 0, held to the plain version);
# one feature, the bench's 49 and the most, 128
ENC2_F32_FORWARDS = [(3, 16, 49, 128, 64), (3, 40, 49, 128, 32),
    (3, 24, 20, 64, 64), (3, 72, 128, 64, 32), (4, 136, 5, 32, 128),
    (3, 16, 1, 32, 32), (3, 45, 49, 128, 32), (3, 33, 128, 64, 64),
    (5, 10, 1, 32, 128)]


@pytest.mark.parametrize('T,B,F,H,rows', ENC2_F32_FORWARDS)
def test_enc2_f32_forward_schedule_keeps_the_function(T, B, F, H, rows):
    """The archived enc2's f32 forward schedule (enc2_f32_forward_schedule)
    against the plain lstm_enc2_reference on the same inputs, and at B % 8
    == 0 against the JAX package's Pallas lstm_scan_enc2 in f32 (its
    `_impl`, which also returns the cell sequence) in interpret mode.
    Tolerance 1e-5 of max(1, max |reference|) per tensor: the same f32
    products summed in another order (in f32 the TPU kernel's roundings
    of x and xp are the identity)."""
    rng = np.random.default_rng(32)
    D = H
    arrays = [(rng.standard_normal(shape) * k).astype(np.float32)
        for shape, k in (((T, B, F), 0.9), ((B, H), 0.3), ((B, H), 0.3),
            ((F, D), 0.3), ((D,), 0.3), ((D, 4 * H), 0.3), ((H, 4 * H), 0.3),
            ((4 * H,), 0.3))]
    tensors = [torch.from_numpy(a) for a in arrays]
    tol = 1e-5
    names = ('outs', 'hT', 'cT', 'cseq')
    got = enc2_f32_forward_schedule(*tensors, rows)
    plain = lstm_enc2.lstm_enc2_reference(*tensors, torch.float32)
    for name, a, w in zip(names, got, plain):
        assert a.dtype == w.dtype == torch.float32 and a.shape == w.shape
        assert_close(a, w, tol, True, f'enc2 f32 forward schedule {name}')
    if B % 8:
        return
    with pltpu.force_tpu_interpret_mode():
        want = jax_archive_enc2._impl(*(jnp.asarray(a) for a in arrays),
            jnp.float32)
    for name, a, w in zip(names, got, want):
        assert a.shape == tuple(w.shape), name
        assert_close(a, w, tol, True, f'enc2 f32 forward schedule {name} '
            'against JAX')


def tm_tc_schedule(x_proj, h0, c0, w_hh, cdt, splits):
    """What the archived tm's bf16 kernels (csrc/lstm_archive.cu: mode
    XP's loops of csrc/lstm_tc.cuh one step a launch) compute, in their
    order, in plain torch: xp_tc_schedule's steps, one step a call, the
    f32 carries (h and c forward, dh and dc backward) handed from call to
    call as the (B, H) device buffers hand them, W_hh rounded once for
    every step, and after step 0 dW_hh = h_prev^T dg over the rounded
    dgates of every step by the split-K (lstm_common.splitk_reference).
    Returns xp_tc_schedule's (outs, hT, cT, cseq) and backward."""
    T, B, G = x_proj.shape
    H = h0.shape[1]

    def rd(t):
        return t.to(cdt).float()
    wh = rd(w_hh)
    outs = torch.empty((T, B, H), dtype=cdt)
    cseq = torch.empty_like(outs)

    def step_forward(t, h_in, c_in):
        # h_in enters the product rounded, as the loop's h tile holds it
        gates = x_proj[t].float() + rd(h_in) @ wh
        i, f, g, o = lstm_common.gate_activations(gates, H)
        c_out = f * c_in + i * g
        h_out = o * torch.tanh(c_out)
        outs[t] = h_out.to(cdt)
        cseq[t] = c_out.to(cdt)
        return h_out, c_out
    h, c = h0.float(), c0.float()
    for t in range(T):
        h, c = step_forward(t, h, c)

    def backward(g_outs, g_hT, g_cT):
        dxp = torch.empty_like(x_proj)
        dg = torch.empty((T, B, G), dtype=cdt)

        def h_prev(t):
            return rd(h0) if t == 0 else outs[t - 1].float()

        def step_backward(t, dh_in, dc_in):
            acts = lstm_common.gate_activations(
                x_proj[t].float() + h_prev(t) @ wh, H)
            c_prev = c0.float() if t == 0 else cseq[t - 1].float()
            dgates, dc_out = lstm_common.cell_backward_step(acts,
                dh_in + g_outs[t].float(), dc_in, cseq[t].float(), c_prev)
            dxp[t] = dgates.to(x_proj.dtype)
            dg[t] = dgates.to(cdt)
            return dg[t].float() @ wh.t(), dc_out
        dh, dc = g_hT.float(), g_cT.float()
        for t in reversed(range(T)):
            dh, dc = step_backward(t, dh, dc)
        rows = torch.cat([h_prev(t) for t in range(T)])
        dw = lstm_common.splitk_reference(rows, dg.float().reshape(T * B, G),
            splits)
        return dxp, dh, dc, dw
    return (outs, h, c, cseq), backward


@pytest.mark.parametrize('seq', ['bfloat16', 'float32'])
@pytest.mark.parametrize('B', [8, 65])
@pytest.mark.parametrize('H', [32, 64, 128])
def test_tm_tensor_core_schedule_keeps_the_function(H, B, seq):
    """The archived tm's bf16 schedule (tm_tc_schedule: one step a call,
    the carries in f32 between calls, x_proj in bf16 and in f32 under bf16
    compute) equal to lstm_scan's (xp_tc_schedule) bit for bit in every
    output and gradient: the carries are the values lstm_scan's loops keep
    in registers, so the card's tm kernels equal lstm_scan's. Against the
    plain tm on the same inputs, 2e-2 of max(1, max |plain|) per tensor;
    at B = 8 also against the JAX package's lstm_scan_tm in interpret mode
    under tests/test_torch_archive.py's loss (the tolerances of its tm
    test in bf16). dW_hh is split three ways, so that the partition is
    exercised at this size."""
    cdt = 'bfloat16'
    arrays = make_inputs('scan', B, H, 23, seq)
    x_proj = torch.from_numpy(arrays[0]).to(TD[seq])
    rest = [torch.from_numpy(a) for a in arrays[1:]]
    fwd, backward = tm_tc_schedule(x_proj, *rest, TD[cdt], splits=3)
    xp_fwd, xp_backward = xp_tc_schedule(x_proj, *rest, TD[cdt], splits=3)
    for name, a, w in zip(('outs', 'hT', 'cT', 'cseq'), fwd, xp_fwd):
        assert a.dtype == w.dtype and torch.equal(a, w), f'tm {name}'
    plain = lstm_tm.lstm_tm_reference(x_proj, *rest, TD[cdt])
    for name, a, w in zip(('outs', 'hT', 'cT', 'cseq'), fwd, plain):
        assert a.dtype == w.dtype
        assert_close(a, w, 2e-2, True, f'tm schedule {name}')
    rng = np.random.default_rng(24)
    cot = (torch.from_numpy(rng.standard_normal((T, B, H)).astype(
        np.float32)).to(TD[cdt]), *(torch.from_numpy(rng.standard_normal(
        (B, H)).astype(np.float32)) for _ in range(2)))
    grads = backward(*cot)
    for name, a, w in zip(KINDS['scan'][5], grads, xp_backward(*cot)):
        assert a.dtype == w.dtype and torch.equal(a, w), f'tm {name}'
    want = lstm_tm.lstm_tm_backward_reference(x_proj, *rest, plain[0],
        plain[3], *cot, TD[cdt])
    for name, a, w in zip(KINDS['scan'][5], grads, want):
        assert a.dtype == w.dtype and a.shape == w.shape
        assert_close(a, w, 2e-2, True, f'tm schedule {name}')
    if B % 8:
        return
    outs, hT, cT, _ = fwd
    # test_torch_archive's tm loss: 0.7 sum(outs) + 1.3 sum(hT) + 0.5
    # sum(cT)
    loss_grads = backward(torch.full_like(outs, 0.7, dtype=torch.float32)
        .to(TD[cdt]), torch.full_like(hT, 1.3), torch.full_like(cT, 0.5))
    args = [jnp.asarray(arrays[0]).astype(JD[seq])] + [
        jnp.asarray(a) for a in arrays[1:]]

    def loss(*a):
        o, h, c = jax_lstm_tm.lstm_scan_tm(*a, JD[cdt])
        return ((o.astype(jnp.float32) * 0.7).sum() + (h * 1.3).sum()
            + (c * 0.5).sum())
    with pltpu.force_tpu_interpret_mode():
        jouts = jax_lstm_tm.lstm_scan_tm(*args, JD[cdt])
        jgrads = jax.grad(loss, argnums=(0, 1, 2, 3))(*args)
    for name, a, w in zip(('outs', 'hT', 'cT'), fwd, jouts):
        assert_close(a, w, 2e-2, True, f'tm schedule {name} against JAX')
    for name, a, w in zip(KINDS['scan'][5], loss_grads, jgrads):
        assert a.shape == tuple(w.shape), name
        assert_close(a, w, 2e-2, True, f'tm schedule {name} against JAX')


def enc4_tc_schedule(*args, splits=3):
    """What the archived enc4's bf16 backward (csrc/lstm_tc.cuh
    tc::backward in mode ENC4) computes, in its order, with the forward
    it shares with enc5: enc5_tc_schedule with the reverse loop's
    activations in f32 (db still from the rounded dgates) and dW split
    `splits` ways in the ring's partition."""
    return enc5_tc_schedule(*args, round_acts=False, splits=splits)


def enc2_tc_schedule(*args, splits=3):
    """What the archived enc2's bf16 pair (csrc/lstm_tc.cuh
    tc::enc2_forward, tc::backward in mode ENC2) computes, in its order:
    enc4_tc_schedule with FUSED's bias order and the projection rounded.
    The forward's gates cdt(x_t @ W_ih + b) + h @ W_hh: the projection
    GEMM's epilogue adds b and rounds, mode XP's loop adds the recurrent
    product's own f32 sum to it (the order of its FMA kernel and its TPU
    kernel); the P slab's cdt(x @ W_ih + b) + h_prev @ W_hh."""
    return enc5_tc_schedule(*args, cat=False, round_xw=True, round_acts=False,
        splits=splits)


def enc3_tc_schedule(*args, splits=3):
    """What the archived enc3's bf16 backward (csrc/lstm_tc.cuh
    tc::backward in mode ENC3) computes, in its order, with the forward it
    shares with enc5: enc5_tc_schedule with db summed from the unrounded
    dgates (the activations still rounded), dx = dg @ W_ih^T after the
    loop in place of the TPU kernel's [dx | dh_prev] inside it, and dW
    split `splits` ways in the ring's partition."""
    return enc5_tc_schedule(*args, round_db=False, splits=splits)


def enc6_tc_schedule(*args, splits=3):
    """What the archived enc6's bf16 backward (csrc/lstm_tc.cuh
    tc::backward in mode ENC6) computes: enc5's backward itself, whose
    loop's two halves are enc6's two chains, with dW split `splits` ways
    in the ring's partition."""
    return enc5_tc_schedule(*args, splits=splits)


ARCHIVED_SCHEDULES = {'enc2': (enc2_tc_schedule, lstm_enc2,
    jax_archive_enc2.lstm_scan_enc2), 'enc3': (enc3_tc_schedule, lstm_enc3,
    jax_archive_enc3.lstm_scan_enc3), 'enc4': (enc4_tc_schedule, lstm_enc4,
    jax_archive_enc4.lstm_scan_enc4), 'enc6': (enc6_tc_schedule, lstm_enc6,
    jax_archive_enc6.lstm_scan_enc6)}


@pytest.mark.parametrize('cdt', sorted(TD))
@pytest.mark.parametrize('B,F,H', [(8, 49, 128), (65, 49, 32), (33, 20, 64)])
@pytest.mark.parametrize('kind', sorted(ARCHIVED_SCHEDULES))
def test_archived_tensor_core_schedule_keeps_the_function(kind, B, F, H,
        cdt):
    """The archived enc2's, enc3's, enc4's and enc6's bf16 backward
    schedules on the tensor cores (enc2_tc_schedule, enc3_tc_schedule,
    enc4_tc_schedule, enc6_tc_schedule; D == H, as the archive takes)
    against the port's plain versions on the same inputs
    (1e-5 in f32, 2e-2 in bf16, of max(1, max |plain|) per tensor), and
    against the JAX package under the loss sum(outs ** 2) + sum(hT * cT):
    at B = 8 the archived Pallas kernel in interpret mode (the tolerances
    of compare); at the ragged B = 65 and 33 (a second 64-row block of one
    row; one block of 33), which no Pallas LSTM kernel tiles (B % 8), its
    pure reference lstm_scan_enc_reference (f32 only, 1e-5 on outputs and
    1e-4 of max(1, max |reference|) on gradients: in bf16 that reference
    rounds as lstm_scan_enc, not as the archived kernels)."""
    schedule, module, jax_fn = ARCHIVED_SCHEDULES[kind]
    rng = np.random.default_rng(17)
    arrays = [(rng.standard_normal(shape) * k).astype(np.float32)
        for shape, k in (((T, B, F), 0.9), ((B, H), 0.3), ((B, H), 0.3),
            ((F, H), 0.3), ((H,), 0.3), ((H, 4 * H), 0.3), ((H, 4 * H), 0.3),
            ((4 * H,), 0.3))]
    arrays[0] = np.array(jnp.asarray(arrays[0]).astype(JD[cdt]).astype(
        jnp.float32))
    feats = torch.from_numpy(arrays[0]).to(TD[cdt])
    rest = [torch.from_numpy(a) for a in arrays[1:]]
    bf16 = cdt == 'bfloat16'
    tol = 2e-2 if bf16 else 1e-5
    fwd, backward = schedule(feats, *rest, TD[cdt])
    variant = module.VARIANT
    plain = variant.forward_plain(feats, *rest, TD[cdt])
    for name, a, w in zip(('outs', 'hT', 'cT', 'cseq'), fwd, plain):
        assert a.dtype == w.dtype
        assert_close(a, w, tol, True, f'{kind} schedule {name}')
    cot = (torch.from_numpy(rng.standard_normal((T, B, H)).astype(
        np.float32)).to(TD[cdt]), *(torch.from_numpy(rng.standard_normal(
        (B, H)).astype(np.float32)) for _ in range(2)))
    grads = backward(*cot)
    want = variant.backward_plain(feats, *rest, plain[0], plain[3], *cot,
        TD[cdt])
    for name, a, w in zip(KINDS['enc'][5], grads, want):
        assert a.dtype == w.dtype and a.shape == w.shape
        assert_close(a, w, tol, True, f'{kind} schedule {name}')
    outs, hT, cT, _ = fwd
    loss_grads = backward((2 * outs.float()).to(TD[cdt]), cT, hT)
    if B % 8 == 0:
        with pltpu.force_tpu_interpret_mode():
            jax_want = jax_run(jax_fn, arrays, cdt, cdt, 1)
        compare('enc', (fwd[:3], loss_grads), jax_want, bf16)
    elif not bf16:
        jouts, jgrads = jax_run(jax_lstm_enc.lstm_scan_enc_reference, arrays,
            cdt, cdt, 1)
        for name, a, w in zip(('outs', 'hT', 'cT'), fwd, jouts):
            assert_close(a, w, 1e-5, True, f'{kind} schedule {name} '
                'against JAX')
        for name, a, w in zip(KINDS['enc'][5], loss_grads, jgrads):
            assert a.shape == tuple(w.shape), name
            assert_close(a, w, 1e-4, True, f'{kind} schedule {name} '
                'against JAX')


def enc_tc_schedule(*args, splits=3):
    """What lstm_scan_enc's bf16 step backward (csrc/lstm_tc.cuh
    tc::backward in mode ENC) computes, in its order, with the forward it
    shares with enc5: enc5_tc_schedule with the reverse loop's activations
    in f32 and db summed from the unrounded dgates (its TPU kernel's
    per-step recompute as the P pre-pass, its per-step dW as the split-K,
    `splits` ways in the ring's partition)."""
    return enc5_tc_schedule(*args, round_acts=False, round_db=False,
        splits=splits)


# kind -> (its tensor-core schedule, plain forward, plain backward, the JAX
# kernel), for lstm_scan_enc and the archived enc2 at widths past the FMA
# kernels' (D != H, F > 128)
WIDE_SCHEDULES = {
    'enc': (enc_tc_schedule, lstm_enc.lstm_enc_reference,
        lstm_enc.lstm_scan_enc_backward_reference,
        jax_lstm_enc.lstm_scan_enc),
    'enc2': (enc2_tc_schedule, lstm_enc2.lstm_enc2_reference,
        lstm_enc2.lstm_enc2_backward_reference,
        jax_archive_enc2.lstm_scan_enc2),
}


@pytest.mark.parametrize('cdt', sorted(TD))
@pytest.mark.parametrize('kind,B,F,D,H', [('enc', 8, 49, 128, 128),
    ('enc', 16, 200, 96, 128), ('enc', 65, 49, 32, 32),
    ('enc', 33, 200, 48, 64), ('enc2', 16, 200, 96, 128),
    ('enc2', 33, 200, 48, 64)])
def test_enc_tensor_core_schedule_keeps_the_function(kind, B, F, D, H, cdt):
    """lstm_scan_enc's bf16 step backward on the tensor cores
    (enc_tc_schedule), and the archived enc2's pair (enc2_tc_schedule) at
    the widths the tensor-core kernels open to it (D != H, F = 200), against
    the port's plain versions on the same inputs (1e-5 in f32, 2e-2 in
    bf16, of max(1, max |plain|) per tensor), and against the JAX package
    under the loss sum(outs ** 2) + sum(hT * cT): at B % 8 == 0 its Pallas
    kernel in interpret mode (1e-5 in f32, 2e-2 in bf16, of max(1, max
    |JAX|): at F = 200 dW_enc reaches tens, where the same f32 products
    summed in another order differ by more than 1e-5 absolute); at the
    ragged B = 65 and 33 (a second 64-row block of one row; one block of
    33), which no Pallas LSTM kernel tiles, its pure reference
    lstm_scan_enc_reference (f32 only, 1e-5 on outputs and 1e-4 on
    gradients, of max(1, max |reference|): in bf16 that reference rounds
    as neither kernel's backward)."""
    schedule, fwd_plain, bwd_plain, jax_fn = WIDE_SCHEDULES[kind]
    rng = np.random.default_rng(18)
    arrays = [(rng.standard_normal(shape) * k).astype(np.float32)
        for shape, k in (((T, B, F), 0.9), ((B, H), 0.3), ((B, H), 0.3),
            ((F, D), 0.3), ((D,), 0.3), ((D, 4 * H), 0.3), ((H, 4 * H), 0.3),
            ((4 * H,), 0.3))]
    arrays[0] = np.array(jnp.asarray(arrays[0]).astype(JD[cdt]).astype(
        jnp.float32))
    feats = torch.from_numpy(arrays[0]).to(TD[cdt])
    rest = [torch.from_numpy(a) for a in arrays[1:]]
    bf16 = cdt == 'bfloat16'
    tol = 2e-2 if bf16 else 1e-5
    fwd, backward = schedule(feats, *rest, TD[cdt])
    plain = fwd_plain(feats, *rest, TD[cdt])
    for name, a, w in zip(('outs', 'hT', 'cT', 'cseq'), fwd, plain):
        assert a.dtype == w.dtype
        assert_close(a, w, tol, True, f'{kind} schedule {name}')
    cot = (torch.from_numpy(rng.standard_normal((T, B, H)).astype(
        np.float32)).to(TD[cdt]), *(torch.from_numpy(rng.standard_normal(
        (B, H)).astype(np.float32)) for _ in range(2)))
    grads = backward(*cot)
    want = bwd_plain(feats, *rest, plain[0], plain[3], *cot, TD[cdt])
    for name, a, w in zip(KINDS['enc'][5], grads, want):
        assert a.dtype == w.dtype and a.shape == w.shape
        assert_close(a, w, tol, True, f'{kind} schedule {name}')
    outs, hT, cT, _ = fwd
    loss_grads = backward((2 * outs.float()).to(TD[cdt]), cT, hT)
    if B % 8 == 0:
        with pltpu.force_tpu_interpret_mode():
            jouts, jgrads = jax_run(jax_fn, arrays, cdt, cdt, 1)
        out_tol = grad_tol = tol
    elif not bf16:
        jouts, jgrads = jax_run(jax_lstm_enc.lstm_scan_enc_reference, arrays,
            cdt, cdt, 1)
        out_tol, grad_tol = 1e-5, 1e-4
    else:
        return
    for name, a, w in zip(('outs', 'hT', 'cT'), fwd, jouts):
        assert_close(a, w, out_tol, True, f'{kind} schedule {name} against '
            'JAX')
    for name, a, w in zip(KINDS['enc'][5], loss_grads, jgrads):
        assert a.shape == tuple(w.shape), name
        assert_close(a, w, grad_tol, True, f'{kind} schedule {name} against '
            'JAX')


@pytest.mark.parametrize('cdt', sorted(TD))
@pytest.mark.parametrize('kind', ['enc', 'enc2'])
def test_encoder_scans_at_other_widths_match_pallas_kernel(kind, cdt):
    """lstm_scan_enc and the archived lstm_scan_enc2 at an encoder width
    apart from the hidden size and 200 features, the shapes their bf16
    kernels take on the card, through the wrappers (the plain versions on
    the CPU) against the JAX kernel in interpret mode under the loss
    sum(outs ** 2) + sum(hT * cT): 1e-5 in f32, 2e-2 in bf16, of max(1,
    max |JAX|) per tensor."""
    fn, jax_fn = {'enc': (lstm_enc.lstm_scan_enc, jax_lstm_enc.lstm_scan_enc),
        'enc2': (lstm_enc2.lstm_scan_enc2, jax_archive_enc2.lstm_scan_enc2)
        }[kind]
    B, F, D, H = 16, 200, 96, 64
    rng = np.random.default_rng(19)
    arrays = [(rng.standard_normal(shape) * k).astype(np.float32)
        for shape, k in (((T, B, F), 0.9), ((B, H), 0.3), ((B, H), 0.3),
            ((F, D), 0.3), ((D,), 0.3), ((D, 4 * H), 0.3), ((H, 4 * H), 0.3),
            ((4 * H,), 0.3))]
    arrays[0] = np.array(jnp.asarray(arrays[0]).astype(JD[cdt]).astype(
        jnp.float32))
    with pltpu.force_tpu_interpret_mode():
        jouts, jgrads = jax_run(jax_fn, arrays, cdt, cdt, 1)
    outs, grads = torch_run(fn, arrays, cdt, cdt, 1)
    tol = 2e-2 if cdt == 'bfloat16' else 1e-5
    for name, a, w in zip(('outs', 'hT', 'cT'), outs, jouts):
        assert_close(a, w, tol, True, f'{kind} {name}')
    for name, a, w in zip(KINDS['enc'][5], grads, jgrads):
        assert a.shape == tuple(w.shape), name
        assert_close(a, w, tol, True, f'{kind} {name}')


@pytest.mark.parametrize('cdt', sorted(TD))
@pytest.mark.parametrize('kind', ['enc2', 'enc3', 'enc4', 'enc6'])
def test_archived_backward_design(kind, cdt):
    """Which design each archived backward runs (archive.design): in bf16
    all four the tensor-core kernels of lstm_tc.cuh ('tc'); in f32 all
    four lstm_f32.cuh ('cluster': enc5's f32 backward, enc2's with two
    sums). The C functions' argument lists follow it: the tensor-core
    ones take lstm_enc_backward's (the P slab, the bf16 weights, the
    phases), which also carry the f32 kernels' scratch (the work slab in
    the P slab's place)."""
    fn = f'lstm_{kind}_backward'
    design = archive.design(fn, TD[cdt])
    assert design == ('tc' if cdt == 'bfloat16' else 'cluster')
    args = archive.KERNEL.functions[fn]
    enc_backward = lstm_enc.KERNEL.functions['lstm_enc_backward']
    assert args == enc_backward and len(args) == 38
    assert fn in archive.F32_FUNCTIONS


@pytest.mark.parametrize('cdt', sorted(TD))
def test_step_backward_and_enc2_forward_designs(cdt):
    """lstm_scan_enc's step backward (lstm_enc.design) and the archived
    enc2's forward (archive.design) run the tensor-core kernels of
    lstm_tc.cuh in bf16 ('tc'); in f32 the step backward runs enc5's f32
    backward (lstm_f32.cuh, 'cluster'), enc2's forward enc5's f32 forward
    with two sums ('cluster'), and tm's forward step and step backward
    (mode XP's loops one step a launch in bf16) lstm_scan's f32 forward
    and backward one step a launch ('cluster'). Their C functions take
    enc5's argument lists: lstm_enc_backward's 38 (the P slab, the bf16
    weights, the phases) and lstm_enc_forward's 23 (the encoded inputs,
    the slab, the bf16 weights, the phases); tm's keep 16 and 25. The
    registers queries launch nothing and have no design."""
    cluster = 'tc' if cdt == 'bfloat16' else 'cluster'
    assert lstm_enc.design('lstm_enc_step_backward', TD[cdt]) == cluster
    assert archive.design('lstm_enc2_forward', TD[cdt]) == cluster
    for fn, design in (('lstm_tm_step_forward', cluster),
            ('lstm_tm_step_backward', cluster)):
        assert archive.design(fn, TD[cdt]) == design
        assert fn in archive.F32_FUNCTIONS
    for fn in ('lstm_archive_tc_usage', 'lstm_tm_tc_usage'):
        with pytest.raises(ValueError, match='not a launch'):
            archive.design(fn, TD[cdt])
    assert len(archive.KERNEL.functions['lstm_tm_step_forward']) == 16
    assert len(archive.KERNEL.functions['lstm_tm_step_backward']) == 25
    step = lstm_enc.KERNEL.functions['lstm_enc_step_backward']
    assert step == lstm_enc.KERNEL.functions['lstm_enc_backward']
    assert len(step) == 38
    enc2 = archive.KERNEL.functions['lstm_enc2_forward']
    assert enc2 == lstm_enc.KERNEL.functions['lstm_enc_forward']
    assert len(enc2) == 23
    with pytest.raises(ValueError, match='not a C function'):
        archive.design('lstm_enc_step_backward', TD[cdt])


@pytest.mark.parametrize('K,splits', [(131072, 66), (131072, 33), (1000, 1),
    (4000, 3), (1 << 20, 264), (70, 5)])
def test_splitk_partition_covers_k(K, splits):
    """The ring's partition (lstm_common.splitk_ranges, the C function
    ring_per_split's): `splits` ranges in order, each starting on a whole
    stage of 32 rows, that cover 0 .. K once; only the last ones may be
    short or empty."""
    ranges = lstm_common.splitk_ranges(K, splits)
    assert len(ranges) == splits
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    for (a, b), (c, _) in zip(ranges, ranges[1:]):
        assert b == c
    sizes = [b - a for a, b in ranges]
    per = sizes[0]
    assert per % lstm_common.SPLITK_STAGE == 0 or splits == 1 or per == K
    assert all(s <= per for s in sizes)
    full = [s == per for s in sizes]
    assert full == sorted(full, reverse=True)


@pytest.mark.parametrize('M,N,K,sms', [(128, 512, 131072, 132),
    (256, 512, 131072, 132), (49, 128, 131072, 132), (50, 128, 1000, 132),
    (256, 512, 48, 132), (128, 512, 131072, 78)])
def test_splitk_splits_contract(M, N, K, sms):
    """The split count: one wave of 128 x 128 tiles at two blocks an SM,
    at least one split and no more than one per 1024 rows of K (rounded
    up); lstm_scan's and cat's main shapes give 66 and 33 on 132 SMs."""
    n = lstm_common.splitk_count(M, N, K, sms)
    tiles = -(-M // 128) * -(-N // 128)
    assert 1 <= n <= max(1, -(-K // 1024))
    assert n == max(1, min(-(-2 * sms // tiles), -(-K // 1024)))
    if (M, N, K, sms) == (128, 512, 131072, 132):
        assert n == 66
    if (M, N, K, sms) == (256, 512, 131072, 132):
        assert n == 33


@pytest.mark.parametrize('M,N,K', [(256, 512, 4096), (50, 128, 4096),
    (256, 512, 16000), (50, 128, 131072), (256, 512, 131072), (129, 128, 100)])
def test_f32_splitk_splits_contract(M, N, K):
    """enc5's f32 split-K (csrc/lstm_f32.cuh) takes splitk_splits' count
    with a floor of F32_SPLIT_ROWS = 256 rows a split in place of 1024:
    one wave of 128 x 128 tiles at two blocks an SM where K allows, so
    that memory's 4096 rows (T 8, B 512) give its dW 16 splits, not 4."""
    n = lstm_common.splitk_count(M, N, K, 132, lstm_common.F32_SPLIT_ROWS)
    tiles = -(-M // 128) * -(-N // 128)
    assert n == max(1, min(-(-264 // tiles), -(-K // 256)))
    assert lstm_common.splitk_count(M, N, K, 132) <= n
    if (M, N, K) == (256, 512, 4096):
        assert n == 16


@pytest.mark.parametrize('M,N,K', [(32, 128, 3000), (50, 128, 777),
    (128, 512, 4096)])
def test_splitk_emulation_matches_plain_dw(M, N, K):
    """The plain emulation of the ring split-K (each split stage by stage,
    partials added in split order) against the plain contraction a^T b on
    bf16-valued operands (every product exact in f32, only the order of
    the sums differs: 1e-5 of max(1, max |a^T b|)), for several split
    counts: the result does not depend on the schedule beyond that."""
    rng = np.random.default_rng(M + N + K)
    a = torch.from_numpy(rng.standard_normal((K, M)).astype(np.float32)
        ).to(torch.bfloat16).float()
    b = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32)
        ).to(torch.bfloat16).float()
    want = a.t() @ b
    for splits in (1, 2, 7, max(1, -(-K // 1024))):
        got = lstm_common.splitk_reference(a, b, splits)
        assert_close(got, want, 1e-5, True, f'{splits} splits')
        assert torch.equal(got, lstm_common.splitk_reference(a, b, splits))
