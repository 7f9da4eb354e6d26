"""lstm_scan, lstm_scan_fused and lstm_scan_enc of the PyTorch port, and the
tensor-core schedules of every resident bf16 kernel pair (the archived
enc2, enc3, enc4 and enc6 backwards among them), against the JAX package,
on the CPU.

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

from pufferlib_tpu_torch.ops.cuda import (
    archive, lstm_cat, lstm_common, lstm_enc, lstm_scan)
from pufferlib_tpu_torch.ops.cuda.archive import (
    lstm_enc2, lstm_enc3, lstm_enc4, lstm_enc6)

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


def enc4_tc_schedule(*args, splits=3):
    """What the archived enc4's bf16 backward (csrc/lstm_tc.cuh
    tc::backward in mode ENC4) computes, in its order, with the forward
    it shares with enc5: enc5_tc_schedule with the reverse loop's
    activations in f32 (db still from the rounded dgates) and dW split
    `splits` ways in the ring's partition."""
    return enc5_tc_schedule(*args, round_acts=False, splits=splits)


def enc2_tc_schedule(*args, splits=3):
    """What the archived enc2's bf16 backward (csrc/lstm_tc.cuh
    tc::backward in mode ENC2) computes, in its order, with the forward's
    function (its FMA kernel's): enc4_tc_schedule with FUSED's bias order
    and the projection rounded, the forward's gates cdt(x_t @ W_ih + b) +
    h @ W_hh and the P slab's cdt(x @ W_ih + b) + h_prev @ W_hh."""
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


@pytest.mark.parametrize('cdt', sorted(TD))
@pytest.mark.parametrize('kind', ['enc2', 'enc3', 'enc4', 'enc6'])
def test_archived_backward_design(kind, cdt):
    """Which design each archived backward runs (archive.backward_design):
    in bf16 all four the tensor-core kernels of lstm_tc.cuh ('tc'); in f32
    lstm_archive.cu's FMA kernel ('fma'). The C functions' argument lists
    follow it: the tensor-core ones take lstm_enc_backward's (the P slab,
    the bf16 weights, the phases), which also carry the FMA kernel's f32
    scratch (enc3's and enc6's activations slab in the P slab's place)."""
    fn = f'lstm_{kind}_backward'
    design = archive.backward_design(fn, TD[cdt])
    assert design == ('tc' if cdt == 'bfloat16' else 'fma')
    args = archive.KERNEL.functions[fn]
    enc_backward = lstm_enc.KERNEL.functions['lstm_enc_backward']
    assert args == enc_backward and len(args) == 38
    assert fn in archive.TC_BACKWARDS


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
