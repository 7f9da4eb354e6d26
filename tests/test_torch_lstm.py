"""The LSTM of the PyTorch port against the JAX package.

- The plain versions of the enc5 and cat kernels (forward, and the
  explicit backward that follows the TPU kernels' _bwd_kernel) against
  the Pallas kernels themselves, run in interpret mode on the CPU, from
  the same numpy inputs (cat also at the JAX package's own input width
  96 with hidden 128): f32 to 1e-5 (the same f32 products, summed in
  another order); bf16 to 1e-2, two and a half bf16 ulps of a value of
  order 1, for a sum that lands on the other side of a rounding boundary
  and rounds the other way.
- lstm_route, the decision LSTMWrapper takes from shapes before any
  launch, over a table of cases.
- LSTMWrapper and RecurrentPolicy against the JAX modules from the same
  flax-initialised weights (convert.lstm_state_dict), in f32: logits,
  value and state to 1e-5, weight gradients to 1e-4. On the CPU the
  port's 'enc5' and 'cat' run the kernels' plain versions; JAX runs its
  'off' scan (use_pallas is off on the CPU), which is the same function.
  Also at input_size 96 with hidden 128, through 'off' and cat.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from pufferlib_tpu import spaces as jspaces
from pufferlib_tpu.models import Default as JaxDefault
from pufferlib_tpu.models import LSTMWrapper as JaxLSTMWrapper
from pufferlib_tpu.models import RecurrentPolicy as JaxRecurrentPolicy
from pufferlib_tpu.ops.pallas.lstm_cat import lstm_scan_cat as jax_scan_cat
from pufferlib_tpu.ops.pallas.lstm_enc import lstm_scan_enc_reference
from pufferlib_tpu.ops.pallas.lstm_enc5 import lstm_scan_enc5 as jax_scan_enc5

import pufferlib_tpu_torch.models as models
from pufferlib_tpu_torch import spaces
from pufferlib_tpu_torch.convert import lstm_params, lstm_state_dict
from pufferlib_tpu_torch.models import (
    Default, LSTMWrapper, RecurrentPolicy, count_params, lstm_route)
from pufferlib_tpu_torch.ops.cuda import lstm_common
from pufferlib_tpu_torch.ops.cuda.lstm_cat import lstm_scan_cat
from pufferlib_tpu_torch.ops.cuda.lstm_enc import lstm_scan_enc5

torch.set_num_threads(1)

DTYPES = {'float32': (jnp.float32, torch.float32, 1e-5),
    'bfloat16': (jnp.bfloat16, torch.bfloat16, 1e-2)}
T, B, F, H = 3, 16, 49, 32
OBS_SHAPE = (7, 7)


def _arrays(seed, *shapes, scale=0.3):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*s) * scale).astype(np.float32) for s in shapes]


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.array(jnp.asarray(t, jnp.float32))


def _assert_close(got, want, atol, what):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=atol,
        err_msg=what)


def _cotangents(seed, hidden=H):
    """Upstream gradients of outs, hT and cT."""
    return _arrays(seed, (T, B, hidden), (B, hidden), (B, hidden), scale=1.0)


def _jax_grads(fn, args, argnums, jd, cot):
    go, ghT, gcT = cot

    def loss(*a):
        o, h, c = fn(*a, jd)
        return (jnp.sum(o.astype(jnp.float32) * go) + jnp.sum(h * ghT)
            + jnp.sum(c * gcT))
    return jax.grad(loss, argnums=argnums)(*args)


def _torch_outs_and_grads(fn, args, td, cot):
    outs = fn(*args, td)
    go, ghT, gcT = (torch.from_numpy(a) for a in cot)
    ((outs[0].float() * go).sum() + (outs[1] * ghT).sum()
        + (outs[2] * gcT).sum()).backward()
    return outs


@pytest.mark.parametrize('D,hidden', [(32, 32), (96, 128)])
@pytest.mark.parametrize('dtype', sorted(DTYPES))
def test_cat_plain_matches_pallas_kernel(dtype, D, hidden):
    """Forward and every gradient, dx included; input width 96 with hidden
    128 is the JAX package's own cat shape (tests/test_pallas.py)."""
    _check_cat_plain(dtype, D, hidden)


@pytest.mark.parametrize('dtype', sorted(DTYPES))
def test_cat_plain_matches_pallas_kernel_streamed_shape(dtype):
    """The same at input width 9 with hidden 256, a shape only cat's
    streamed design serves on the card, with the weights at the trainer's
    scale (1 / sqrt(fan-in)): the tolerance is DTYPES' times the largest
    value of each output or gradient, at least 1 (sums over K = 265 and
    4H = 1024 terms)."""
    _check_cat_plain(dtype, 9, 256, w_scale=265 ** -0.5)


@pytest.mark.parametrize('dtype', sorted(DTYPES))
def test_cat_plain_matches_pallas_kernel_resident_hidden_256(dtype):
    """The same at input width and hidden size 256, config.yaml's nethack,
    minihack, nmmo and nmmo3 LSTMs: in f32 cat's resident design serves it
    on the card (clusters of 8 blocks), in bf16 the streamed one. Weights
    at 1 / sqrt(fan-in) and tolerances relative, as the streamed shape's
    (sums over K = 512 and 4H = 1024 terms)."""
    _check_cat_plain(dtype, 256, 256, w_scale=512 ** -0.5)


@pytest.mark.parametrize('dtype', sorted(DTYPES))
def test_cat_plain_matches_pallas_kernel_streamed_hidden_48(dtype):
    """The same at hidden 48, no multiple of 32: on the card the streamed
    design runs it padded to 64 units (lstm_common.pad_cell)."""
    _check_cat_plain(dtype, 9, 48, w_scale=57 ** -0.5)


@pytest.mark.parametrize('hidden', [48, 100])
@pytest.mark.parametrize('kind', ['cat', 'enc5'])
def test_stream_padding_is_exact(kind, hidden):
    """The streamed launchers' padding (lstm_common.pad_cell, pad_units,
    unpad_units, unpad_cell_grads; the steps of _launch_stream_forward and
    _launch_stream_backward) around the plain scans in f32: padded to
    stream_hidden(H) units, run, and sliced back, against the scan run at
    H. The padded units' gate pre-activations are exactly 0, so their h
    and c stay 0 and their dgates are 0: every output and gradient agrees
    to 1e-5, and exactly but for the order in which the CPU's matrix
    products add the real terms (K and N change with the padding)."""
    from pufferlib_tpu_torch.ops.cuda.lstm_cat import (
        lstm_cat_backward_reference, lstm_cat_reference, unpad_outputs)
    from pufferlib_tpu_torch.ops.cuda.lstm_enc import (
        lstm_enc_backward_reference, lstm_enc_reference)
    cdt, Dx, Fx = torch.float32, 24, 10
    Hp = lstm_common.stream_hidden(hidden)
    assert Hp % lstm_common.STREAM_UNITS == 0 and Hp > hidden
    x, feats, w_enc, b_enc, h0, c0, w_ih, w_hh, b, g_outs, g_hT, g_cT = (
        torch.from_numpy(a) for a in _arrays(5, (4, 8, Dx), (4, 8, Fx),
            (Fx, Dx), (Dx,), (8, hidden), (8, hidden), (Dx, 4 * hidden),
            (hidden, 4 * hidden), (4 * hidden,), (4, 8, hidden), (8, hidden),
            (8, hidden)))
    fwd, bwd = ((lstm_cat_reference, lstm_cat_backward_reference)
        if kind == 'cat' else (lstm_enc_reference, lstm_enc_backward_reference))

    def run(h0, c0, w_ih, w_hh, b, g_outs, g_hT, g_cT):
        args = (x, h0, c0) if kind == 'cat' else (feats, h0, c0, w_enc, b_enc)
        out = fwd(*args, w_ih, w_hh, b, cdt)
        return out, bwd(*args, w_ih, w_hh, b, out[0], out[3], g_outs, g_hT,
            g_cT, cdt)
    want, want_b = run(h0, c0, w_ih, w_hh, b, g_outs, g_hT, g_cT)
    pad = lambda t: lstm_common.pad_units(t, hidden, Hp)
    got, got_b = run(pad(h0), pad(c0), *lstm_common.pad_cell(w_ih, w_hh, b,
        hidden, Hp), pad(g_outs), pad(g_hT), pad(g_cT))
    assert got[0].shape == (4, 8, Hp)
    # the padded units' state is exactly zero at every step
    for t in (got[0], got[3]):
        assert not t.reshape(-1, Hp)[:, hidden:].any()
    got = unpad_outputs(hidden, *got)
    n = 1 if kind == 'cat' else 0   # dx leads cat's gradients
    got_b = (*got_b[:n], *unpad_outputs(hidden, *got_b[n:n + 2]),
        *got_b[n + 2:-3], *lstm_common.unpad_cell_grads(*got_b[-3:], hidden))
    assert len(got_b) == len(want_b)
    for i, (a, w) in enumerate(zip(got + got_b, want + want_b)):
        assert a.shape == w.shape, i
        _assert_close(a, w, 1e-5, f'{kind} output {i}')


def _check_cat_plain(dtype, D, hidden, w_scale=None):
    """w_scale: the weights' scale, and tolerances relative to each
    value's size; None keeps _arrays' 0.3 and DTYPES' absolute ones."""
    jd, td, tol = DTYPES[dtype]
    x, h0, c0, w_ih, w_hh, b = _arrays(1, (T, B, D), (B, hidden),
        (B, hidden), (D, 4 * hidden), (hidden, 4 * hidden), (4 * hidden,))
    relative = w_scale is not None
    if relative:
        w_ih, w_hh = (w * np.float32(w_scale / 0.3) for w in (w_ih, w_hh))
    xj = jnp.asarray(x).astype(jd)
    args = (xj, h0, c0, w_ih, w_hh, b)
    cot = _cotangents(2, hidden)
    with pltpu.force_tpu_interpret_mode():
        want = jax_scan_cat(*args, jd)
        want_grads = _jax_grads(jax_scan_cat, args, tuple(range(6)), jd, cot)
    tensors = [torch.from_numpy(_np(xj)).to(td)] + [torch.from_numpy(a)
        for a in (h0, c0, w_ih, w_hh, b)]
    for t in tensors:
        t.requires_grad_()
    got = _torch_outs_and_grads(lstm_scan_cat, tensors, td, cot)
    assert got[0].dtype == td and got[1].dtype == torch.float32

    def atol(w):
        return tol * max(1.0, np.abs(_np(w)).max()) if relative else tol
    for name, a, w in zip(('outs', 'hT', 'cT'), got, want):
        _assert_close(a, w, atol(w), name)
    names = ('dx', 'dh0', 'dc0', 'dw_ih', 'dw_hh', 'db')
    for name, t, w in zip(names, tensors, want_grads):
        assert t.grad.dtype == t.dtype, name
        _assert_close(t.grad, w, atol(w), name)


@pytest.mark.parametrize('dtype', sorted(DTYPES))
def test_enc5_plain_matches_pallas_kernel(dtype):
    """Forward and every gradient but the features' (zero by
    contract)."""
    _check_enc5_plain(dtype, F, H, H)


# (dtype, F, D, hidden): shapes only enc5's streamed design serves on the
# card: hidden 256 with an encoder width apart from it and 200 features in
# f32; 800 features in bf16, past the tensor-core encoder's 768; hidden 48,
# no multiple of 32, which the launchers pad to 64
ENC5_STREAMED = [('float32', 200, 96, 256), ('bfloat16', 800, 128, 128),
    ('float32', 49, 48, 48), ('bfloat16', 49, 40, 48)]


@pytest.mark.parametrize('dtype,feats,D,hidden', ENC5_STREAMED)
def test_enc5_plain_matches_pallas_kernel_streamed_shape(dtype, feats, D,
        hidden):
    """The same at the streamed design's shapes, with the weights at the
    trainer's scale (1 / sqrt(fan-in)): the tolerance is DTYPES' times the
    largest value of each output or gradient, at least 1 (sums over up to
    800 features and 4H = 1024 gate columns)."""
    _check_enc5_plain(dtype, feats, D, hidden, relative=True)


def _check_enc5_plain(dtype, F, D, hidden, relative=False):
    """relative: the weights at 1 / sqrt(fan-in) and tolerances relative
    to each value's size; else _arrays' 0.3 and DTYPES' absolute ones."""
    jd, td, tol = DTYPES[dtype]
    feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b = _arrays(3, (T, B, F),
        (B, hidden), (B, hidden), (F, D), (D,), (D, 4 * hidden),
        (hidden, 4 * hidden), (4 * hidden,))
    if relative:
        w_enc = w_enc * np.float32(F ** -0.5 / 0.3)
        w_ih = w_ih * np.float32((D + hidden) ** -0.5 / 0.3)
        w_hh = w_hh * np.float32((D + hidden) ** -0.5 / 0.3)
    fj = jnp.asarray(feats * 3).astype(jd)
    args = (fj, h0, c0, w_enc, b_enc, w_ih, w_hh, b)
    cot = _cotangents(4, hidden)
    argnums = tuple(range(1, 8))
    with pltpu.force_tpu_interpret_mode():
        want = jax_scan_enc5(*args, jd)
        want_grads = _jax_grads(jax_scan_enc5, args, argnums, jd, cot)
    tensors = [torch.from_numpy(_np(fj)).to(td)] + [
        torch.from_numpy(a).requires_grad_()
        for a in (h0, c0, w_enc, b_enc, w_ih, w_hh, b)]
    got = _torch_outs_and_grads(lstm_scan_enc5, tensors, td, cot)

    def atol(w):
        return tol * max(1.0, np.abs(_np(w)).max()) if relative else tol
    for name, a, w in zip(('outs', 'hT', 'cT'), got, want):
        _assert_close(a, w, atol(w), name)
    names = ('dh0', 'dc0', 'dw_enc', 'db_enc', 'dw_ih', 'dw_hh', 'db')
    for name, t, w in zip(names, tensors[1:], want_grads):
        _assert_close(t.grad, w, atol(w), name)
    if dtype == 'float32' and not relative:
        # and the JAX package's pure reference (autograd of a scan)
        ref = lstm_scan_enc_reference(*args, jd)
        ref_grads = _jax_grads(lstm_scan_enc_reference, args, argnums, jd,
            cot)
        for name, a, w in zip(('outs', 'hT', 'cT'), got, ref):
            _assert_close(a, w, tol, name)
        for name, t, w in zip(names, tensors[1:], ref_grads):
            _assert_close(t.grad, w, 1e-4, name)


def _jax_lstm(num_layers=1, obs_shape=OBS_SHAPE, seed=0, space=None):
    jmod = JaxLSTMWrapper(policy=JaxDefault(obs_shape=obs_shape,
        action_space=space or jspaces.Discrete(5), hidden_size=H),
        obs_shape=obs_shape, input_size=H, hidden_size=H,
        num_layers=num_layers, use_pallas=False)
    x = jnp.zeros((2, 2) + obs_shape, jnp.float32)
    params = jmod.init(jax.random.PRNGKey(seed), x)
    return jmod, jax.tree.map(np.asarray, params)


def _port_lstm(params, num_layers=1, kernel='off', use_kernel=None,
        space=None):
    mod = LSTMWrapper(Default(obs_shape=OBS_SHAPE,
        action_space=space or spaces.Discrete(5), hidden_size=H),
        obs_shape=OBS_SHAPE, input_size=H, hidden_size=H,
        num_layers=num_layers, kernel=kernel, use_kernel=use_kernel)
    mod.load_state_dict(lstm_state_dict(params))
    return mod


def _state(seed, num_layers, rows):
    h, c = _arrays(seed, (num_layers, rows, H), (num_layers, rows, H),
        scale=0.5)
    return h, c


LAYOUTS = {
    # (input shape, time_major)
    'batch_major': ((B, T) + OBS_SHAPE, False),
    'time_major': ((T, B) + OBS_SHAPE, True),
    'one_step': ((B,) + OBS_SHAPE, False),
}
KINDS = {'off': dict(kernel='off'), 'enc5': dict(kernel='enc5',
    use_kernel=True), 'cat': dict(kernel='cat', use_kernel=True)}


@pytest.mark.parametrize('layout', sorted(LAYOUTS))
@pytest.mark.parametrize('kind', sorted(KINDS))
def test_lstm_wrapper_matches_jax(kind, layout):
    shape, time_major = LAYOUTS[layout]
    jmod, params = _jax_lstm()
    mod = _port_lstm(params, **KINDS[kind])
    x = np.random.RandomState(6).randn(*shape).astype(np.float32)
    h0, c0 = _state(7, 1, B)
    jlogits, jvalue, (jh, jc) = jmod.apply(params, jnp.asarray(x),
        (jnp.asarray(h0), jnp.asarray(c0)), time_major=time_major)
    logits, value, (h, c) = mod(torch.from_numpy(x),
        (torch.from_numpy(h0), torch.from_numpy(c0)), time_major=time_major)
    rows = B if layout == 'one_step' else B * T
    assert logits.shape == (rows, 5) and value.shape == (rows, 1)
    for name, a, w in (('logits', logits, jlogits), ('value', value, jvalue),
            ('h', h, jh), ('c', c, jc)):
        _assert_close(a, w, 1e-5, name)


@pytest.mark.parametrize('kind', sorted(KINDS))
def test_lstm_wrapper_gradients_match_jax(kind):
    """Weight gradients of one loss through each kind, encoder included
    (its backward runs inside the enc5 kernel)."""
    jmod, params = _jax_lstm(seed=1)
    mod = _port_lstm(params, **KINDS[kind])
    x = np.random.RandomState(8).randn(B, T, *OBS_SHAPE).astype(np.float32)
    h0, c0 = _state(9, 1, B)

    def jloss(p):
        lo, v, (h, c) = jmod.apply(p, jnp.asarray(x),
            (jnp.asarray(h0), jnp.asarray(c0)))
        return (jnp.sum(jax.nn.log_softmax(lo) ** 2) + jnp.sum(v * 0.7)
            + jnp.sum(h * c))
    jgrads = lstm_state_dict(jax.tree.map(np.asarray,
        jax.grad(jloss)(params)))
    lo, v, (h, c) = mod(torch.from_numpy(x),
        (torch.from_numpy(h0), torch.from_numpy(c0)))
    (torch.log_softmax(lo, -1).square().sum() + (v * 0.7).sum()
        + (h * c).sum()).backward()
    for name, p in mod.named_parameters():
        _assert_close(p.grad, jgrads[name], 1e-4, name)


def test_two_layers_route_every_layer_through_cat(monkeypatch):
    """num_layers=2 with the kernels on: enc5 cannot fuse, so both layers
    run the cat kernel (its plain version here), matching JAX."""
    jmod, params = _jax_lstm(num_layers=2, seed=2)
    mod = _port_lstm(params, num_layers=2, kernel='enc5', use_kernel=True)
    calls = []

    def counting_cat(*args):
        calls.append(args[0].shape)
        return lstm_scan_cat(*args)
    monkeypatch.setattr(models, 'lstm_scan_cat', counting_cat)
    monkeypatch.setattr(models, 'lstm_scan_enc5', None)
    x = np.random.RandomState(10).randn(B, T, *OBS_SHAPE).astype(
        np.float32)
    h0, c0 = _state(11, 2, B)
    jlogits, jvalue, (jh, jc) = jmod.apply(params, jnp.asarray(x),
        (jnp.asarray(h0), jnp.asarray(c0)))
    logits, value, (h, c) = mod(torch.from_numpy(x),
        (torch.from_numpy(h0), torch.from_numpy(c0)))
    assert calls == [(T, B, H), (T, B, H)]
    for name, a, w in (('logits', logits, jlogits), ('value', value, jvalue),
            ('h', h, jh), ('c', c, jc)):
        _assert_close(a, w, 1e-5, name)


def test_kernel_selection(monkeypatch):
    """use_kernel=None runs the 'off' scan on the CPU (as JAX does off
    the TPU); use_kernel=True with T > 1 runs the selected kernel; T == 1
    is the plain step whatever the setting."""
    _, params = _jax_lstm(seed=3)
    used = []
    monkeypatch.setattr(models, 'lstm_scan_enc5',
        lambda *a: used.append('enc5') or lstm_scan_enc5(*a))
    monkeypatch.setattr(models, 'lstm_scan_cat',
        lambda *a: used.append('cat') or lstm_scan_cat(*a))
    x = torch.zeros((B, T) + OBS_SHAPE)
    for kernel in ('enc5', 'cat'):
        _port_lstm(params, kernel=kernel)(x)
        assert used == []
        _port_lstm(params, kernel=kernel, use_kernel=True)(x[:, 0])
        assert used == []
        _port_lstm(params, kernel=kernel, use_kernel=True)(x)
        assert used == [kernel]
        used.clear()
    with pytest.raises(ValueError, match='kernel'):
        _port_lstm(params, kernel='enc4')
    with pytest.raises(ValueError, match='shape'):
        _port_lstm(params)(torch.zeros(B, 5))


def test_kernels_refuse_shapes_they_do_not_serve():
    """Two checks: the FMA kernels (every kernel in f32, and every one but
    cat's and fused's in bf16) take hidden sizes 32, 64, 128 with the
    input width equal to the hidden size; the bf16 tensor-core kernels of
    cat and fused take those hidden sizes with input widths that are
    multiples of 8 up to what a GEMM block's shared memory holds (640 at
    hidden 128, 704 at 32 and 64)."""
    cuda = torch.device('cuda')
    lstm_common.check_kernel_shape(128, 128, cuda)
    with pytest.raises(ValueError, match='hidden'):
        lstm_common.check_kernel_shape(64, 128, cuda)
    with pytest.raises(ValueError, match='hidden'):
        lstm_common.check_kernel_shape(96, 96, cuda)
    with pytest.raises(ValueError, match='device'):
        lstm_common.check_kernel_shape(32, 32, torch.device('cpu'))
    bf16, f32 = torch.bfloat16, torch.float32
    assert [lstm_common.tc_max_input(h) for h in (32, 64, 128)] == [
        704, 704, 640]
    for D, hidden in ((96, 128), (8, 32), (640, 128), (704, 64), (128, 128)):
        lstm_common.check_cell_kernel_shape(D, hidden, bf16, cuda)
    lstm_common.check_cell_kernel_shape(64, 64, f32, cuda)
    for D, hidden, cdt, message in ((100, 128, bf16, 'multiples of 8'),
            (648, 128, bf16, 'up to 640'), (712, 32, bf16, 'up to 704'),
            (256, 256, bf16, 'hidden sizes'), (96, 96, bf16, 'hidden sizes'),
            (96, 128, f32, 'input width equal to the hidden size')):
        with pytest.raises(ValueError, match=message):
            lstm_common.check_cell_kernel_shape(D, hidden, cdt, cuda)
    with pytest.raises(ValueError, match='device'):
        lstm_common.check_cell_kernel_shape(96, 128, bf16, torch.device('cpu'))
    with pytest.raises(ValueError, match='dtype|bfloat16|float32'):
        lstm_scan_cat(torch.zeros(T, B, H), *(torch.zeros(B, H),) * 2,
            torch.zeros(H, 4 * H), torch.zeros(H, 4 * H),
            torch.zeros(4 * H), torch.bfloat16)


# (D, H, cdt) -> the design cat's wrapper launches on the card, or the
# message of its refusal. The resident kernels take H 32-128 with D % 8 ==
# 0 in bf16 and D == H at H 32-256 in f32 (H 256 on clusters of 8 blocks);
# lstm_scan_fused's f32 kernels keep H 32-128 (cell_shape_error)
CAT_DESIGNS = [
    ((256, 256, torch.float32), 'resident'),
    ((128, 128, torch.float32), 'resident'),
    ((32, 32, torch.float32), 'resident'),
    ((96, 128, torch.bfloat16), 'resident'),
    ((256, 256, torch.bfloat16), 'stream'),
    ((9, 256, torch.float32), 'stream'),
    ((128, 256, torch.float32), 'stream'),
    ((512, 512, torch.float32), 'stream'),
    ((200, 200, torch.float32), 'stream'),
    ((96, 128, torch.float32), 'stream'),
    ((832, 832, torch.float32), 'up to 800'),
]


@pytest.mark.parametrize('case', range(len(CAT_DESIGNS)))
def test_cat_design(case):
    """cat_design: the resident kernels where cat_cell_shape_error serves
    the shape (f32 H 256 among them), else the streamed ones;
    cat_shape_error names what neither takes. lstm_scan_fused's f32 reach
    stays H 32-128, and the FMA reach the archived kinds name is
    unchanged."""
    (D, hidden, cdt), want = CAT_DESIGNS[case]
    err = lstm_common.cat_shape_error(D, hidden, cdt)
    if want in ('resident', 'stream'):
        assert err is None
        assert lstm_common.cat_design(D, hidden, cdt) == want
        assert (lstm_common.cat_cell_shape_error(D, hidden, cdt) is None) \
            == (want == 'resident')
    else:
        assert err is not None and want in err
    if cdt == torch.float32 and D == hidden == 256:
        with pytest.raises(ValueError, match=r'\(32, 64, 128\) with input'):
            lstm_common.check_cell_kernel_shape(D, hidden, cdt,
                torch.device('cuda'))
        assert '(32, 64, 128)' in lstm_common.fma_shape_error(D, hidden)
        assert '(32, 64, 128, 256)' in lstm_common.cat_cell_shape_error(
            D, 128 + hidden, cdt)


# config.yaml's sections that train an LSTM (use_rnn), with the update's
# batch rows (minibatch / bptt) and the design cat runs there in f32,
# config.yaml's dtype (it names none). The procgen -exp sections have no
# Recurrent dict and no policy hidden_size: config.cli gives D = H = 128
# (their ProcgenResnet emits mlp_width 256 features, which an LSTM of input
# 128 refuses at its first call, in the JAX package as in the port)
CONFIG_LSTMS = {
    'nethack': (256, 256, 512, 'resident'),
    'minihack': (256, 256, 512, 'resident'),
    'nmmo': (256, 256, 512, 'resident'),
    'nmmo3': (256, 256, 1024, 'resident'),
    'pokemon_red': (512, 512, 512, 'stream'),
    'bigfish-exp': (128, 128, 1152, 'resident'),
    'starpilot-exp': (128, 128, 1152, 'resident'),
}


@pytest.mark.parametrize('section', sorted(CONFIG_LSTMS))
def test_config_lstm_sections_cat_design(section):
    """Each LSTM section of config.yaml, read by config.cli.load_config,
    with (D, H) worked out as cli.make_policy does (the env package's
    Recurrent dict, then config.yaml's rnn section, the hidden size from
    it or from the policy's hidden_size, 128 by default; the input size
    the hidden size unless given): on the card the default route sends it
    to cat (its policy has no encoder contract), and cat to the design
    named. H 256 (nethack, minihack, nmmo, nmmo3) runs cat's resident f32
    pair; pokemon_red's H 512 the streamed one."""
    from pufferlib_tpu_torch.config import cli
    args, env_module, _ = cli.load_config(section, argv=['--env', section])
    assert args.use_rnn
    rnn = dict(getattr(env_module, 'Recurrent', None) or {})
    rnn.update(dict(args.rnn))
    hidden = rnn.pop('hidden_size', dict(args.policy).get('hidden_size',
        128))
    D = rnn.get('input_size', hidden)
    B = args.train.minibatch_size // args.train.bptt_horizon
    want_D, want_H, want_B, design = CONFIG_LSTMS[section]
    assert (D, hidden, B) == (want_D, want_H, want_B)
    f32 = torch.float32
    assert lstm_route('enc5', None, 'cuda', args.train.bptt_horizon, D,
        hidden, None, 1, f32) == 'cat'
    assert lstm_common.cat_shape_error(D, hidden, f32) is None
    assert lstm_common.cat_design(D, hidden, f32) == design


# lstm_route's arguments at the LSTM trainer's shapes (bench.py's LSTM
# line: T = 16, input and hidden 128, Default's 49 features, bf16, on the
# card), and each case's changes to them with the route it must take
ROUTE_BENCH = dict(kernel='enc5', use_kernel=None, device='cuda', T=16,
    D=128, H=128, F=49, num_layers=1, cdt=torch.bfloat16)
ROUTES = {
    'bench shapes': ({}, 'enc5'),
    'two layers': (dict(num_layers=2), 'cat'),
    'no encoder contract': (dict(F=None), 'cat'),
    'input 96 bf16': (dict(D=96), 'enc5'),
    'input 96 f32': (dict(D=96, cdt=torch.float32), 'enc5'),
    'features 200': (dict(F=200), 'enc5'),
    'features at the encoder limit': (dict(F=768), 'enc5'),
    'features past the encoder limit': (dict(F=769), 'enc5'),
    'features 200 f32': (dict(F=200, cdt=torch.float32), 'enc5'),
    'features 128 f32': (dict(F=128, cdt=torch.float32), 'enc5'),
    'input 96, two layers': (dict(D=96, num_layers=2), 'cat'),
    'hidden 256': (dict(D=256, H=256), 'enc5'),
    'hidden 256, use_kernel False': (dict(D=256, H=256, use_kernel=False),
        'off'),
    'hidden 256, kernel off': (dict(D=256, H=256, kernel='off'), 'off'),
    'hidden 256, cpu': (dict(D=256, H=256, device='cpu'), 'off'),
    'input 100': (dict(D=100), 'enc5'),
    'kernel cat': (dict(kernel='cat'), 'cat'),
    'kernel off': (dict(kernel='off'), 'off'),
    'cpu': (dict(device='cpu'), 'off'),
    'one step': (dict(T=1), 'off'),
    'one step, use_kernel': (dict(T=1, use_kernel=True, D=256, H=256), 'off'),
    'use_kernel False': (dict(use_kernel=False), 'off'),
    'use_kernel': (dict(use_kernel=True), 'enc5'),
    'use_kernel, two layers': (dict(use_kernel=True, num_layers=2), 'cat'),
    'use_kernel, cpu, input 96 f32': (dict(use_kernel=True, device='cpu',
        D=96, cdt=torch.float32), 'enc5'),
    'use_kernel, cat, input 96': (dict(use_kernel=True, kernel='cat', D=96),
        'cat'),
    'use_kernel, hidden 256': (dict(use_kernel=True, D=256, H=256), 'enc5'),
    'use_kernel, features 200': (dict(use_kernel=True, F=200), 'enc5'),
    'use_kernel, input 96': (dict(use_kernel=True, D=96), 'enc5'),
    'use_kernel, features past the encoder limit': (dict(use_kernel=True,
        F=769), 'enc5'),
    'use_kernel, features 200 f32': (dict(use_kernel=True, F=200,
        cdt=torch.float32), 'enc5'),
    'use_kernel, cat, input 96 f32': (dict(use_kernel=True, kernel='cat',
        D=96, cdt=torch.float32), 'cat'),
    # the streamed design (csrc/lstm_cat_stream.cu) serves the shapes the
    # resident kernels refuse, for enc5 and for cat: hidden sizes up to 800
    # in f32 and 1472 in bf16 (others padded to a multiple of 32), any input
    # and feature width
    'hidden 512': (dict(D=512, H=512), 'enc5'),
    'hidden 256 f32': (dict(D=256, H=256, cdt=torch.float32), 'enc5'),
    'hidden 512 f32': (dict(D=512, H=512, cdt=torch.float32), 'enc5'),
    'input 96, hidden 128 f32': (dict(D=96, H=128, cdt=torch.float32),
        'enc5'),
    'features 800': (dict(F=800), 'enc5'),
    'features 147 f32': (dict(F=147, cdt=torch.float32), 'enc5'),
    'hidden 800 f32': (dict(D=800, H=800, cdt=torch.float32), 'enc5'),
    'hidden 832 f32': (dict(D=832, H=832, cdt=torch.float32),
        'up to 800.*use_kernel=False'),
    'hidden 1472': (dict(D=1472, H=1472), 'enc5'),
    'hidden 1504': (dict(D=1504, H=1504), 'up to 1472.*use_kernel=False'),
    'hidden 48': (dict(D=48, H=48), 'enc5'),
    'hidden 48 f32': (dict(D=48, H=48, cdt=torch.float32), 'enc5'),
    'use_kernel, hidden 48': (dict(use_kernel=True, D=48, H=48), 'enc5'),
    'hidden 100': (dict(D=100, H=100), 'enc5'),
    'hidden 100 f32': (dict(D=100, H=100, cdt=torch.float32), 'enc5'),
    'hidden 200': (dict(D=200, H=200), 'enc5'),
    'hidden 200 f32': (dict(D=200, H=200, cdt=torch.float32), 'enc5'),
    'use_kernel, hidden 200 f32': (dict(use_kernel=True, D=200, H=200,
        cdt=torch.float32), 'enc5'),
    'hidden 790 f32': (dict(D=790, H=790, cdt=torch.float32), 'enc5'),
    'hidden 801 f32': (dict(D=801, H=801, cdt=torch.float32),
        'up to 800.*use_kernel=False'),
    'use_kernel, hidden 801 f32': (dict(use_kernel=True, D=801, H=801,
        cdt=torch.float32), 'up to 800'),
    'hidden 1473': (dict(D=1473, H=1473), 'up to 1472.*use_kernel=False'),
    'use_kernel, hidden 512 f32': (dict(use_kernel=True, D=512, H=512,
        cdt=torch.float32), 'enc5'),
    'hidden 256, cpu, use_kernel': (dict(D=256, H=256, device='cpu',
        use_kernel=True), 'enc5'),
    'no encoder contract, hidden 256 bf16': (dict(F=None, D=256, H=256),
        'cat'),
    'no encoder contract, hidden 256 f32': (dict(F=None, D=256, H=256,
        cdt=torch.float32), 'cat'),
    'no encoder contract, hidden 512 bf16': (dict(F=None, D=512, H=512),
        'cat'),
    'no encoder contract, hidden 512 f32': (dict(F=None, D=512, H=512,
        cdt=torch.float32), 'cat'),
    'two layers, hidden 256 f32': (dict(num_layers=2, D=256, H=256,
        cdt=torch.float32), 'cat'),
    'kernel cat, hidden 512': (dict(kernel='cat', D=512, H=512), 'cat'),
    'no encoder contract, input 96 f32': (dict(F=None, D=96,
        cdt=torch.float32), 'cat'),
    'no encoder contract, input 100': (dict(F=None, D=100), 'cat'),
    'no encoder contract, input 9, hidden 64': (dict(F=None, D=9, H=64),
        'cat'),
    'no encoder contract, hidden 100': (dict(F=None, D=100, H=100), 'cat'),
    'no encoder contract, hidden 200 f32': (dict(F=None, D=200, H=200,
        cdt=torch.float32), 'cat'),
    'no encoder contract, hidden 200': (dict(F=None, D=200, H=200), 'cat'),
    'no encoder contract, hidden 801 f32': (dict(F=None, D=801, H=801,
        cdt=torch.float32), 'up to 800.*use_kernel=False'),
    'use_kernel, no encoder contract, hidden 512 f32': (dict(
        use_kernel=True, F=None, D=512, H=512, cdt=torch.float32), 'cat'),
    'use_kernel, cat, hidden 100': (dict(use_kernel=True, kernel='cat',
        D=100, H=100), 'cat'),
}


@pytest.mark.parametrize('case', list(ROUTES))
def test_lstm_route(case):
    """The default (use_kernel=None) takes, on the card with T > 1, enc5
    where it can fuse (one layer, the encoder contract), as the JAX
    package does, else cat; each through its resident kernels where they
    serve the shape, else its streamed design (any H up to 800 in f32 and
    1472 in bf16, padded to a multiple of 32; any D and F), and raises for a shape
    neither serves (a hidden size that, padded to a multiple of 32, is past
    800 in f32 or 1472 in bf16), naming use_kernel=False;
    use_kernel=True runs the selected kernel and, on the card, raises for
    a shape it refuses (the expected value is then the error's message).
    The plain scan runs on the card only where the caller asks for it."""
    changes, want = ROUTES[case]
    args = {**ROUTE_BENCH, **changes}
    if want in ('enc5', 'cat', 'off'):
        assert lstm_route(**args) == want
    else:
        with pytest.raises(ValueError, match=want):
            lstm_route(**args)


# (F, D, H, cdt) -> the enc5 design lstm_scan_enc5 launches on the card
ENC5_DESIGNS = [
    ((49, 128, 128, torch.bfloat16), 'resident'),
    ((768, 96, 128, torch.bfloat16), 'resident'),
    ((769, 96, 128, torch.bfloat16), 'stream'),
    ((800, 128, 128, torch.bfloat16), 'stream'),
    ((49, 100, 128, torch.bfloat16), 'stream'),
    ((49, 256, 256, torch.bfloat16), 'stream'),
    ((49, 512, 512, torch.bfloat16), 'stream'),
    ((128, 128, 128, torch.float32), 'resident'),
    ((129, 128, 128, torch.float32), 'stream'),
    ((147, 128, 128, torch.float32), 'stream'),
    ((49, 96, 128, torch.float32), 'stream'),
    ((49, 256, 256, torch.float32), 'stream'),
    ((1, 64, 64, torch.float32), 'resident'),
    ((49, 48, 48, torch.float32), 'stream'),
    ((49, 832, 832, torch.float32), 'up to 800'),
    ((0, 256, 256, torch.float32), 'at least one feature'),
    ((49, 100, 100, torch.bfloat16), 'stream'),
    ((49, 200, 200, torch.float32), 'stream'),
    ((49, 801, 801, torch.float32), 'up to 800'),
]


@pytest.mark.parametrize('case', range(len(ENC5_DESIGNS)))
def test_enc5_design(case):
    """enc5_design: the resident kernels where encoder_shape_error serves
    the shape, else the streamed ones; enc5_shape_error names what neither
    takes."""
    (F, D, hidden, cdt), want = ENC5_DESIGNS[case]
    err = lstm_common.enc5_shape_error(F, D, hidden, cdt)
    if want in ('resident', 'stream'):
        assert err is None
        assert lstm_common.enc5_design(F, D, hidden, cdt) == want
        if want == 'stream':
            assert lstm_common.encoder_shape_error(F, D, hidden, cdt)
    else:
        assert err is not None and want in err


def test_lstm_wrapper_refuses_a_head_of_another_width():
    """The policy's head reads the LSTM's hidden state: a head built for
    another width is refused when the wrapper is built, naming the
    option that fixes it."""
    with pytest.raises(ValueError, match='decoder_input_size=128'):
        LSTMWrapper(Default(obs_shape=OBS_SHAPE,
            action_space=spaces.Discrete(5), hidden_size=96),
            obs_shape=OBS_SHAPE, input_size=96, hidden_size=128)


@pytest.mark.parametrize('kind', ['off', 'cat'])
def test_lstm_wrapper_input_width_matches_jax(kind):
    """input_size 96 with hidden 128 (the encoder emits 96 features, the
    head reads the LSTM's 128), through the 'off' scan and cat's plain
    version: logits, value and state to 1e-5, weight gradients to 1e-4,
    against JAX's use_pallas=False module from the same weights."""
    D, hidden = 96, 128
    jmod = JaxLSTMWrapper(policy=JaxDefault(obs_shape=OBS_SHAPE,
        action_space=jspaces.Discrete(5), hidden_size=D),
        obs_shape=OBS_SHAPE, input_size=D, hidden_size=hidden,
        use_pallas=False)
    params = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(7),
        jnp.zeros((2, 2) + OBS_SHAPE, jnp.float32)))
    mod = LSTMWrapper(Default(obs_shape=OBS_SHAPE,
        action_space=spaces.Discrete(5), hidden_size=D,
        decoder_input_size=hidden), obs_shape=OBS_SHAPE, input_size=D,
        hidden_size=hidden, **KINDS[kind])
    mod.load_state_dict(lstm_state_dict(params))
    assert mod.route(T, torch.device('cpu')) == kind
    x = np.random.RandomState(13).randn(B, T, *OBS_SHAPE).astype(np.float32)
    h0, c0 = _arrays(14, (1, B, hidden), (1, B, hidden), scale=0.5)

    def jloss(p):
        lo, v, (h, c) = jmod.apply(p, jnp.asarray(x),
            (jnp.asarray(h0), jnp.asarray(c0)))
        return (jnp.sum(jax.nn.log_softmax(lo) ** 2) + jnp.sum(v * 0.7)
            + jnp.sum(h * c)), (lo, v, h, c)
    jgrads, jouts = jax.grad(jloss, has_aux=True)(params)
    lo, v, (h, c) = mod(torch.from_numpy(x),
        (torch.from_numpy(h0), torch.from_numpy(c0)))
    for name, a, w in zip(('logits', 'value', 'h', 'c'), (lo, v, h, c),
            jouts):
        _assert_close(a, w, 1e-5, name)
    (torch.log_softmax(lo, -1).square().sum() + (v * 0.7).sum()
        + (h * c).sum()).backward()
    jgrads = lstm_state_dict(jax.tree.map(np.asarray, jgrads))
    for name, p in mod.named_parameters():
        _assert_close(p.grad, jgrads[name], 1e-4, name)


def test_lstm_wrapper_hidden_256_matches_jax():
    """LSTMWrapper(use_kernel=True) at hidden 256, which the default route
    sends to enc5's streamed design on the card: on the CPU the enc5
    kernels' plain versions, forward and backward, against JAX's
    use_pallas=False module from the same weights, in f32: logits, value
    and state to 1e-5, weight gradients to 1e-4, as the other wrapper
    tests."""
    hidden = 256
    jmod = JaxLSTMWrapper(policy=JaxDefault(obs_shape=OBS_SHAPE,
        action_space=jspaces.Discrete(5), hidden_size=hidden),
        obs_shape=OBS_SHAPE, input_size=hidden, hidden_size=hidden,
        use_pallas=False)
    params = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(9),
        jnp.zeros((2, 2) + OBS_SHAPE, jnp.float32)))
    mod = LSTMWrapper(Default(obs_shape=OBS_SHAPE,
        action_space=spaces.Discrete(5), hidden_size=hidden),
        obs_shape=OBS_SHAPE, input_size=hidden, hidden_size=hidden,
        kernel='enc5', use_kernel=True)
    mod.load_state_dict(lstm_state_dict(params))
    assert mod.route(T, torch.device('cpu')) == 'enc5'
    for cdt in (torch.float32, torch.bfloat16):
        assert lstm_route('enc5', None, 'cuda', T, hidden, hidden, 49, 1,
            cdt) == 'enc5'
    assert lstm_common.enc5_design(49, hidden, hidden,
        torch.float32) == 'stream'
    x = np.random.RandomState(17).randn(B, T, *OBS_SHAPE).astype(np.float32)
    h0, c0 = _arrays(18, (1, B, hidden), (1, B, hidden), scale=0.5)

    def jloss(p):
        lo, v, (h, c) = jmod.apply(p, jnp.asarray(x),
            (jnp.asarray(h0), jnp.asarray(c0)))
        return (jnp.sum(jax.nn.log_softmax(lo) ** 2) + jnp.sum(v * 0.7)
            + jnp.sum(h * c)), (lo, v, h, c)
    jgrads, jouts = jax.grad(jloss, has_aux=True)(params)
    lo, v, (h, c) = mod(torch.from_numpy(x),
        (torch.from_numpy(h0), torch.from_numpy(c0)))
    for name, a, w in zip(('logits', 'value', 'h', 'c'), (lo, v, h, c),
            jouts):
        _assert_close(a, w, 1e-5, name)
    (torch.log_softmax(lo, -1).square().sum() + (v * 0.7).sum()
        + (h * c).sum()).backward()
    jgrads = lstm_state_dict(jax.tree.map(np.asarray, jgrads))
    for name, p in mod.named_parameters():
        _assert_close(p.grad, jgrads[name], 1e-4, name)


# (obs_shape, input_size, hidden_size): the encoder emits 96 for an LSTM
# of 128; Default's 200 features, past the FMA kernels' 128
ENC5_WRAPPERS = {'input 96': (OBS_SHAPE, 96, 128),
    'features 200': ((10, 20), 32, 32)}


@pytest.mark.parametrize('case', sorted(ENC5_WRAPPERS))
def test_lstm_wrapper_enc5_matches_jax_enc5(case):
    """LSTMWrapper(kernel='enc5', use_kernel=True) at the shapes where the
    port's enc5 runs on the tensor cores only (D != H, F > 128): on the CPU
    the enc5 kernels' plain versions, against JAX's LSTMWrapper with
    use_pallas=True, which runs its enc5 Pallas kernel there (interpret
    mode), from the same weights, in f32: logits, value and state to
    1e-5, weight gradients to 1e-4, as the other wrapper tests."""
    obs_shape, D, hidden = ENC5_WRAPPERS[case]
    jmod = JaxLSTMWrapper(policy=JaxDefault(obs_shape=obs_shape,
        action_space=jspaces.Discrete(5), hidden_size=D),
        obs_shape=obs_shape, input_size=D, hidden_size=hidden,
        use_pallas=False)
    params = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(8),
        jnp.zeros((2, 2) + obs_shape, jnp.float32)))
    jmod = jmod.clone(use_pallas=True)
    mod = LSTMWrapper(Default(obs_shape=obs_shape,
        action_space=spaces.Discrete(5), hidden_size=D,
        decoder_input_size=hidden), obs_shape=obs_shape, input_size=D,
        hidden_size=hidden, kernel='enc5', use_kernel=True)
    mod.load_state_dict(lstm_state_dict(params))
    assert mod.route(T, torch.device('cpu')) == 'enc5'
    assert lstm_route('enc5', None, 'cuda', T, D, hidden,
        int(np.prod(obs_shape)), 1, torch.bfloat16) == 'enc5'
    x = np.random.RandomState(15).randn(B, T, *obs_shape).astype(np.float32)
    h0, c0 = _arrays(16, (1, B, hidden), (1, B, hidden), scale=0.5)

    def jloss(p):
        lo, v, (h, c) = jmod.apply(p, jnp.asarray(x),
            (jnp.asarray(h0), jnp.asarray(c0)))
        return (jnp.sum(jax.nn.log_softmax(lo) ** 2) + jnp.sum(v * 0.7)
            + jnp.sum(h * c)), (lo, v, h, c)
    with pltpu.force_tpu_interpret_mode():
        jgrads, jouts = jax.grad(jloss, has_aux=True)(params)
    lo, v, (h, c) = mod(torch.from_numpy(x),
        (torch.from_numpy(h0), torch.from_numpy(c0)))
    for name, a, w in zip(('logits', 'value', 'h', 'c'), (lo, v, h, c),
            jouts):
        _assert_close(a, w, 1e-5, name)
    (torch.log_softmax(lo, -1).square().sum() + (v * 0.7).sum()
        + (h * c).sum()).backward()
    jgrads = lstm_state_dict(jax.tree.map(np.asarray, jgrads))
    for name, p in mod.named_parameters():
        _assert_close(p.grad, jgrads[name], 1e-4, name)


@pytest.mark.parametrize('space_name', ['discrete', 'multidiscrete'])
def test_recurrent_policy_sampling_replays_jax(space_name):
    """RecurrentPolicy with the JAX sampler's uniforms injected: the same
    actions, logprobs, entropies, values and state."""
    jspace, tspace = {
        'discrete': (jspaces.Discrete(5), spaces.Discrete(5)),
        'multidiscrete': (jspaces.MultiDiscrete([3, 4]),
            spaces.MultiDiscrete([3, 4]))}[space_name]
    jmod, params = _jax_lstm(seed=4, space=jspace)
    jpol = JaxRecurrentPolicy(jmod)
    pol = RecurrentPolicy(_port_lstm(params, space=tspace))
    x = np.random.RandomState(12).randn(B, *OBS_SHAPE).astype(np.float32)
    state = jpol.initial_state(B)
    key = jax.random.PRNGKey(5)
    ja, jlp, jent, jval, (jh, jc) = jpol(params, jnp.asarray(x), state,
        key=key)
    n = len(tspace.nvec) if space_name == 'multidiscrete' else 1
    u = np.stack([np.asarray(jax.random.uniform(k, (B,), dtype=jnp.float32))
        for k in jax.random.split(key, n)], axis=-1)
    tstate = pol.initial_state(B)
    assert all(tuple(s.shape) == (1, B, H) for s in tstate)
    with torch.no_grad():
        a, lp, ent, val, (h, c) = pol(torch.from_numpy(x), tstate,
            u=torch.from_numpy(u))
        value = pol.get_value(torch.from_numpy(x), tstate)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    for name, g, w in (('logprob', lp, jlp), ('entropy', ent, jent),
            ('value', val, jval), ('get_value', value, jval), ('h', h, jh),
            ('c', c, jc)):
        _assert_close(g, w, 1e-5, name)
    assert pol.lstm is pol.module


def test_lstm_convert_round_trip_and_count():
    _, params = _jax_lstm(num_layers=2, seed=6)
    mod = _port_lstm(params, num_layers=2)
    back = lstm_params(mod.state_dict())
    flat = dict(jax.tree.leaves_with_path(params))
    back_flat = dict(jax.tree.leaves_with_path(back))
    assert sorted(map(str, flat)) == sorted(map(str, back_flat))
    for path, leaf in flat.items():
        np.testing.assert_array_equal(back_flat[path], leaf)
    assert count_params(mod) == sum(a.size for a in flat.values())


def test_port_lstm_init():
    """The port's own init: orthogonal (gain 1) weights, zero bias."""
    mod = LSTMWrapper(Default(obs_shape=OBS_SHAPE,
        action_space=spaces.Discrete(5), hidden_size=64), obs_shape=OBS_SHAPE,
        input_size=64, hidden_size=64, generator=torch.Generator().manual_seed(
            0))
    for name in ('w_ih_l0', 'w_hh_l0'):
        w = getattr(mod, name).detach()
        assert w.shape == (64, 256)
        torch.testing.assert_close(w @ w.T, torch.eye(64), rtol=0, atol=1e-5)
    assert torch.all(mod.b_l0 == 0)
