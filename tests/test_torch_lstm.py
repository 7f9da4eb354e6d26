"""The LSTM of the PyTorch port against the JAX package.

- The plain versions of the enc5 and cat kernels (forward, and the
  explicit backward that follows the TPU kernels' _bwd_kernel) against
  the Pallas kernels themselves, run in interpret mode on the CPU, from
  the same numpy inputs: f32 to 1e-5 (the same f32 products, summed in
  another order); bf16 to 1e-2, two and a half bf16 ulps of a value of
  order 1, for a sum that lands on the other side of a rounding boundary
  and rounds the other way.
- LSTMWrapper and RecurrentPolicy against the JAX modules from the same
  flax-initialised weights (convert.lstm_state_dict), in f32: logits,
  value and state to 1e-5, weight gradients to 1e-4. On the CPU the
  port's 'enc5' and 'cat' run the kernels' plain versions; JAX runs its
  'off' scan (use_pallas is off on the CPU), which is the same function.
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
    Default, LSTMWrapper, RecurrentPolicy, count_params)
from pufferlib_tpu_torch.ops.cuda import lstm_cat, lstm_enc
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


def _cotangents(seed):
    """Upstream gradients of outs, hT and cT."""
    return _arrays(seed, (T, B, H), (B, H), (B, H), scale=1.0)


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


@pytest.mark.parametrize('dtype', sorted(DTYPES))
def test_cat_plain_matches_pallas_kernel(dtype):
    """Forward and every gradient, dx included."""
    jd, td, tol = DTYPES[dtype]
    x, h0, c0, w_ih, w_hh, b = _arrays(1, (T, B, H), (B, H), (B, H),
        (H, 4 * H), (H, 4 * H), (4 * H,))
    xj = jnp.asarray(x).astype(jd)
    args = (xj, h0, c0, w_ih, w_hh, b)
    cot = _cotangents(2)
    with pltpu.force_tpu_interpret_mode():
        want = jax_scan_cat(*args, jd)
        want_grads = _jax_grads(jax_scan_cat, args, tuple(range(6)), jd, cot)
    tensors = [torch.from_numpy(_np(xj)).to(td)] + [torch.from_numpy(a)
        for a in (h0, c0, w_ih, w_hh, b)]
    for t in tensors:
        t.requires_grad_()
    got = _torch_outs_and_grads(lstm_scan_cat, tensors, td, cot)
    assert got[0].dtype == td and got[1].dtype == torch.float32
    for name, a, w in zip(('outs', 'hT', 'cT'), got, want):
        _assert_close(a, w, tol, name)
    names = ('dx', 'dh0', 'dc0', 'dw_ih', 'dw_hh', 'db')
    for name, t, w in zip(names, tensors, want_grads):
        assert t.grad.dtype == t.dtype, name
        _assert_close(t.grad, w, tol, name)


@pytest.mark.parametrize('dtype', sorted(DTYPES))
def test_enc5_plain_matches_pallas_kernel(dtype):
    """Forward and every gradient but the features' (zero by
    contract)."""
    jd, td, tol = DTYPES[dtype]
    feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b = _arrays(3, (T, B, F),
        (B, H), (B, H), (F, H), (H,), (H, 4 * H), (H, 4 * H), (4 * H,))
    fj = jnp.asarray(feats * 3).astype(jd)
    args = (fj, h0, c0, w_enc, b_enc, w_ih, w_hh, b)
    cot = _cotangents(4)
    argnums = tuple(range(1, 8))
    with pltpu.force_tpu_interpret_mode():
        want = jax_scan_enc5(*args, jd)
        want_grads = _jax_grads(jax_scan_enc5, args, argnums, jd, cot)
    tensors = [torch.from_numpy(_np(fj)).to(td)] + [
        torch.from_numpy(a).requires_grad_()
        for a in (h0, c0, w_enc, b_enc, w_ih, w_hh, b)]
    got = _torch_outs_and_grads(lstm_scan_enc5, tensors, td, cot)
    for name, a, w in zip(('outs', 'hT', 'cT'), got, want):
        _assert_close(a, w, tol, name)
    names = ('dh0', 'dc0', 'dw_enc', 'db_enc', 'dw_ih', 'dw_hh', 'db')
    for name, t, w in zip(names, tensors[1:], want_grads):
        _assert_close(t.grad, w, tol, name)
    if dtype == 'float32':
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
    cuda = torch.device('cuda')
    lstm_cat.check_kernel_shape(128, 128, cuda)
    with pytest.raises(ValueError, match='hidden'):
        lstm_cat.check_kernel_shape(64, 128, cuda)
    with pytest.raises(ValueError, match='hidden'):
        lstm_cat.check_kernel_shape(96, 96, cuda)
    with pytest.raises(ValueError, match='device'):
        lstm_cat.check_kernel_shape(32, 32, torch.device('cpu'))
    with pytest.raises(ValueError, match='dtype|bfloat16|float32'):
        lstm_scan_cat(torch.zeros(T, B, H), *(torch.zeros(B, H),) * 2,
            torch.zeros(H, 4 * H), torch.zeros(H, 4 * H),
            torch.zeros(4 * H), torch.bfloat16)


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
