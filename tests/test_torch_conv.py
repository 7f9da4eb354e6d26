"""The conv policies of the PyTorch port against the JAX package.

`Convolutional` and `ProcgenResnet` from the same flax-initialised weights
(convert.layers_state_dict), the same uint8 frames made with numpy, in
f32 on the CPU: logits and value to 1e-5, every weight gradient (of a
fixed linear function of logits and value, carried back through the same
layer map) to 1e-4 times its largest value, at least 1 (the same f32
products summed in another order, through convolutions of up to 1024
terms). Covered: even and odd image sizes (ProcgenResnet's SAME max pool
pads (0, 1) at 16 and (1, 1) at 15), channels_last, downsample and a
MultiDiscrete head. Conv + LSTM runs through LSTMWrapper's plain scan on
both sides (the JAX module's use_pallas=False).
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from pufferlib_tpu import spaces as jspaces
from pufferlib_tpu.models import Convolutional as JaxConvolutional
from pufferlib_tpu.models import LSTMWrapper as JaxLSTMWrapper
from pufferlib_tpu.models import ProcgenResnet as JaxProcgenResnet

from pufferlib_tpu_torch import spaces
from pufferlib_tpu_torch.convert import (
    convolutional_layers, layers_params, layers_state_dict, lstm_state_dict,
    procgen_layers)
from pufferlib_tpu_torch.models import (
    Convolutional, LSTMWrapper, ProcgenResnet)

torch.set_num_threads(1)

OUT_TOL, GRAD_TOL = 1e-5, 1e-4
B = 4


def _spaces(nvec):
    if len(nvec) == 1:
        return jspaces.Discrete(nvec[0]), spaces.Discrete(nvec[0])
    return jspaces.MultiDiscrete(nvec), spaces.MultiDiscrete(nvec)


def _frames(seed, shape):
    return np.random.RandomState(seed).randint(0, 256, (B,) + shape).astype(
        np.uint8)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def _close(got, want, tol, what):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=tol,
        err_msg=what)


def _cotangents(logits, seed):
    rng = np.random.RandomState(seed)
    leaves = logits if isinstance(logits, (list, tuple)) else [logits]
    return [rng.randn(*np.shape(l)).astype(np.float32) for l in leaves]


def _loss_jax(out, cots, gv):
    logits, value = out
    leaves = logits if isinstance(logits, (list, tuple)) else [logits]
    return sum(jnp.sum(l * c) for l, c in zip(leaves, cots)) + jnp.sum(
        value * gv)


def _loss_torch(out, cots, gv):
    logits, value = out
    leaves = logits if isinstance(logits, (list, tuple)) else [logits]
    return sum((l * torch.from_numpy(c)).sum() for l, c in zip(leaves,
        cots)) + (value * torch.from_numpy(gv)).sum()


def _check(jmod, tmod, layers, obs, seed=0):
    """Outputs and weight gradients of the two modules from the JAX
    module's init, carried to the port by `layers`."""
    params = jmod.init(jax.random.PRNGKey(seed), jnp.asarray(obs[:1]))
    params = jax.tree.map(np.asarray, params)
    tmod.load_state_dict(layers_state_dict(params, layers))
    want = jmod.apply(params, jnp.asarray(obs))
    got = tmod(torch.from_numpy(obs))
    want_leaves = jax.tree.leaves(want)
    got_leaves = [*(got[0] if isinstance(got[0], list) else [got[0]]),
        got[1]]
    assert len(got_leaves) == len(want_leaves)
    for i, (a, w) in enumerate(zip(got_leaves, want_leaves)):
        assert tuple(a.shape) == tuple(w.shape), i
        _close(a, w, OUT_TOL, f'output {i}')
    cots = _cotangents(want[0], seed + 1)
    gv = np.random.RandomState(seed + 2).randn(B, 1).astype(np.float32)
    grads = jax.grad(lambda p: _loss_jax(jmod.apply(p, jnp.asarray(obs)),
        cots, gv))(params)
    want_grads = layers_state_dict(jax.tree.map(np.asarray, grads), layers)
    tmod.zero_grad()
    _loss_torch(got, cots, gv).backward()
    for name, p in tmod.named_parameters():
        w = want_grads[name]
        _close(p.grad, w, GRAD_TOL * max(1.0, np.abs(_np(w)).max()), name)


# (obs shape, channels_last, downsample, nvec): the visual env's frames,
# an odd size, channels last, every second row and column, a
# MultiDiscrete head
CONV_CASES = {
    'visual 2x40x40': ((2, 40, 40), False, 1, (5,)),
    'odd 3x37x45': ((3, 37, 45), False, 1, (4,)),
    'channels_last 40x40x2': ((40, 40, 2), True, 1, (5,)),
    'downsample 2, 2x80x80': ((2, 80, 80), False, 2, (5,)),
    'multidiscrete': ((2, 40, 40), False, 1, (2, 3)),
}


def _conv_flat_size(shape, channels_last, downsample):
    h, w = (shape[:2] if channels_last else shape[1:])
    h, w = -(-h // downsample), -(-w // downsample)
    for k, s in ((8, 4), (4, 2), (3, 1)):
        h, w = (h - k) // s + 1, (w - k) // s + 1
    return 64 * h * w


@pytest.mark.parametrize('case', list(CONV_CASES))
def test_convolutional_matches_jax(case):
    shape, channels_last, downsample, nvec = CONV_CASES[case]
    framestack = shape[-1] if channels_last else shape[0]
    flat = _conv_flat_size(shape, channels_last, downsample)
    jspace, tspace = _spaces(nvec)
    jmod = JaxConvolutional(action_space=jspace, framestack=framestack,
        flat_size=flat, hidden_size=32, channels_last=channels_last,
        downsample=downsample)
    tmod = Convolutional(tspace, framestack, flat, hidden_size=32,
        channels_last=channels_last, downsample=downsample)
    _check(jmod, tmod, convolutional_layers(nvec), _frames(1, shape))


# (obs shape, nvec): even sizes pool (0, 1), odd ones (1, 1) first
PROCGEN_CASES = {
    'even 16x16x3': ((16, 16, 3), (15,)),
    'odd 15x13x3': ((15, 13, 3), (15,)),
    'multidiscrete 12x12x3': ((12, 12, 3), (3, 4)),
}


@pytest.mark.parametrize('case', list(PROCGEN_CASES))
def test_procgen_resnet_matches_jax(case):
    shape, nvec = PROCGEN_CASES[case]
    jspace, tspace = _spaces(nvec)
    jmod = JaxProcgenResnet(action_space=jspace, cnn_width=4, mlp_width=16)
    tmod = ProcgenResnet(tspace, cnn_width=4, mlp_width=16, obs_shape=shape)
    _check(jmod, tmod, procgen_layers(nvec), _frames(2, shape))


@pytest.mark.parametrize('family', ['convolutional', 'procgen'])
def test_conv_weight_carry_round_trip(family):
    """layers_params inverts layers_state_dict on the port's own init."""
    if family == 'convolutional':
        mod = Convolutional(spaces.MultiDiscrete([2, 3]), 2, 64,
            hidden_size=16)
        layers = convolutional_layers((2, 3))
    else:
        mod = ProcgenResnet(spaces.Discrete(5), cnn_width=4, mlp_width=8,
            obs_shape=(8, 8, 3))
        layers = procgen_layers((5,))
    sd = mod.state_dict()
    back = layers_state_dict(layers_params(sd, layers), layers)
    assert sorted(back) == sorted(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k


def test_conv_lstm_matches_jax():
    """Convolutional + LSTMWrapper (hidden 16) through the plain scan on
    both sides: logits, value and state to 1e-5, every weight gradient to
    1e-4 of its scale. T = 3 steps of 4 rows, batch-major."""
    T, shape, hidden = 3, (2, 40, 40), 16
    jspace, tspace = _spaces((5,))
    jinner = JaxConvolutional(action_space=jspace, framestack=2,
        flat_size=64, hidden_size=hidden)
    jmod = JaxLSTMWrapper(policy=jinner, obs_shape=shape, input_size=hidden,
        hidden_size=hidden, use_pallas=False)
    tmod = LSTMWrapper(Convolutional(tspace, 2, 64, hidden_size=hidden),
        obs_shape=shape, input_size=hidden, hidden_size=hidden,
        use_kernel=False)
    obs = np.random.RandomState(3).randint(0, 256, (B, T) + shape).astype(
        np.uint8)
    rng = np.random.RandomState(4)
    state = tuple((rng.randn(1, B, hidden) * 0.5).astype(np.float32)
        for _ in range(2))
    params = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(0),
        jnp.asarray(obs), tuple(jnp.asarray(s) for s in state)))
    layers = convolutional_layers((5,))
    tmod.load_state_dict(lstm_state_dict(params, functools.partial(
        layers_state_dict, layers=layers)))
    jstate = tuple(jnp.asarray(s) for s in state)
    tstate = tuple(torch.from_numpy(s) for s in state)
    want = jmod.apply(params, jnp.asarray(obs), jstate)
    got = tmod(torch.from_numpy(obs), tstate)
    for name, a, w in zip(('logits', 'value', 'h', 'c'),
            (got[0], got[1], *got[2]), (want[0], want[1], *want[2])):
        _close(a, w, OUT_TOL, name)
    cots = _cotangents(want[0], 5)
    gv = rng.randn(B * T, 1).astype(np.float32)

    def loss(p):
        logits, value, _ = jmod.apply(p, jnp.asarray(obs), jstate)
        return _loss_jax((logits, value), cots, gv)
    grads = jax.tree.map(np.asarray, jax.grad(loss)(params))
    want_grads = lstm_state_dict(grads, functools.partial(layers_state_dict,
        layers=layers))
    _loss_torch(got[:2], cots, gv).backward()
    for name, p in tmod.named_parameters():
        w = want_grads[name]
        _close(p.grad, w, GRAD_TOL * max(1.0, np.abs(_np(w)).max()), name)
