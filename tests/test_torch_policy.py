"""Default, Policy and the action distributions of the PyTorch port
against the JAX package.

JAX params, made by flax init from a seed, cross to the port through
convert.py; logits and value must then agree in f32 to 1e-5 (the same
f32 products, summed in another order). Sampling takes the JAX sampler's
own uniforms (injected `u`) and must pick the same actions exactly;
logprob and entropy agree to 1e-5.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from pufferlib_tpu import spaces as jspaces
from pufferlib_tpu.models import Default as JaxDefault
from pufferlib_tpu.models import Policy as JaxPolicy
from pufferlib_tpu.models.distributions import (
    entropy as jax_entropy, log_prob as jax_log_prob,
    sample_logits as jax_sample_logits)

from pufferlib_tpu_torch import spaces
from pufferlib_tpu_torch.convert import default_params, default_state_dict
from pufferlib_tpu_torch.models import Default, Policy, count_params
from pufferlib_tpu_torch.models.distributions import (
    entropy, log_prob, sample_logits)

torch.set_num_threads(1)

ATOL = 1e-5
OBS_SHAPE = (7, 7)
ACTION_SPACES = {
    'discrete': (jspaces.Discrete(8), spaces.Discrete(8)),
    'multidiscrete': (jspaces.MultiDiscrete([3, 4]),
        spaces.MultiDiscrete([3, 4])),
}


def _obs(batch, seed):
    return np.random.RandomState(seed).randn(batch, *OBS_SHAPE).astype(
        np.float32)


def _pair(space_name, init_style, hidden=32, dtype=(jnp.float32,
        torch.float32), use_kernel=False):
    jspace, tspace = ACTION_SPACES[space_name]
    jmod = JaxDefault(obs_shape=OBS_SHAPE, action_space=jspace,
        hidden_size=hidden, init_style=init_style, dtype=dtype[0])
    params = jmod.init(jax.random.PRNGKey(3), jnp.asarray(_obs(1, 0)))
    params = jax.tree.map(np.asarray, params)
    tmod = Default(obs_shape=OBS_SHAPE, action_space=tspace,
        hidden_size=hidden, init_style=init_style, dtype=dtype[1],
        use_kernel=use_kernel)
    tmod.load_state_dict(default_state_dict(params))
    return jmod, params, tmod


def _as_list(logits):
    return list(logits) if isinstance(logits, (list, tuple)) else [logits]


@pytest.mark.parametrize('space_name', sorted(ACTION_SPACES))
@pytest.mark.parametrize('init_style', ['orthogonal', 'torch'])
def test_default_matches_jax_from_converted_params(space_name, init_style):
    jmod, params, tmod = _pair(space_name, init_style)
    x = _obs(33, 1)
    jlogits, jvalue = jmod.apply(params, jnp.asarray(x))
    with torch.no_grad():
        logits, value = tmod(torch.from_numpy(x))
    assert value.shape == (33, 1) and value.dtype == torch.float32
    for a, b in zip(_as_list(logits), _as_list(jlogits)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
            atol=ATOL)
    np.testing.assert_allclose(value.numpy(), np.asarray(jvalue), rtol=0,
        atol=ATOL)


def test_default_bf16_compute_close_to_jax():
    """bf16 compute, f32 params: both sides round at the layer bounds;
    they may differ by a bf16 ulp of the hidden layer (2^-8 relative),
    so 5e-2 on logits of order 1."""
    jmod, params, tmod = _pair('discrete', 'torch',
        dtype=(jnp.bfloat16, torch.bfloat16))
    x = _obs(16, 2)
    jlogits, jvalue = jmod.apply(params, jnp.asarray(x))
    with torch.no_grad():
        logits, value = tmod(torch.from_numpy(x))
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0,
        atol=5e-2)
    np.testing.assert_allclose(value.numpy(), np.asarray(jvalue), rtol=0,
        atol=5e-2)


@pytest.mark.parametrize('space_name', sorted(ACTION_SPACES))
def test_fused_head_path_matches_plain(space_name):
    """Default(use_kernel=True) on the CPU runs the kernel's plain version:
    same logits and value as the two-layer path in f32, and the same
    weight gradients."""
    _, params, plain = _pair(space_name, 'orthogonal')
    _, _, fused = _pair(space_name, 'orthogonal', use_kernel=True)
    x = torch.from_numpy(_obs(20, 4))
    outs = []
    for mod in (plain, fused):
        logits, value = mod(x)
        loss = sum((l ** 2).sum() for l in _as_list(logits)) + value.sum()
        loss.backward()
        outs.append((logits, value, [p.grad for p in mod.parameters()]))
    for a, b in zip(_as_list(outs[0][0]), _as_list(outs[1][0])):
        torch.testing.assert_close(a, b, rtol=0, atol=ATOL)
    torch.testing.assert_close(outs[0][1], outs[1][1], rtol=0, atol=ATOL)
    for a, b in zip(outs[0][2], outs[1][2]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)


def test_convert_round_trip_and_count():
    _, params, tmod = _pair('multidiscrete', 'orthogonal')
    back = default_params(tmod.state_dict())
    for layer in ('encoder', 'head'):
        for k in ('kernel', 'bias'):
            np.testing.assert_array_equal(back['params'][layer][k],
                params['params'][layer][k])
    assert count_params(tmod) == sum(
        a.size for a in jax.tree.leaves(params))


@pytest.mark.parametrize('init_style', ['orthogonal', 'torch'])
def test_port_init_schemes(init_style):
    """The port's own init follows the JAX schemes: orthogonal blocks
    with CleanRL's gains, or torch-default uniform bounds."""
    g = torch.Generator().manual_seed(0)
    m = Default(obs_shape=OBS_SHAPE, action_space=spaces.Discrete(8),
        hidden_size=64, init_style=init_style, generator=g)
    w, b = m.encoder.weight.detach(), m.encoder.bias.detach()
    hw, hb = m.head.weight.detach(), m.head.bias.detach()
    logit_rows = hw[:8]
    torch.testing.assert_close(logit_rows @ logit_rows.T,
        1e-4 * torch.eye(8), rtol=0, atol=1e-6)
    assert torch.all(hb[:8] == 0)
    if init_style == 'orthogonal':
        torch.testing.assert_close(w.T @ w, 2.0 * torch.eye(49), rtol=0,
            atol=1e-4)
        assert torch.all(b == 0)
        torch.testing.assert_close(hw[8].norm(), torch.tensor(1.0))
    else:
        bound = 1 / np.sqrt(49)
        assert w.abs().max() <= bound and b.abs().max() <= bound
        assert b.abs().max() > 0
        assert hw[8].abs().max() <= 1 / np.sqrt(64) and hb[8] != 0


def test_distributions_match_jax_with_masks():
    rng = np.random.RandomState(5)
    logits = rng.randn(64, 6).astype(np.float32) * 2
    logits[::3, 1] = -np.inf
    logits[1::4, [0, 5]] = -np.inf
    actions = rng.randint(0, 6, 64)
    actions[(actions == 1) & (np.arange(64) % 3 == 0)] = 2
    actions[np.arange(64) % 4 == 1] = 3
    jl, tl = jnp.asarray(logits), torch.from_numpy(logits)
    np.testing.assert_allclose(
        log_prob(tl, torch.from_numpy(actions)).numpy(),
        np.asarray(jax_log_prob(jl, jnp.asarray(actions))), rtol=0,
        atol=ATOL)
    ent = entropy(tl).numpy()
    assert np.all(np.isfinite(ent))
    np.testing.assert_allclose(ent, np.asarray(jax_entropy(jl)), rtol=0,
        atol=ATOL)


@pytest.mark.parametrize('masked', [False, True])
def test_sample_logits_replays_jax_draws(masked):
    """Discrete and MultiDiscrete: with the JAX sampler's uniforms
    injected, the port picks the same actions, never a masked one."""
    rng = np.random.RandomState(6)
    B = 500
    l0 = rng.randn(B, 5).astype(np.float32)
    l1 = rng.randn(B, 3).astype(np.float32)
    if masked:
        l0[:, [0, 2]] = -np.inf
        l1[:, 2] = -np.inf
    key = jax.random.PRNGKey(11)

    # the uniforms jax_sample_logits draws: one split key per component
    def uniforms(n):
        keys = jax.random.split(key, n)
        return np.stack([np.asarray(jax.random.uniform(k, (B,),
            dtype=jnp.float32)) for k in keys], axis=-1)

    ja, jlp, jent = jax_sample_logits(jnp.asarray(l0), key=key)
    a, lp, ent = sample_logits(torch.from_numpy(l0),
        u=torch.from_numpy(uniforms(1)))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=0,
        atol=ATOL)
    np.testing.assert_allclose(ent.numpy(), np.asarray(jent), rtol=0,
        atol=ATOL)

    ja, jlp, jent = jax_sample_logits([jnp.asarray(l0), jnp.asarray(l1)],
        key=key)
    a, lp, ent = sample_logits([torch.from_numpy(l0), torch.from_numpy(l1)],
        u=torch.from_numpy(uniforms(2)))
    assert a.shape == (B, 2)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=0,
        atol=ATOL)
    np.testing.assert_allclose(ent.numpy(), np.asarray(jent), rtol=0,
        atol=ATOL)
    if masked:
        assert not np.isin(a[:, 0].numpy(), [0, 2]).any()
        assert not (a[:, 1].numpy() == 2).any()

    # evaluate mode: given actions
    _, jlp, _ = jax_sample_logits([jnp.asarray(l0), jnp.asarray(l1)],
        action=ja)
    _, lp, _ = sample_logits([torch.from_numpy(l0), torch.from_numpy(l1)],
        action=torch.from_numpy(np.array(ja)))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=0,
        atol=ATOL)


def test_policy_matches_jax_policy():
    jmod, params, tmod = _pair('discrete', 'orthogonal')
    jpol, tpol = JaxPolicy(jmod), Policy(tmod)
    x = _obs(12, 7)
    actions = np.arange(12) % 8
    _, jlp, jent, jval = jpol(params, jnp.asarray(x),
        action=jnp.asarray(actions))
    with torch.no_grad():
        _, lp, ent, val = tpol(torch.from_numpy(x),
            action=torch.from_numpy(actions))
        tval = tpol.get_value(torch.from_numpy(x))
    for a, b in ((lp, jlp), (ent, jent), (val, jval), (tval, jval)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
            atol=ATOL)
