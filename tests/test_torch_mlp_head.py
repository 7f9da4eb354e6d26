"""Fused MLP head of the PyTorch port against the JAX package.

The port's mlp_head on CPU tensors runs its plain version inside the
autograd.Function that, on the card, wraps the CUDA kernel. It is held
against pufferlib_tpu's mlp_head_reference and against the Pallas kernel
mlp_head_fwd in interpret mode, forward and weight gradients, in f32 and
bf16.

Tolerances: f32 1e-5 on outputs of order 1 (the same f32 products, summed
in another order). In bf16 the inputs round identically and every product
of two bf16 values is exact in f32, so outputs still agree to 1e-5 unless
a hidden activation sits within one f32 ulp of a bf16 rounding boundary;
the bf16 bound is one bf16 ulp of the hidden layer carried through the
head (2^-8 relative), 2e-2 absolute here. Gradients: 1e-4 (f32) and
5e-2 (bf16), sums over the batch of the same products.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from pufferlib_tpu.ops.pallas.mlp import mlp_head_fwd, mlp_head_reference

from pufferlib_tpu_torch.ops.cuda.mlp import (
    TC_CONFIGS, fma_smem, mlp_head, mlp_head_reference as torch_reference,
    mlp_shape_error, tc_config)

torch.set_num_threads(1)

DTYPES = {
    'float32': (jnp.float32, torch.float32, 1e-5, 1e-4),
    'bfloat16': (jnp.bfloat16, torch.bfloat16, 2e-2, 5e-2),
}


def _inputs(B=40, F=49, H=32, O=9, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, F).astype(np.float32),
        (rng.randn(F, H) * 0.3).astype(np.float32),
        (rng.randn(H) * 0.1).astype(np.float32),
        (rng.randn(H, O) * 0.3).astype(np.float32),
        (rng.randn(O) * 0.1).astype(np.float32))


def _wide_inputs(B, seed, F=200, H=256, O=17):
    """The bf16 kernel's wider reach: more features than one 64-column
    chunk of x, H in several chunks, a multidiscrete head past 16 outputs.
    Weights scaled as the trainer's init, so that outputs stay of order 1
    as the tolerances assume."""
    rng = np.random.RandomState(seed)
    return (rng.randn(B, F).astype(np.float32),
        (rng.randn(F, H) * np.sqrt(2 / F)).astype(np.float32),
        (rng.randn(H) * 0.1).astype(np.float32),
        (rng.randn(H, O) / np.sqrt(H)).astype(np.float32),
        (rng.randn(O) * 0.1).astype(np.float32))


def _jax_grads(fn, arrays, cdt):
    x, w1, b1, w2, b2 = (jnp.asarray(a) for a in arrays)

    def loss(w1, b1, w2, b2):
        return jnp.sum(fn(x, w1, b1, w2, b2, cdt) ** 2)
    out = fn(x, w1, b1, w2, b2, cdt)
    grads = jax.grad(loss, argnums=(0, 1, 2, 3))(w1, b1, w2, b2)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _torch_grads(arrays, cdt, x_dtype=torch.float32):
    x = torch.from_numpy(arrays[0]).to(x_dtype).requires_grad_(True)
    ws = [torch.from_numpy(a).requires_grad_(True) for a in arrays[1:]]
    out = mlp_head(x, *ws, cdt)
    (out ** 2).sum().backward()
    return out, x.grad, [w.grad.numpy() for w in ws]


@pytest.mark.parametrize('name', ['float32', 'bfloat16'])
def test_mlp_head_matches_jax_reference(name):
    jdt, tdt, atol, gtol = DTYPES[name]
    arrays = _inputs()
    expected, jgrads = _jax_grads(mlp_head_reference, arrays, jdt)
    out, dx, grads = _torch_grads(arrays, tdt)
    assert out.dtype == torch.float32 and out.shape == (40, 9)
    np.testing.assert_allclose(out.detach().numpy(), expected, rtol=0,
        atol=atol)
    # autodiff through the bf16 reference rounds its cotangent products to
    # bf16; the custom backward (f32 products) is held against the Pallas
    # kernel's below, so the reference's gradients are compared in f32
    if name == 'float32':
        for g, jg in zip(grads, jgrads):
            np.testing.assert_allclose(g, jg, rtol=0, atol=gtol)
    # the x-gradient is zero by contract
    assert torch.count_nonzero(dx) == 0


@pytest.mark.parametrize('name', ['float32', 'bfloat16'])
def test_mlp_head_matches_pallas_kernel(name):
    jdt, tdt, atol, gtol = DTYPES[name]
    arrays = _inputs(B=24, H=32, seed=1)
    with pltpu.force_tpu_interpret_mode():
        expected, jgrads = _jax_grads(mlp_head_fwd, arrays, jdt)
    out, _, grads = _torch_grads(arrays, tdt)
    np.testing.assert_allclose(out.detach().numpy(), expected, rtol=0,
        atol=atol)
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g, jg, rtol=0, atol=gtol)


def test_mlp_head_bf16_input_equals_f32_input_rounded():
    """x stored in bf16 (the trainer's obs_store_dtype) gives the same
    result as f32 x under a bf16 compute dtype: the kernel rounds x to
    cdt on load either way."""
    arrays = _inputs(B=17, seed=2)
    a, _, _ = _torch_grads(arrays, torch.bfloat16, torch.float32)
    b, _, _ = _torch_grads(arrays, torch.bfloat16, torch.bfloat16)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_plain_version_is_the_forward_on_cpu():
    arrays = [torch.from_numpy(a) for a in _inputs(B=9, seed=3)]
    torch.testing.assert_close(mlp_head(*arrays, torch.float32),
        torch_reference(*arrays, torch.float32), rtol=0, atol=0)


def test_kernel_wrapper_rejects_other_devices():
    arrays = [torch.from_numpy(a).to('meta') for a in _inputs(B=8)]
    with pytest.raises(ValueError, match='no MLP head kernel'):
        mlp_head(*arrays, torch.float32)


@pytest.mark.parametrize('name', ['float32', 'bfloat16'])
def test_mlp_head_wide_matches_jax_reference(name):
    """F = 200, H = 256, O = 17 at a ragged B = 1000, which the Pallas
    kernel does not tile (B % 8 != 0): against the JAX reference. The
    weight gradients sum 1000 rows and reach 150, so their tolerance is
    the file's taken of max(1, max |reference|): f32 sums of that many
    terms in another order differ by a few ulp of the largest value."""
    jdt, tdt, atol, gtol = DTYPES[name]
    arrays = _wide_inputs(1000, seed=4)
    expected, jgrads = _jax_grads(mlp_head_reference, arrays, jdt)
    out, dx, grads = _torch_grads(arrays, tdt)
    assert out.shape == (1000, 17)
    np.testing.assert_allclose(out.detach().numpy(), expected, rtol=0,
        atol=atol)
    # as above: the reference's autodiff rounds its cotangents in bf16
    if name == 'float32':
        for g, jg in zip(grads, jgrads):
            np.testing.assert_allclose(g, jg, rtol=0,
                atol=gtol * max(1.0, np.abs(jg).max()))
    assert torch.count_nonzero(dx) == 0


@pytest.mark.parametrize('name', ['float32', 'bfloat16'])
def test_mlp_head_wide_matches_pallas_kernel(name):
    """F = 200, H = 256, O = 17 at B = 24: forward and weight gradients
    against the Pallas kernel in interpret mode."""
    jdt, tdt, atol, gtol = DTYPES[name]
    arrays = _wide_inputs(24, seed=5)
    with pltpu.force_tpu_interpret_mode():
        expected, jgrads = _jax_grads(mlp_head_fwd, arrays, jdt)
    out, _, grads = _torch_grads(arrays, tdt)
    np.testing.assert_allclose(out.detach().numpy(), expected, rtol=0,
        atol=atol)
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g, jg, rtol=0, atol=gtol)


@pytest.mark.parametrize('x_dtype', [torch.bfloat16, torch.float32])
def test_bf16_kernel_serves_every_shape_the_fma_kernel_served(x_dtype):
    """In bf16 the tensor-core kernel took over from the FMA kernel, whose
    limit (fma_smem, its weights in f32 shared memory) was the only one:
    every (F, H, O) within it is still served, for x in either dtype. The
    largest O per (F, H) is the one to check: shared memory grows with O."""
    limit = 227 * 1024
    checked = 0
    for F in range(1, 1900, 19):
        for H in range(1, 1900, 23):
            O = (limit // 4 - F * H - H - 32 * F - 32 * H) // (H + 1)
            if O < 1:
                continue
            assert fma_smem(F, H, O) <= limit < fma_smem(F, H, O + 1)
            for o in (1, O):
                assert mlp_shape_error(F, H, o, torch.bfloat16,
                    x_dtype) is None, (F, H, o)
            checked += 1
    assert checked > 300


@pytest.mark.parametrize('F,H,O,cdt,x_dtype,config,error', [
    # the trainer's head: weights resident, a ring of three x spans
    (49, 128, 9, torch.bfloat16, torch.bfloat16, 0, None),
    (49, 128, 9, torch.bfloat16, torch.float32, 0, None),
    # wider: one ring stage, then weights read from L2 (beyond the FMA
    # kernel's limit), then 16-row tiles
    (200, 256, 17, torch.bfloat16, torch.bfloat16, 1, None),
    (200, 512, 17, torch.bfloat16, torch.bfloat16, 2, None),
    (1500, 8, 2, torch.bfloat16, torch.bfloat16, 3, None),
    (2400, 64, 9, torch.bfloat16, torch.float32, 3, None),
    # past the last configuration
    (4000, 16, 1, torch.bfloat16, torch.bfloat16, None, 'shared memory'),
    (2500, 16, 1, torch.bfloat16, torch.float32, None, 'shared memory'),
    # f32 compute keeps the FMA kernel and its limit
    (49, 128, 9, torch.float32, torch.float32, None, None),
    (200, 512, 17, torch.float32, torch.float32, None, 'f32 MLP head'),
    (1, 1, 0, torch.bfloat16, torch.bfloat16, None, 'F, H, O >= 1'),
])
def test_mlp_shape_error_table(F, H, O, cdt, x_dtype, config, error):
    got = mlp_shape_error(F, H, O, cdt, x_dtype)
    if error is None:
        assert got is None
    else:
        assert error in got
    if cdt == torch.bfloat16 and O >= 1:
        assert tc_config(F, H, O, x_dtype) == config
        assert config is None or 0 <= config < len(TC_CONFIGS)
