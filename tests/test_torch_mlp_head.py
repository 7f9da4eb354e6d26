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
    mlp_head, mlp_head_reference as torch_reference)

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
