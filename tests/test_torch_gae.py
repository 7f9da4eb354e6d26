"""GAE of the PyTorch port against the JAX package.

The same numpy inputs go through pufferlib_tpu (ops.gae.compute_gae, the
Pallas kernel in interpret mode, compute_gae_flat) and through
pufferlib_tpu_torch (plain compute_gae, the kernel wrapper on CPU
tensors, compute_gae_flat). Tolerance 1e-5 absolute on values of order
1-10: both sides evaluate the same float32 expressions in the same order;
only the compiler's fusion of a multiply-add may round differently.
"""
import numpy as np
import pytest
import torch

from pufferlib_tpu.ops import compute_gae as jax_compute_gae
from pufferlib_tpu.ops import compute_gae_flat as jax_compute_gae_flat
from pufferlib_tpu.ops.pallas import compute_gae_pallas

from pufferlib_tpu_torch.ops import compute_gae, compute_gae_flat
from pufferlib_tpu_torch.ops.cuda.gae import compute_gae_cuda

torch.set_num_threads(1)

ATOL = 1e-5


def _inputs(T, E, seed, p_done=0.1):
    rng = np.random.RandomState(seed)
    rewards = rng.randn(T, E).astype(np.float32)
    values = rng.randn(T, E).astype(np.float32)
    dones = (rng.rand(T, E) < p_done).astype(np.float32)
    last_value = rng.randn(E).astype(np.float32)
    return rewards, values, dones, last_value


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize('T,E', [(32, 300), (64, 256), (7, 1), (1, 5)])
def test_gae_matches_jax_scan(T, E):
    args = _inputs(T, E, seed=T + E)
    expected = np.asarray(jax_compute_gae(*args, 0.99, 0.95))
    got = compute_gae(*_torch(*args), 0.99, 0.95).numpy()
    assert got.dtype == np.float32 and got.shape == (T, E)
    np.testing.assert_allclose(got, expected, rtol=0, atol=ATOL)


def test_gae_matches_pallas_kernel_ragged():
    """E=300 is not a multiple of the TPU kernel's 256-lane tile."""
    args = _inputs(32, 300, seed=0)
    expected = np.asarray(compute_gae_pallas(*args, 0.99, 0.95,
        interpret=True))
    got = compute_gae(*_torch(*args), 0.99, 0.95).numpy()
    np.testing.assert_allclose(got, expected, rtol=0, atol=ATOL)


@pytest.mark.parametrize('T,E', [(100, 257), (7, 33)])
def test_gae_kernel_edge_shapes_match_jax(T, E):
    """The CUDA kernel's edges: E % 4 != 0 (its 4-byte copies), T past one
    64-step chunk (its ring) and a single short chunk. The wrapper on CPU
    tensors against JAX's compute_gae and the Pallas kernel in interpret
    mode. On the CPU XLA may contract a multiply-add, so the port's kernel
    is held to its plain version bit for bit only on the card
    (tests/test_torch_cuda.py)."""
    args = _inputs(T, E, seed=T * E, p_done=0.3)
    got = compute_gae_cuda(*_torch(*args), 0.99, 0.95).numpy()
    assert got.dtype == np.float32 and got.shape == (T, E)
    np.testing.assert_allclose(got, np.asarray(jax_compute_gae(*args, 0.99,
        0.95)), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(compute_gae_pallas(*args,
        0.99, 0.95, interpret=True)), rtol=0, atol=ATOL)


def test_gae_all_done_rows():
    """Every step terminal: each advantage is its own reward - value, the
    bootstrap never reaches past a done."""
    T, E = 8, 130
    rewards = np.ones((T, E), np.float32)
    values = np.zeros((T, E), np.float32)
    dones = np.ones((T, E), np.float32)
    last_value = np.full(E, 100.0, np.float32)
    args = (rewards, values, dones, last_value)
    expected = np.asarray(compute_gae_pallas(*args, 0.99, 0.95,
        interpret=True))
    got = compute_gae(*_torch(*args), 0.99, 0.95).numpy()
    np.testing.assert_allclose(got, expected, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, 1.0, rtol=0, atol=ATOL)


def test_gae_mixed_done_rows_match_jax():
    """Whole rows done, whole rows not: the bootstrap is cut exactly at
    the done rows."""
    rewards, values, _, last_value = _inputs(16, 40, seed=3)
    dones = np.zeros((16, 40), np.float32)
    dones[[2, 3, 9, 15]] = 1.0
    args = (rewards, values, dones, last_value)
    expected = np.asarray(jax_compute_gae(*args, 0.9, 0.8))
    got = compute_gae(*_torch(*args), 0.9, 0.8).numpy()
    np.testing.assert_allclose(got, expected, rtol=0, atol=ATOL)


def test_kernel_wrapper_on_cpu_is_the_plain_version():
    args = _torch(*_inputs(16, 70, seed=5))
    np.testing.assert_array_equal(
        compute_gae_cuda(*args, 0.99, 0.95).numpy(),
        compute_gae(*args, 0.99, 0.95).numpy())


def test_kernel_wrapper_rejects_other_devices():
    args = [t.to('meta') for t in _torch(*_inputs(4, 8, seed=6))]
    with pytest.raises(ValueError, match='no GAE kernel'):
        compute_gae_cuda(*args, 0.99, 0.95)


@pytest.mark.parametrize('n,p_done', [(257, 0.1), (64, 0.0), (33, 1.0)])
def test_gae_flat_matches_jax(n, p_done):
    rng = np.random.RandomState(n)
    dones = (rng.rand(n) < p_done).astype(np.float32)
    values = rng.randn(n).astype(np.float32)
    rewards = rng.randn(n).astype(np.float32)
    expected = np.asarray(jax_compute_gae_flat(dones, values, rewards,
        0.99, 0.95))
    got = compute_gae_flat(*_torch(dones, values, rewards), 0.99,
        0.95).numpy()
    assert got.shape == (n,) and got[-1] == 0.0
    np.testing.assert_allclose(got, expected, rtol=0, atol=ATOL)
