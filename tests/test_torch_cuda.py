"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: they need an NVIDIA GPU (sm_90a) and nvcc, and skip
without them. On a machine with a card:

    python -m pytest tests/test_torch_cuda.py -m cuda

Tolerances are those of chip_smoke.py: GAE 1e-5 (the kernel rounds every
operation as the plain version does), MLP head 1e-4 in f32 and 2e-2 in
bf16 (one bf16 ulp of a hidden unit that rounds the other way).
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


@pytest.mark.parametrize('T,E', [(64, 8192), (64, 1000), (5, 33)])
def test_gae_kernel_matches_plain(cuda, T, E):
    from pufferlib_tpu_torch.ops.cuda import gae
    rng = np.random.RandomState(T + E)
    args = [torch.from_numpy(a).to(cuda) for a in (
        rng.randn(T, E).astype(np.float32),
        rng.randn(T, E).astype(np.float32),
        (rng.rand(T, E) < 0.2).astype(np.float32),
        rng.randn(E).astype(np.float32))]
    before = gae.KERNEL.launches
    got = gae.compute_gae_cuda(*args, 0.99, 0.95)
    want = gae.compute_gae(*args, 0.99, 0.95)
    torch.cuda.synchronize()
    assert gae.KERNEL.launches == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize('B', [8192, 1000, 1])
@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-4),
    (torch.bfloat16, 2e-2)])
def test_mlp_head_kernel_matches_plain(cuda, B, dtype, tol):
    from pufferlib_tpu_torch.ops.cuda import mlp
    rng = np.random.RandomState(B)
    x = torch.from_numpy(rng.randn(B, 49).astype(np.float32)).to(cuda)
    ws = [torch.from_numpy(a).to(cuda) for a in (
        (rng.randn(49, 128) * 0.2).astype(np.float32),
        (rng.randn(128) * 0.1).astype(np.float32),
        (rng.randn(128, 9) * 0.1).astype(np.float32),
        (rng.randn(9) * 0.1).astype(np.float32))]
    before = mlp.KERNEL.launches
    with torch.no_grad():
        got = mlp.mlp_head(x.to(dtype), *ws, dtype)
        want = mlp.mlp_head_reference(x.to(dtype), *ws, dtype)
    torch.cuda.synchronize()
    assert mlp.KERNEL.launches == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=tol)


def test_mlp_head_kernel_rejects_bad_inputs(cuda):
    from pufferlib_tpu_torch.ops.cuda import mlp
    x = torch.zeros(8, 49, device=cuda)
    w1 = torch.zeros(128, 49, device=cuda).t()  # not contiguous
    with pytest.raises(ValueError, match='contiguous'):
        mlp.mlp_head(x, w1, torch.zeros(128, device=cuda),
            torch.zeros(128, 9, device=cuda), torch.zeros(9, device=cuda),
            torch.float32)
