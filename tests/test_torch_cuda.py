"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: they need an NVIDIA GPU (sm_90a) and nvcc, and skip
without them. On a machine with a card:

    python -m pytest tests/test_torch_cuda.py -m cuda

Tolerances are those of chip_smoke.py: GAE 1e-5 (the kernel rounds every
operation as the plain version does), MLP head 1e-4 in f32 and 2e-2 in
bf16 (one bf16 ulp of a hidden unit that rounds the other way); the LSTM
kernels 1e-5 in f32 and 2e-2 in bf16 of max(1, max |plain|) per output
and gradient (sums in another order; in bf16 a value that rounds one ulp
the other way inside the recurrence).
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


LSTM_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _lstm_case(kind, T, B, H, F, cdt, cuda):
    rng = np.random.RandomState(T * B + H)

    def arr(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(
            np.float32)).to(cuda)
    state = (arr(B, H, scale=0.5), arr(B, H, scale=0.5))
    weights = (arr(H, 4 * H, scale=H ** -0.5), arr(H, 4 * H, scale=H ** -0.5),
        arr(4 * H, scale=0.1))
    if kind == 'enc5':
        return (arr(T, B, F).to(cdt), *state, arr(F, H, scale=(2 / F) ** 0.5),
            arr(H, scale=0.1), *weights)
    return (arr(T, B, H, scale=0.5).to(cdt), *state, *weights)


@pytest.mark.parametrize('kind', ['enc5', 'cat'])
@pytest.mark.parametrize('T,B,H', [(16, 8192, 128), (16, 1000, 128),
    (3, 45, 32), (5, 100, 64)])
@pytest.mark.parametrize('cdt', [torch.float32, torch.bfloat16])
def test_lstm_kernels_match_plain(cuda, kind, T, B, H, cdt):
    """Forward (outs, hT, cT, cseq) and every gradient of the kernel pair
    against the plain versions on the same inputs."""
    from pufferlib_tpu_torch.ops.cuda import lstm_cat, lstm_enc
    mod = lstm_enc if kind == 'enc5' else lstm_cat
    fwd, bwd = ((lstm_enc.lstm_enc_reference, lstm_enc.lstm_enc_backward_reference)
        if kind == 'enc5' else
        (lstm_cat.lstm_cat_reference, lstm_cat.lstm_cat_backward_reference))
    args = _lstm_case(kind, T, B, H, 49, cdt, cuda)
    g = (torch.randn(T, B, H, device=cuda).to(cdt),
        torch.randn(B, H, device=cuda), torch.randn(B, H, device=cuda))
    before = dict(mod.KERNEL.fn_launches)
    with torch.no_grad():
        got = mod._launch_forward(*args, cdt)
        want = fwd(*args, cdt)
        bargs = (*args, want[0], want[3], *g, cdt)
        got += mod._launch_backward(*bargs)
        want += bwd(*bargs)
    torch.cuda.synchronize()
    assert all(mod.KERNEL.fn_launches[fn] == n + 1 for fn, n in before.items())
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and a.shape == w.shape
        scale = max(1.0, w.float().abs().max().item())
        torch.testing.assert_close(a.float(), w.float(), rtol=0,
            atol=LSTM_TOL[cdt] * scale)


def test_lstm_autograd_on_the_card(cuda):
    """LSTMWrapper on CUDA with use_kernel=None runs the enc5 kernels for
    T > 1, and its weight gradients match the same module on the CPU
    (plain versions) in f32, within 1e-5 of max(1, max |gradient|) as
    the kernel checks above."""
    from pufferlib_tpu_torch import spaces
    from pufferlib_tpu_torch.models import Default, LSTMWrapper
    from pufferlib_tpu_torch.ops.cuda import lstm_enc
    torch.manual_seed(0)
    mod = LSTMWrapper(Default((7, 7), spaces.Discrete(5), hidden_size=64),
        obs_shape=(7, 7), input_size=64, hidden_size=64)
    x = torch.randn(40, 6, 7, 7)
    grads = []
    for dev, use in (('cpu', True), (cuda, None)):
        mod.to(dev).use_kernel = use
        mod.zero_grad()
        logits, value, (h, c) = mod(x.to(dev))
        (logits.square().sum() + value.sum() + (h * c).sum()).backward()
        # a copy: moving the module moves the grads it holds in place
        grads.append({k: p.grad.cpu().clone()
            for k, p in mod.named_parameters()})
    assert lstm_enc.KERNEL.fn_launches['lstm_enc_backward'] > 0
    for k, want in grads[0].items():
        scale = max(1.0, want.abs().max().item())
        err = (grads[1][k] - want).abs().max().item()
        assert err <= LSTM_TOL[torch.float32] * scale, (k, err, scale)
