"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: they need an NVIDIA GPU (sm_90a) and nvcc, and skip
without them. On a machine with a card:

    python -m pytest tests/test_torch_cuda.py -m cuda

Tolerances are those of chip_smoke.py: GAE 1e-5 and, since the kernel
rounds every operation as the plain version does, also equal bit for bit;
MLP head 1e-4 in f32 and 2e-2 in bf16 (one bf16 ulp of a hidden unit that
rounds the other way; the bf16 tensor-core kernel also equal to itself bit
for bit across runs); the LSTM
kernels (enc5, cat, enc, scan, fused and the archived enc2, enc3, enc4,
enc6, tm) 1e-5 in f32 and 2e-2 in bf16 of max(1, max |plain|) per output
and gradient (sums in another order; in bf16 a value that rounds one ulp
the other way inside the recurrence). lstm_scan, lstm_scan_cat,
lstm_scan_fused and the enc5 pair run their tensor-core kernels in bf16
(also at input widths other than the hidden size, and enc5 at feature
widths up to the encoder's limit); in f32 the enc5, cat and fused pairs
and every backward run csrc/lstm_f32.cuh's cluster kernels (enc4's and
enc6's equal to enc5's bit for bit), and so do lstm_scan's and tm's
forwards (the two-sums loop on x_proj) and the archived enc2's forward
(enc5's forward with the two sums). The archived tm's step kernels run lstm_scan's loops one
step a launch (both ways, both dtypes) and must equal lstm_scan's kernels
bit for bit.
"""
import importlib

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


@pytest.mark.parametrize('T,E', [(64, 8192), (64, 1000), (100, 257),
    (7, 33)])
def test_gae_kernel_equals_plain_bit_for_bit(cuda, T, E):
    """Every product and sum rounded on its own, in the plain version's
    order: the kernel gives the plain version's bits. (100, 257) takes
    the 4-byte copies (E % 4 != 0) and two chunks of T through the ring."""
    from pufferlib_tpu_torch.ops.cuda import gae
    rng = np.random.RandomState(T * E)
    args = [torch.from_numpy(a).to(cuda) for a in (
        rng.uniform(-1, 1, (T, E)).astype(np.float32),
        rng.randn(T, E).astype(np.float32),
        (rng.rand(T, E) < 0.3).astype(np.float32),
        rng.randn(E).astype(np.float32))]
    before = gae.KERNEL.launches
    got = gae.compute_gae_cuda(*args, 0.99, 0.95)
    want = gae.compute_gae(*args, 0.99, 0.95)
    torch.cuda.synchronize()
    assert gae.KERNEL.launches == before + 1
    assert torch.equal(got, want)


def _mlp_case(rng, B, F, H, O, cuda):
    x = torch.from_numpy(rng.randn(B, F).astype(np.float32)).to(cuda)
    ws = [torch.from_numpy(a).to(cuda) for a in (
        (rng.randn(F, H) * np.sqrt(2 / F)).astype(np.float32),
        (rng.randn(H) * 0.1).astype(np.float32),
        (rng.randn(H, O) / np.sqrt(H)).astype(np.float32),
        (rng.randn(O) * 0.1).astype(np.float32))]
    return x, ws


# (B, F, H, O, x dtype): the trainer's shapes, ragged tiles, H in several
# chunks, O past one 32-column pass, and each of the bf16 kernel's
# configurations (mlp.TC_CONFIGS: 0 at F = 49, 1 at F = 200 / H = 256, 2
# at H = 512, 3 at F = 1500)
MLP_TC_CASES = [
    (8192, 49, 128, 9, torch.bfloat16),
    (131072, 49, 128, 9, torch.bfloat16),
    (1000, 49, 128, 9, torch.float32),
    (1, 49, 128, 9, torch.bfloat16),
    (65, 49, 128, 40, torch.bfloat16),
    (24, 200, 256, 17, torch.bfloat16),
    (1000, 200, 256, 17, torch.bfloat16),
    (1000, 200, 512, 17, torch.bfloat16),
    (1000, 200, 512, 17, torch.float32),
    (300, 1500, 8, 2, torch.bfloat16),
    (77, 7, 20, 3, torch.bfloat16),
    # the Ocean envs': one feature (rows of 2 bytes), password's 5, spaces'
    # 30 nativized features; bandit's 11 outputs, spaces' 5, binary 3
    (128, 1, 128, 11, torch.bfloat16),
    (4096, 1, 128, 11, torch.bfloat16),
    (256, 5, 128, 3, torch.bfloat16),
    (1024, 30, 128, 5, torch.bfloat16),
    (4096, 1, 128, 3, torch.bfloat16),
]


@pytest.mark.parametrize('B,F,H,O,x_dtype', MLP_TC_CASES)
def test_mlp_head_tensor_core_kernel_matches_plain(cuda, B, F, H, O,
        x_dtype):
    """bf16 compute: the tensor-core kernel, one launch a call, within the
    bf16 tolerance of the plain version (one bf16 ulp of a hidden unit
    that rounds the other way), and equal bit for bit across two runs."""
    from pufferlib_tpu_torch.ops.cuda import mlp
    rng = np.random.RandomState(B + F + H + O)
    x, ws = _mlp_case(rng, B, F, H, O, cuda)
    x = x.to(x_dtype)
    before = mlp.KERNEL.launches
    with torch.no_grad():
        got = mlp.mlp_head(x, *ws, torch.bfloat16)
        again = mlp.mlp_head(x, *ws, torch.bfloat16)
        want = mlp.mlp_head_reference(x, *ws, torch.bfloat16)
    torch.cuda.synchronize()
    assert mlp.KERNEL.launches == before + 2
    assert got.shape == (B, O) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=2e-2)
    assert torch.equal(got, again)


@pytest.mark.parametrize('offset', [1, 3, 7])
def test_mlp_head_reads_x_at_any_offset(cuda, offset):
    """x a view that starts off the 16-byte boundary (a slice of a larger
    storage): read in place, the same result as a contiguous copy."""
    from pufferlib_tpu_torch.ops.cuda import mlp
    rng = np.random.RandomState(offset)
    x, ws = _mlp_case(rng, 1001, 49, 128, 9, cuda)
    flat = torch.zeros(offset + x.numel(), dtype=torch.bfloat16, device=cuda)
    flat[offset:] = x.reshape(-1).to(torch.bfloat16)
    view = flat[offset:].view(1001, 49)
    assert view.data_ptr() % 16 != 0 and view.is_contiguous()
    with torch.no_grad():
        got = mlp.mlp_head(view, *ws, torch.bfloat16)
        want = mlp.mlp_head(view.clone(), *ws, torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_mlp_head_tc_config_is_the_kernels(cuda):
    """mlp.tc_config copies the C side's choice of configuration, and with
    it the shape limit that mlp_shape_error states."""
    from pufferlib_tpu_torch.ops.cuda import mlp
    lib = mlp.KERNEL.lib()
    for F in (1, 7, 49, 200, 700, 1500, 1816, 2500, 4000):
        for H in (1, 20, 128, 256, 512, 1024):
            for O in (1, 9, 17, 40, 300):
                for x_dtype in (torch.bfloat16, torch.float32):
                    c = lib.mlp_head_tc_config(F, H, O,
                        int(x_dtype == torch.bfloat16))
                    want = mlp.tc_config(F, H, O, x_dtype)
                    assert c == (-1 if want is None else want), (F, H, O,
                        x_dtype)


def test_mlp_head_refuses_past_its_limit_before_launch(cuda):
    from pufferlib_tpu_torch.ops.cuda import mlp
    F, H, O = 4000, 16, 1
    assert mlp.mlp_shape_error(F, H, O, torch.bfloat16) is not None
    x = torch.zeros(16, F, dtype=torch.bfloat16, device=cuda)
    ws = (torch.zeros(F, H, device=cuda), torch.zeros(H, device=cuda),
        torch.zeros(H, O, device=cuda), torch.zeros(O, device=cuda))
    before = mlp.KERNEL.launches
    with pytest.raises(ValueError, match='shared memory'):
        mlp.mlp_head(x, *ws, torch.bfloat16)
    assert mlp.KERNEL.launches == before


def test_mlp_head_kernel_rejects_bad_inputs(cuda):
    from pufferlib_tpu_torch.ops.cuda import mlp
    x = torch.zeros(8, 49, device=cuda)
    w1 = torch.zeros(128, 49, device=cuda).t()  # not contiguous
    with pytest.raises(ValueError, match='contiguous'):
        mlp.mlp_head(x, w1, torch.zeros(128, device=cuda),
            torch.zeros(128, 9, device=cuda), torch.zeros(9, device=cuda),
            torch.float32)


# (B, F, H, O, x dtype, element offset of x): the f32 kernel at the
# bench's two shapes, ragged batches (a last tile of 40 and 41 rows), the
# CLI's f32 squared run (256 lanes, 4096-row minibatches; squared's 49
# features, 8 actions + value), x and the weights read from device memory
# (the streamed configuration: F = 300 and, with bf16 x, 185 just past
# the resident one's limit; several hidden chunks and output passes at F
# = 200, H = 256, O = 17), bf16 x, x at odd element offsets (a view
# into a larger storage), and H = 130, whose W1 rows the resident
# configuration stages 4 bytes at a time (16 where H % 4 == 0)
MLP_F32_CASES = [
    (8192, 49, 128, 9, torch.float32, 0),
    (131072, 49, 128, 9, torch.float32, 0),
    (1000, 49, 128, 9, torch.float32, 0),
    (1001, 49, 128, 9, torch.float32, 0),
    (256, 49, 128, 9, torch.float32, 0),
    (4096, 49, 128, 9, torch.float32, 0),
    (1000, 200, 256, 17, torch.float32, 0),
    (1001, 200, 256, 17, torch.bfloat16, 0),
    (77, 7, 20, 3, torch.float32, 0),
    (1000, 49, 128, 9, torch.bfloat16, 0),
    (1001, 49, 128, 9, torch.float32, 3),
    (1001, 49, 128, 9, torch.bfloat16, 1),
    (130, 1, 128, 11, torch.float32, 0),
    (1000, 300, 128, 9, torch.float32, 0),
    (1001, 185, 128, 9, torch.bfloat16, 3),
    (1000, 49, 130, 9, torch.float32, 0),
]


@pytest.mark.parametrize('B,F,H,O,x_dtype,offset', MLP_F32_CASES)
def test_mlp_head_f32_kernel_matches_plain(cuda, B, F, H, O, x_dtype,
        offset):
    """f32 compute: the register-tiled FMA kernel, one launch a call,
    within 1e-4 of the plain version (the same f32 products, layer 2 summed
    in eight fixed parts), and equal bit for bit across two runs; x read
    in place at any offset."""
    from pufferlib_tpu_torch.ops.cuda import mlp
    rng = np.random.RandomState(B + F + H + O + offset)
    x, ws = _mlp_case(rng, B, F, H, O, cuda)
    flat = torch.zeros(offset + x.numel(), dtype=x_dtype, device=cuda)
    flat[offset:] = x.reshape(-1).to(x_dtype)
    x = flat[offset:].view(B, F)
    before = mlp.KERNEL.launches
    with torch.no_grad():
        got = mlp.mlp_head(x, *ws, torch.float32)
        again = mlp.mlp_head(x, *ws, torch.float32)
        want = mlp.mlp_head_reference(x, *ws, torch.float32)
    torch.cuda.synchronize()
    assert mlp.KERNEL.launches == before + 2
    assert got.shape == (B, O) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    assert torch.equal(got, again)


@pytest.mark.parametrize('offset', [1, 2])
def test_mlp_head_f32_kernel_reads_w1_at_any_offset(cuda, offset):
    """W1 a contiguous view that does not start on a 16-byte boundary:
    the resident configuration stages it 4 bytes at a time; the same
    numbers as an aligned copy, bit for bit."""
    from pufferlib_tpu_torch.ops.cuda import mlp
    rng = np.random.RandomState(offset)
    x, (w1, b1, w2, b2) = _mlp_case(rng, 1000, 49, 128, 9, cuda)
    flat = torch.zeros(offset + w1.numel(), device=cuda)
    flat[offset:] = w1.reshape(-1)
    w1_view = flat[offset:].view(49, 128)
    with torch.no_grad():
        got = mlp.mlp_head(x, w1_view, b1, w2, b2, torch.float32)
        want = mlp.mlp_head(x, w1, b1, w2, b2, torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_mlp_head_f32_config_is_the_kernels(cuda):
    """The C side's choice of configuration: resident (0) at the
    trainer's head and up to the resident configuration's limit at H 128
    (F 148 with f32 x, 184 with bf16 x), streamed (1) past it and at
    wider heads; -1 for a shape no kernel takes."""
    from pufferlib_tpu_torch.ops.cuda import mlp
    lib = mlp.KERNEL.lib()
    for F, H, O, x_bf16, config in ((49, 128, 9, 0, 0), (49, 128, 9, 1, 0),
            (148, 128, 9, 0, 0), (149, 128, 9, 0, 1), (184, 128, 9, 1, 0),
            (185, 128, 9, 1, 1), (300, 128, 9, 0, 1), (200, 256, 17, 0, 1),
            (4000, 4000, 4000, 0, 1)):
        assert lib.mlp_head_f32_config(F, H, O, x_bf16) == config, (F, H,
            O, x_bf16)
    assert lib.mlp_head_f32_config(0, 128, 9, 0) == -1


LSTM_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


ARCHIVED_ENC = ('enc2', 'enc3', 'enc4', 'enc6')
ENC_KINDS = ('enc5', 'enc', 'enc5_stream') + ARCHIVED_ENC
XP_KINDS = ('scan', 'tm')


def _archived(kind):
    return importlib.import_module(
        f'pufferlib_tpu_torch.ops.cuda.archive.lstm_{kind}')


def _lstm_kinds():
    """kind -> (kernel forward, kernel backward, plain forward, plain
    backward, the C functions of the forward and of the backward)."""
    from pufferlib_tpu_torch.ops.cuda import lstm_cat, lstm_enc, lstm_scan
    lstm_tm = _archived('tm')
    kinds = {
        'enc5': (lstm_enc._launch_forward,
            lstm_enc._launch_backward, lstm_enc.lstm_enc_reference,
            lstm_enc.lstm_enc_backward_reference,
            ('lstm_enc_forward', 'lstm_enc_backward')),
        'enc': (lstm_enc._launch_forward,
            lstm_enc._launch_step_backward, lstm_enc.lstm_enc_reference,
            lstm_enc.lstm_scan_enc_backward_reference,
            ('lstm_enc_forward', 'lstm_enc_step_backward')),
        # the resident cat's and fused's f32 backwards take their
        # forward's x @ W_ih (+ b) slab
        'cat': (*lstm_cat.kept_for_backward(lstm_cat._launch_forward,
            lstm_cat._launch_backward), lstm_cat.lstm_cat_reference,
            lstm_cat.lstm_cat_backward_reference,
            ('lstm_cat_forward', 'lstm_cat_backward')),
        'cat_stream': (*lstm_cat.kept_for_backward(
            lstm_cat._launch_stream_forward, lstm_cat._launch_stream_backward),
            lstm_cat.lstm_cat_reference,
            lstm_cat.lstm_cat_backward_reference,
            ('lstm_cat_stream_forward', 'lstm_cat_stream_backward')),
        'enc5_stream': (*lstm_cat.kept_for_backward(
            lstm_enc._launch_stream_forward, lstm_enc._launch_stream_backward),
            lstm_enc.lstm_enc_reference,
            lstm_enc.lstm_enc_backward_reference,
            ('lstm_enc_stream_forward', 'lstm_enc_stream_backward')),
        'fused': (*lstm_cat.kept_for_backward(lstm_scan._launch_fused_forward,
            lstm_scan._launch_fused_backward),
            lstm_scan.lstm_scan_fused_reference,
            lstm_scan.lstm_scan_fused_backward_reference,
            ('lstm_fused_forward', 'lstm_fused_backward')),
        'scan': (lstm_scan._launch_scan_forward,
            lstm_scan._launch_scan_backward, lstm_scan.lstm_scan_reference,
            lstm_scan.lstm_scan_backward_reference,
            ('lstm_scan_forward', 'lstm_scan_backward')),
        'tm': (lstm_tm._launch_forward, lstm_tm._launch_backward,
            lstm_tm.lstm_tm_reference, lstm_tm.lstm_tm_backward_reference,
            ('lstm_tm_step_forward', 'lstm_tm_step_backward')),
    }
    for kind in ARCHIVED_ENC:
        v = _archived(kind).VARIANT
        kinds[kind] = (v.forward_launch, v.backward_launch, v.forward_plain,
            v.backward_plain, ('lstm_enc2_forward' if kind == 'enc2'
                else 'lstm_enc_forward', f'lstm_{kind}_backward'))
    return kinds


def _launches():
    """Launch counts by C function, over every kernel source."""
    from pufferlib_tpu_torch.ops.cuda import KERNELS
    return {fn: n for k in KERNELS for fn, n in k.fn_launches.items()}


def _steps(kind, T):
    """Launches of one call: tm launches its step kernel once per
    timestep, every other kind once."""
    return T if kind == 'tm' else 1


def _lstm_case(kind, T, B, H, F, cdt, cuda, xp_dtype=None, D=None):
    """Inputs of one call; D, the input width of cat and fused and the
    encoder width of enc5, is H when None."""
    D = D or H
    rng = np.random.RandomState(T * B + D)

    def arr(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(
            np.float32)).to(cuda)
    state = (arr(B, H, scale=0.5), arr(B, H, scale=0.5))
    weights = (arr(D, 4 * H, scale=D ** -0.5), arr(H, 4 * H, scale=H ** -0.5),
        arr(4 * H, scale=0.1))
    if kind in ENC_KINDS:
        return (arr(T, B, F).to(cdt), *state, arr(F, D, scale=(2 / F) ** 0.5),
            arr(D, scale=0.1), *weights)
    if kind in XP_KINDS:
        return (arr(T, B, 4 * H).to(xp_dtype or cdt), *state, weights[1])
    return (arr(T, B, D, scale=0.5).to(cdt), *state, *weights)


def _check_lstm_pair(cuda, kind, T, B, H, cdt, xp_dtype=None, D=None, F=49):
    fwd, bwd, fwd_plain, bwd_plain, fns = _lstm_kinds()[kind]
    args = _lstm_case(kind, T, B, H, F, cdt, cuda, xp_dtype, D)
    g = (torch.randn(T, B, H, device=cuda).to(cdt),
        torch.randn(B, H, device=cuda), torch.randn(B, H, device=cuda))
    before = _launches()
    with torch.no_grad():
        got = fwd(*args, cdt)
        want = fwd_plain(*args, cdt)
        bargs = (*args, want[0], want[3], *g, cdt)
        got += bwd(*bargs)
        want += bwd_plain(*bargs)
    torch.cuda.synchronize()
    after = _launches()
    assert all(after[fn] == n + (fn in fns) * _steps(kind, T)
        for fn, n in before.items())
    tol = LSTM_TOL[torch.bfloat16 if torch.bfloat16 in (cdt, xp_dtype)
        else torch.float32]
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and a.shape == w.shape
        scale = max(1.0, w.float().abs().max().item())
        torch.testing.assert_close(a.float(), w.float(), rtol=0,
            atol=tol * scale)
    return args, got


@pytest.mark.parametrize('kind', ['enc5', 'cat'])
@pytest.mark.parametrize('T,B,H', [(16, 8192, 128), (16, 1000, 128),
    (3, 45, 32), (5, 100, 64)])
@pytest.mark.parametrize('cdt', [torch.float32, torch.bfloat16])
def test_lstm_kernels_match_plain(cuda, kind, T, B, H, cdt):
    """Forward (outs, hT, cT, cseq) and every gradient of the kernel pair
    against the plain versions on the same inputs."""
    _check_lstm_pair(cuda, kind, T, B, H, cdt)


SCAN_SHAPES = [(16, 8192, 128), (16, 1000, 128), (3, 45, 32), (5, 100, 64)]
# lstm_scan_fused's bf16 loops hold 64 batch rows per block: one row, and
# one block with a single row over, at every hidden size
FUSED_EDGES = [(T, B, H) for T, B in ((1, 1), (5, 65)) for H in (32, 64, 128)]


@pytest.mark.parametrize('kind,T,B,H', [(kind, *shape)
    for kind in ('scan', 'fused', 'enc') for shape in SCAN_SHAPES]
    + [(kind, *shape) for kind in ('fused', 'scan') for shape in FUSED_EDGES])
@pytest.mark.parametrize('cdt', [torch.float32, torch.bfloat16])
def test_lstm_scan_kernels_match_plain(cuda, kind, T, B, H, cdt):
    """lstm_scan, lstm_scan_fused and lstm_scan_enc: forward, every
    gradient, and the forward that is handed a null cseq, which must give
    the saving forward's outs, hT and cT bit for bit."""
    _check_pair_and_primal(cuda, kind, T, B, H, cdt)


@pytest.mark.parametrize('T,B,H', FUSED_EDGES)
@pytest.mark.parametrize('cdt', [torch.float32, torch.bfloat16])
def test_lstm_cat_edges_match_plain(cuda, T, B, H, cdt):
    """The cat pair at one step, one row, and one row over a 64-row
    block of the bf16 loops (B = 65: the slab's padding and the element
    stores of a batch that is no multiple of 16), at every hidden size."""
    _check_lstm_pair(cuda, 'cat', T, B, H, cdt)


# (T, B, D, H) with the input width apart from the hidden size
TC_WIDTHS = [(16, 8192, 96, 128), (16, 1000, 96, 128), (5, 65, 40, 32),
    (3, 100, 200, 64), (2, 64, 640, 128)]


@pytest.mark.parametrize('kind', ['cat', 'fused'])
@pytest.mark.parametrize('T,B,D,H', TC_WIDTHS)
def test_lstm_tensor_core_kernels_take_other_input_widths(cuda, kind, T, B,
        D, H):
    """cat's and fused's bf16 kernels at D != H (640 at H = 128 is the
    widest a pre-pass block holds), against the plain versions; fused's
    null-cseq forward bit for bit."""
    fwd = _lstm_kinds()[kind][0]
    args, got = _check_lstm_pair(cuda, kind, T, B, H, torch.bfloat16, D=D)
    if kind == 'fused':
        with torch.no_grad():
            primal = fwd(*args, torch.bfloat16, False)
        torch.cuda.synchronize()
        assert primal[3] is None
        for a, w in zip(primal[:3], got[:3]):
            assert torch.equal(a, w)


def test_lstm_cell_launchers_refuse_what_the_kernels_do_not_serve(cuda):
    """cat and fused: the FMA kernels (f32) refuse D != H, the bf16 ones
    a width that is no multiple of 8 or too wide and a hidden size off
    {32, 64, 128}: ValueError, and no launch."""
    before = _launches()
    for kind in ('cat', 'fused'):
        fwd = _lstm_kinds()[kind][0]
        for T, B, D, H, cdt, message in (
                (2, 8, 96, 128, torch.float32, 'input width equal'),
                (2, 8, 100, 128, torch.bfloat16, 'multiples of 8'),
                (2, 8, 648, 128, torch.bfloat16, 'up to 640'),
                (2, 8, 256, 256, torch.bfloat16, 'hidden sizes')):
            args = _lstm_case(kind, T, B, H, 49, cdt, cuda, D=D)
            with pytest.raises(ValueError, match=message):
                fwd(*args, cdt)
    assert _launches() == before


def _check_deterministic(cuda, kind, T, B, H, D=None, F=49,
        cdt=torch.bfloat16, runs=2, xp_dtype=None):
    """`runs` forward and backward calls on the same inputs: every one
    equal to the first bit for bit."""
    fwd, bwd = _lstm_kinds()[kind][:2]
    args = _lstm_case(kind, T, B, H, F, cdt, cuda, xp_dtype, D=D)
    g = (torch.randn(T, B, H, device=cuda).to(cdt),
        torch.randn(B, H, device=cuda), torch.randn(B, H, device=cuda))
    results = []
    with torch.no_grad():
        for _ in range(runs):
            outs, hT, cT, cseq = fwd(*args, cdt)
            results.append((outs, hT, cT, cseq)
                + bwd(*args, outs, cseq, *g, cdt))
    torch.cuda.synchronize()
    for later in results[1:]:
        for a, w in zip(later, results[0]):
            assert torch.equal(a, w)


@pytest.mark.parametrize('T,B,H', [(16, 1000, 128), (5, 65, 32)])
def test_lstm_fused_bf16_is_deterministic(cuda, T, B, H):
    """lstm_scan_fused's bf16 kernels add every partial sum in a fixed
    order (no atomics): the same inputs twice give the same outputs and
    gradients bit for bit."""
    _check_deterministic(cuda, 'fused', T, B, H)


@pytest.mark.parametrize('T,B,D,H', [(16, 1000, 128, 128), (5, 65, 32, 32),
    (16, 1000, 96, 128)])
def test_lstm_cat_bf16_is_deterministic(cuda, T, B, D, H):
    """The same of lstm_scan_cat's bf16 kernels."""
    _check_deterministic(cuda, 'cat', T, B, H, D)


# cat's streamed design (csrc/lstm_cat_stream.cu): the Atari update's
# shape, hidden 256, an input width apart from the hidden size, one that
# is no multiple of 8, and a ragged batch
STREAM_SHAPES = [(16, 256, 512, 512), (16, 256, 256, 256), (8, 64, 200, 128),
    (4, 32, 9, 64), (3, 45, 20, 96)]


@pytest.mark.parametrize('T,B,D,H', STREAM_SHAPES)
@pytest.mark.parametrize('cdt', [torch.float32, torch.bfloat16])
def test_lstm_cat_stream_matches_plain(cuda, T, B, D, H, cdt):
    """Forward and every gradient of cat's streamed design against the
    plain versions."""
    _check_lstm_pair(cuda, 'cat_stream', T, B, H, cdt, D=D)


@pytest.mark.parametrize('T,B,D,H', STREAM_SHAPES[2:])
def test_lstm_cat_stream_is_deterministic(cuda, T, B, D, H):
    """The streamed design adds every sum in a fixed order: two runs are
    equal bit for bit."""
    _check_deterministic(cuda, 'cat_stream', T, B, H, D)


def test_lstm_scan_cat_picks_the_design_by_shape(cuda):
    """lstm_scan_cat launches the resident kernels where they serve (f32
    at hidden 256 among them) and the streamed ones elsewhere (bf16 at
    hidden 256; hidden 100 padded to 128); a hidden size no design takes
    raises before a launch."""
    from pufferlib_tpu_torch.ops.cuda.lstm_cat import lstm_scan_cat
    for D, H, cdt, fn in ((128, 128, torch.bfloat16, 'lstm_cat_forward'),
            (256, 256, torch.float32, 'lstm_cat_forward'),
            (256, 256, torch.bfloat16, 'lstm_cat_stream_forward'),
            (96, 128, torch.float32, 'lstm_cat_stream_forward'),
            (512, 512, torch.bfloat16, 'lstm_cat_stream_forward'),
            (100, 100, torch.float32, 'lstm_cat_stream_forward')):
        args = _lstm_case('cat', 2, 8, H, 49, cdt, cuda, D=D)
        before = _launches()
        with torch.no_grad():
            lstm_scan_cat(*args, cdt)
        after = _launches()
        assert {k for k in after if after[k] != before[k]} == {fn}
    before = _launches()
    with pytest.raises(ValueError, match='up to 800'):
        lstm_scan_cat(*_lstm_case('cat', 2, 8, 801, 49, torch.float32,
            cuda), torch.float32)
    assert _launches() == before


# enc5's streamed design (csrc/lstm_cat_stream.cu, lstm_enc_stream_*):
# (T, B, F, D, H) at hidden 256 and 512 with the bench's 49 features, f32's
# encoder width 96 apart from hidden 128, bf16's 800 features past the
# tensor-core encoder's 768, minigrid's 147 features in f32, a ragged batch
# and an odd feature and encoder width
ENC5_STREAM_SHAPES = [(16, 256, 49, 256, 256), (16, 256, 49, 512, 512),
    (8, 1000, 49, 96, 128), (8, 1000, 800, 128, 128), (8, 1000, 147, 128, 128),
    (3, 45, 5, 20, 96)]


@pytest.mark.parametrize('T,B,F,D,H', ENC5_STREAM_SHAPES)
@pytest.mark.parametrize('cdt', [torch.float32, torch.bfloat16])
def test_enc5_stream_matches_plain(cuda, T, B, F, D, H, cdt):
    """Forward and every gradient of enc5's streamed design against the
    plain versions (lstm_enc_reference, lstm_enc_backward_reference): in
    bf16 the rounded activations and db from the rounded dgates."""
    _check_lstm_pair(cuda, 'enc5_stream', T, B, H, cdt, D=D, F=F)


@pytest.mark.parametrize('T,B,F,D,H', ENC5_STREAM_SHAPES[2:])
@pytest.mark.parametrize('cdt', [torch.float32, torch.bfloat16])
def test_enc5_stream_is_deterministic(cuda, T, B, F, D, H, cdt):
    """enc5's streamed design adds every sum in a fixed order (no atomic
    touches a value): two runs are equal bit for bit."""
    _check_deterministic(cuda, 'enc5_stream', T, B, H, D, F, cdt)


def test_lstm_scan_enc5_picks_the_design_by_shape(cuda):
    """lstm_scan_enc5 launches the resident enc5 kernels where they serve
    and the streamed ones elsewhere (hidden 256, f32 at D != H, bf16 past
    768 features, hidden 48 padded to 64); a hidden size no design takes
    raises before a launch."""
    from pufferlib_tpu_torch.ops.cuda.lstm_enc import lstm_scan_enc5
    bf16, f32 = torch.bfloat16, torch.float32
    for F, D, H, cdt, fn in ((49, 128, 128, bf16, 'lstm_enc_forward'),
            (49, 256, 256, bf16, 'lstm_enc_stream_forward'),
            (49, 256, 256, f32, 'lstm_enc_stream_forward'),
            (49, 96, 128, f32, 'lstm_enc_stream_forward'),
            (800, 128, 128, bf16, 'lstm_enc_stream_forward'),
            (49, 48, 48, f32, 'lstm_enc_stream_forward')):
        args = _lstm_case('enc5', 2, 8, H, F, cdt, cuda, D=D)
        before = _launches()
        with torch.no_grad():
            lstm_scan_enc5(*args, cdt)
        after = _launches()
        assert {k for k in after if after[k] != before[k]} == {fn}
    before = _launches()
    with pytest.raises(ValueError, match='up to 800'):
        lstm_scan_enc5(*_lstm_case('enc5', 2, 8, 801, 49, f32, cuda), f32)
    assert _launches() == before


@pytest.mark.parametrize('kind', ['cat', 'enc5'])
@pytest.mark.parametrize('cdt', [torch.float32, torch.bfloat16])
def test_stream_autograd_keeps_the_forward_gates(cuda, kind, cdt):
    """Through autograd, at a shape only the streamed design serves (hidden
    256), the forward's gates go to the backward: one C call each way, and
    every gradient within the tolerance of the plain backward's."""
    from pufferlib_tpu_torch.ops.cuda import lstm_cat, lstm_enc
    T, B, H = 5, 70, 256
    fn = lstm_cat.lstm_scan_cat if kind == 'cat' else lstm_enc.lstm_scan_enc5
    stream_kind = f'{kind}_stream'
    _, _, fwd_plain, bwd_plain, fns = _lstm_kinds()[stream_kind]
    args = _lstm_case(stream_kind, T, B, H, 49, cdt, cuda)
    first = 1 if kind == 'enc5' else 0
    for t in args[first:]:
        t.requires_grad_()
    g = (torch.randn(T, B, H, device=cuda).to(cdt),
        torch.randn(B, H, device=cuda), torch.randn(B, H, device=cuda))
    before = _launches()
    torch.autograd.backward(fn(*args, cdt), g)
    torch.cuda.synchronize()
    after = _launches()
    assert {k for k in after if after[k] != before[k]} == set(fns)
    assert all(after[f] == before[f] + 1 for f in fns)
    with torch.no_grad():
        plain_args = tuple(t.detach() for t in args)
        want = fwd_plain(*plain_args, cdt)
        want_g = bwd_plain(*plain_args, want[0], want[3], *g, cdt)
    for t, w in zip(args[first:], want_g):
        scale = max(1.0, w.float().abs().max().item())
        torch.testing.assert_close(t.grad.float(), w.float(), rtol=0,
            atol=LSTM_TOL[cdt] * scale)


def test_stream_limits_match_the_library(cuda):
    """lstm_common.STREAM_MAX_HIDDEN and STREAM_ROWS, which the checks
    and allocations before a launch use, must equal the limits the built
    lstm_cat_stream.cu gives (lstm_stream_limits) in both dtypes; the
    largest hidden size the launchers take pads to one the library takes,
    and the next one is refused."""
    from pufferlib_tpu_torch.ops.cuda import lstm_cat, lstm_common
    for cdt in (torch.float32, torch.bfloat16):
        top = lstm_common.STREAM_MAX_HIDDEN[cdt]
        assert lstm_cat.stream_limits(cdt) == (top, lstm_common.STREAM_ROWS)
        assert lstm_common.stream_hidden(top) == top
        assert lstm_common.stream_shape_error(1, top - 31, cdt) is None
        assert lstm_common.stream_shape_error(1, top + 1, cdt) is not None


# hidden sizes that are no multiple of 32, which the streamed launchers pad
# (48 to 64, 100 to 128, 200 to 224), at a ragged batch on the units
# schedule and at the default route's batch on the rows schedule
PADDED_SHAPES = [(8, 1000, 49, 48, 48), (8, 1000, 49, 100, 100),
    (8, 1000, 30, 96, 200), (16, 8192, 49, 200, 200)]


@pytest.mark.parametrize('kind', ['cat_stream', 'enc5_stream'])
@pytest.mark.parametrize('T,B,F,D,H', PADDED_SHAPES)
@pytest.mark.parametrize('cdt', [torch.float32, torch.bfloat16])
def test_stream_pads_the_hidden_size(cuda, kind, T, B, F, D, H, cdt):
    """Forward and every gradient of the streamed pairs against the plain
    versions at hidden sizes that are no multiple of 32, within the
    streamed rows' tolerance (LSTM_TOL): the zero units change no real
    output, only the units schedule's split of K in two halves."""
    _check_lstm_pair(cuda, kind, T, B, H, cdt, D=D, F=F)


@pytest.mark.parametrize('kind,shape', [('cat_stream', (16, 256, 512, 512)),
    ('enc5_stream', (16, 256, 49, 512, 512)),
    ('enc5_stream', (16, 8192, 49, 256, 256)),
    ('enc5_stream', (16, 8000, 49, 256, 256)),
    ('cat_stream', (16, 8192, 256, 256)), ('cat_stream', (16, 8000, 256, 256))])
@pytest.mark.parametrize('cdt', [torch.float32, torch.bfloat16])
def test_stream_pair_repeats_bit_for_bit(cuda, kind, shape, cdt):
    """The units schedule's blocks meet at a barrier on a counter in
    device memory each step; the rows schedule's ring hands stages from
    one chunk, step and tile to the next. A block that read h_prev or
    dg_{t+1} before it was published, or a stage before it arrived, would
    read stale rows, and runs would differ by timing: twenty runs at the
    main paths' shapes (the Atari update's on the units schedule; the
    default route at hidden 256, B 8192 and a ragged 8000, on the rows
    schedule) are all equal bit for bit."""
    if kind == 'cat_stream':
        T, B, D, H = shape
        _check_deterministic(cuda, kind, T, B, H, D, cdt=cdt, runs=20)
    else:
        T, B, F, D, H = shape
        _check_deterministic(cuda, kind, T, B, H, D, F, cdt, runs=20)


# bytes of a pattern on each side of every buffer _GuardedTorch hands out
GUARD = 4096


class _GuardedTorch:
    """torch, except that empty and empty_like put every tensor in the
    middle of a buffer with GUARD bytes of 0xA5 on each side, and keep the
    buffers: a kernel that writes past the end or before the start of any
    of them changes a guard."""

    def __init__(self):
        self.buffers = []

    def __getattr__(self, name):
        return getattr(torch, name)

    def empty(self, *shape, dtype=torch.float32, device=None):
        if len(shape) == 1 and not isinstance(shape[0], int):
            shape = tuple(shape[0])
        return self.guarded(shape, dtype, device)

    def empty_like(self, t):
        return self.guarded(t.shape, t.dtype, t.device)

    def guarded(self, shape, dtype, device):
        n = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
        buf = torch.full((n + 2 * GUARD,), 0xA5, dtype=torch.uint8,
            device=device)
        self.buffers.append((buf, n))
        return buf[GUARD:GUARD + n].view(dtype).view(tuple(shape))

    def overwritten(self):
        """Indices of the buffers whose guards changed."""
        torch.cuda.synchronize()
        return [i for i, (buf, n) in enumerate(self.buffers)
            if not bool((buf[:GUARD] == 0xA5).all())
            or not bool((buf[GUARD + n:] == 0xA5).all())]


@pytest.mark.parametrize('kind,shape', [('cat_stream', (3, 45, 20, 96)),
    ('cat_stream', (4, 200, 9, 256)), ('enc5_stream', (3, 45, 5, 20, 96)),
    ('enc5_stream', (4, 200, 49, 100, 256)),
    ('enc5_stream', (16, 8192, 49, 256, 256)),
    ('enc5_stream', (16, 8000, 49, 256, 256)),
    ('cat_stream', (16, 8000, 256, 256)),
    ('enc5_stream', (4, 8000, 49, 96, 200))])
@pytest.mark.parametrize('cdt', [torch.float32, torch.bfloat16])
def test_stream_pair_writes_only_its_buffers(cuda, monkeypatch, kind, shape,
        cdt):
    """Every input, output and scratch buffer of a streamed forward and
    backward call sits between guards; after both calls no guard has
    changed, at ragged batches (a last tile of 45, 8 or 0 rows of 64),
    input widths that are no multiple of 8, the rows schedule's B 8192
    and 8000 and a padded hidden size (200), and the results still match
    the plain versions within LSTM_TOL."""
    from pufferlib_tpu_torch.ops.cuda import lstm_cat, lstm_common, lstm_enc
    if kind == 'cat_stream':
        (T, B, D, H), F = shape, 49
    else:
        T, B, F, D, H = shape
    fwd, bwd, fwd_plain, bwd_plain, _ = _lstm_kinds()[kind]
    guarded = _GuardedTorch()
    args = tuple(guarded.guarded(t.shape, t.dtype, t.device).copy_(t)
        for t in _lstm_case(kind, T, B, H, F, cdt, cuda, D=D))
    g = tuple(guarded.guarded(t.shape, t.dtype, t.device).copy_(t) for t in (
        torch.randn(T, B, H, device=cuda).to(cdt),
        torch.randn(B, H, device=cuda), torch.randn(B, H, device=cuda)))
    with torch.no_grad():
        want = fwd_plain(*args, cdt)
        bargs = (*args, want[0], want[3], *g, cdt)
        want += bwd_plain(*bargs)
        for module in (lstm_cat, lstm_common, lstm_enc):
            monkeypatch.setattr(module, 'torch', guarded)
        inputs = len(guarded.buffers)
        got = fwd(*args, cdt)
        got += bwd(*bargs)
    assert guarded.overwritten() == []
    # the launchers' outputs and scratch went through the guards too
    assert len(guarded.buffers) > inputs + len(got)
    for a, w in zip(got, want):
        scale = max(1.0, w.float().abs().max().item())
        torch.testing.assert_close(a.float(), w.float(), rtol=0,
            atol=LSTM_TOL[cdt] * scale)


# enc5's bf16 encoder at feature widths that are no multiple of 8 (49: the
# bench's, 98-byte rows), one that is (200), and the widest its GEMM block
# holds (768, lstm_common.tc_max_features)
ENC5_FEATURES = (49, 200, 768)


@pytest.mark.parametrize('F', ENC5_FEATURES)
@pytest.mark.parametrize('T,B,H', FUSED_EDGES)
def test_enc5_tensor_core_edges_match_plain(cuda, T, B, H, F):
    """The enc5 pair's bf16 kernels at one step, one row, and one row over
    a 64-row block of the loops, at every hidden size, with the encoder
    emitting 96 (D != H), against the plain versions."""
    _check_lstm_pair(cuda, 'enc5', T, B, H, torch.bfloat16, D=96, F=F)


@pytest.mark.parametrize('T,B,D,H,F', [(16, 1000, 96, 128, 200),
    (16, 8192, 96, 128, 200), (5, 65, 40, 32, 49), (3, 100, 200, 64, 768),
    (2, 64, 640, 128, 49), (8, 512, 128, 128, 1), (4, 256, 64, 64, 1)])
def test_enc5_tensor_core_kernels_take_other_widths(cuda, T, B, D, H, F):
    """enc5's bf16 kernels at encoder widths D != H (640 at H = 128 is the
    widest a pre-pass block holds), feature widths past the FMA
    kernels' 128, and the Ocean memory env's one feature (rows of 2
    bytes), against the plain versions."""
    _check_lstm_pair(cuda, 'enc5', T, B, H, torch.bfloat16, D=D, F=F)


def test_enc5_launchers_refuse_what_the_kernels_do_not_serve(cuda):
    """enc5: in bf16 a feature width past tc_max_features, an encoder width
    that is no multiple of 8 or too wide, a hidden size off {32, 64, 128};
    in f32 (FMA) D != H and more than 128 features. The forward of the
    archived enc3, enc4 and enc6 (_launch_enc_forward), whose backwards
    take D == H in f32, keeps that reach in bf16 too. ValueError, and no
    launch."""
    from pufferlib_tpu_torch.ops.cuda import lstm_common, lstm_enc
    limit = lstm_common.tc_max_features()
    before = _launches()
    bf16, f32 = torch.bfloat16, torch.float32
    for launch, T, B, D, H, F, cdt, message in (
            (lstm_enc._launch_forward, 2, 8, 96, 128, limit + 1, bf16,
                f'at most {limit} features'),
            (lstm_enc._launch_backward, 2, 8, 96, 128, limit + 1, bf16,
                f'at most {limit} features'),
            (lstm_enc._launch_forward, 2, 8, 100, 128, 49, bf16,
                'multiples of 8'),
            (lstm_enc._launch_forward, 2, 8, 648, 128, 49, bf16, 'up to 640'),
            (lstm_enc._launch_forward, 2, 8, 256, 256, 49, bf16,
                'hidden sizes'),
            (lstm_enc._launch_forward, 2, 8, 96, 128, 49, f32,
                'input width equal'),
            (lstm_enc._launch_forward, 2, 8, 128, 128, 200, f32,
                'at most 128 features'),
            (lstm_enc._launch_enc_forward, 2, 8, 128, 128, 200, bf16,
                'at most 128 features'),
            (lstm_enc._launch_enc_forward, 2, 8, 96, 128, 49, bf16,
                'input width equal')):
        args = _lstm_case('enc5', T, B, H, F, cdt, cuda, D=D)
        if launch is lstm_enc._launch_backward:
            z = torch.zeros(T, B, H, device=cuda, dtype=cdt)
            args = (*args, z, z, z, torch.zeros(B, H, device=cuda),
                torch.zeros(B, H, device=cuda))
        with pytest.raises(ValueError, match=message):
            launch(*args, cdt)
    assert _launches() == before


@pytest.mark.parametrize('T,B,D,H,F', [(16, 1000, 128, 128, 49),
    (5, 65, 32, 32, 49), (16, 1000, 96, 128, 200)])
def test_enc5_bf16_is_deterministic(cuda, T, B, D, H, F):
    """enc5's bf16 kernels add every partial sum in a fixed order (no
    atomics; db_enc as a row of the split-K contraction): the same inputs
    twice give the same outputs and gradients bit for bit."""
    _check_deterministic(cuda, 'enc5', T, B, H, D, F)


def test_tc_max_features_is_the_encoders_limit(cuda):
    """lstm_common.tc_max_features, which the checks before a launch use,
    copies lstm_tc.cuh's constants: it must equal the widest feature width
    the C side serves (lstm_enc_tc_max_features)."""
    import ctypes
    from pufferlib_tpu_torch.ops.cuda import lstm_common, lstm_enc
    out = (ctypes.c_int * 1)()
    assert lstm_enc.KERNEL.lib().lstm_enc_tc_max_features(out) == 0
    assert out[0] == lstm_common.tc_max_features()


# enc5's f32 pair (csrc/lstm_f32.cuh) over its reach: memory's CLI shape
# (T 8, B 512, F 1), the bench's and a ragged batch at H 128, H 64 and 32
# at both loop tilings, one row, the widest features (128), odd ones
ENC5_F32_SHAPES = [(8, 512, 128, 1), (16, 8192, 128, 49), (16, 1000, 128, 49),
    (16, 8192, 64, 49), (5, 65, 64, 49), (16, 8192, 32, 49), (5, 65, 32, 7),
    (3, 45, 128, 128), (1, 1, 128, 49), (4, 200, 32, 128)]


@pytest.mark.parametrize('T,B,H,F', ENC5_F32_SHAPES)
def test_enc5_f32_matches_plain(cuda, T, B, H, F):
    _check_lstm_pair(cuda, 'enc5', T, B, H, torch.float32, F=F)


@pytest.mark.parametrize('T,B,H,F', [(16, 8192, 128, 49), (8, 512, 128, 1),
    (16, 1000, 128, 49), (5, 65, 64, 49), (4, 200, 32, 128)])
def test_enc5_f32_repeats_bit_for_bit(cuda, T, B, H, F):
    """The f32 loops' cluster blocks exchange h and the partial dh_prev
    through distributed shared memory behind a cluster barrier each step;
    a block that read them before they were written would read stale
    values, and runs would differ by timing. The split-K adds its partials
    in split order, db its tiles' in tile order: twenty runs are equal bit
    for bit."""
    _check_deterministic(cuda, 'enc5', T, B, H, F=F, cdt=torch.float32,
        runs=20)


def _check_f32_guards(cuda, monkeypatch, kind, T, B, H, F=49, xp_dtype=None):
    """Every input, output and scratch buffer of one f32 forward and
    backward call of the resident pair `kind` (enc5, enc, cat, fused, the
    archived enc2, enc3, enc4 and enc6, scan and tm with x_proj in
    xp_dtype: the launchers of lstm_enc, lstm_cat, lstm_scan and the
    archive, their scratch through lstm_common) sits between guards; after
    both calls no guard has changed, and the results still match the plain
    versions within LSTM_TOL (a bf16 x_proj's)."""
    from pufferlib_tpu_torch.ops.cuda import (
        archive, lstm_cat, lstm_common, lstm_enc, lstm_scan)
    from pufferlib_tpu_torch.ops.cuda.archive import lstm_enc2, lstm_tm
    fwd, bwd, fwd_plain, bwd_plain, _ = _lstm_kinds()[kind]
    cdt = torch.float32
    guarded = _GuardedTorch()
    args = tuple(guarded.guarded(t.shape, t.dtype, t.device).copy_(t)
        for t in _lstm_case(kind, T, B, H, F, cdt, cuda, xp_dtype))
    g = tuple(guarded.guarded(t.shape, t.dtype, t.device).copy_(t) for t in (
        torch.randn(T, B, H, device=cuda), torch.randn(B, H, device=cuda),
        torch.randn(B, H, device=cuda)))
    with torch.no_grad():
        want = fwd_plain(*args, cdt)
        bargs = (*args, want[0], want[3], *g, cdt)
        want += bwd_plain(*bargs)
        for module in (lstm_common, lstm_enc, lstm_cat, lstm_scan, archive,
                lstm_enc2, lstm_tm):
            monkeypatch.setattr(module, 'torch', guarded)
        inputs = len(guarded.buffers)
        got = fwd(*args, cdt)
        got += bwd(*bargs)
    assert guarded.overwritten() == []
    # the launchers' outputs and scratch went through the guards too
    assert len(guarded.buffers) > inputs + len(got)
    tol = LSTM_TOL[xp_dtype or cdt]
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and a.shape == w.shape
        scale = max(1.0, w.float().abs().max().item())
        torch.testing.assert_close(a.float(), w.float(), rtol=0,
            atol=tol * scale)


@pytest.mark.parametrize('T,B,H,F', [(3, 45, 128, 5), (8, 512, 128, 1),
    (16, 1000, 64, 49), (4, 200, 32, 128), (3, 65, 128, 49)])
def test_enc5_f32_writes_only_its_buffers(cuda, monkeypatch, T, B, H, F):
    """Every buffer of an f32 enc5 call between guards (_check_f32_guards)
    at ragged batches (a last loop tile of 13, 8 or 1 rows), feature
    widths that are no multiple of 4 and the widest."""
    _check_f32_guards(cuda, monkeypatch, 'enc5', T, B, H, F)


def test_enc5_f32_plan_and_usage(cuda):
    """The f32 loops' tilings (lstm_enc.f32_plan): at H 128 memory's 512
    rows take the small one (32 units a block, 4 rows a thread: clusters
    of four blocks), the bench's 8192 the big one (64 units, 16 rows a
    thread: clusters of two); every tiling a hidden size takes has a
    cluster the card holds; every f32 kernel reports its registers
    (lstm_enc.f32_usage) without a launch."""
    from pufferlib_tpu_torch.ops.cuda import lstm_enc
    before = _launches()
    for H in (32, 64, 128):
        usage = lstm_enc.f32_usage(H)
        assert len(usage) == 10 and all(r > 0 for r, _ in usage.values())
        for B in (512, 1000, 8192):
            plan = lstm_enc.f32_plan(H, B)
            for part in ('forward', 'backward'):
                units, rt, clusters = plan[part]
                assert rt in (4, 16) and H % units == 0 and clusters > 0, (
                    H, B, part, plan)
                if H == 128 and B in (512, 8192):
                    assert (units, rt) == ((32, 4) if B == 512 else (64, 16))
    assert _launches() == before


# cat's f32 pair (csrc/lstm_f32.cuh, enc5's design without the encoder)
# over its reach: the bench's and a ragged batch at each hidden size, both
# loop tilings, a short last tile, one row, one step
CAT_F32_SHAPES = [(16, 8192, 128), (16, 1000, 128), (16, 8192, 64),
    (16, 1000, 64), (16, 8192, 32), (16, 1000, 32), (5, 65, 128), (3, 45, 32),
    (8, 512, 128), (1, 1, 64)]


@pytest.mark.parametrize('T,B,H', CAT_F32_SHAPES)
def test_cat_f32_matches_plain(cuda, T, B, H):
    _check_lstm_pair(cuda, 'cat', T, B, H, torch.float32)


@pytest.mark.parametrize('T,B,H', [(16, 8192, 128), (16, 1000, 128),
    (5, 65, 64), (4, 200, 32), (8, 512, 128)])
def test_cat_f32_repeats_bit_for_bit(cuda, T, B, H):
    """Cat's f32 loops exchange h and the partial dh_prev through
    distributed shared memory behind cluster barriers, the split-K and dx's
    split add their partials in split order, db its tiles' in tile order:
    twenty runs are equal bit for bit."""
    _check_deterministic(cuda, 'cat', T, B, H, cdt=torch.float32, runs=20)


@pytest.mark.parametrize('T,B,H', [(3, 45, 128), (8, 512, 128),
    (16, 1000, 64), (4, 200, 32), (3, 65, 128), (2, 8000, 128)])
def test_cat_f32_writes_only_its_buffers(cuda, monkeypatch, T, B, H):
    """Every buffer of an f32 cat call between guards (_check_f32_guards)
    at ragged batches (a last loop tile of 13, 8 or 1 rows), dx split over
    K (few row tiles) and whole."""
    _check_f32_guards(cuda, monkeypatch, 'cat', T, B, H)


def _check_autograd_keeps_the_slab(cuda, kind, T, B, H):
    """The f32 scan of `kind` (cat: lstm_scan_cat, fused: lstm_scan_fused)
    through autograd: one forward and one backward launch, the forward's
    slab kept for the backward, and the outputs and gradients equal to the
    launchers' called directly (the slab handed over by
    kept_for_backward) bit for bit; the backward launcher refuses a call
    without the slab before any launch."""
    from pufferlib_tpu_torch.ops.cuda import lstm_cat, lstm_scan
    scan, launch_backward, slab = {
        'cat': (lstm_cat.lstm_scan_cat, lstm_cat._launch_backward,
            'x @ W_ih slab'),
        'fused': (lstm_scan.lstm_scan_fused, lstm_scan._launch_fused_backward,
            r'x @ W_ih \+ b slab')}[kind]
    cdt = torch.float32
    fwd, bwd = _lstm_kinds()[kind][:2]
    fns = _lstm_kinds()[kind][4]
    args = _lstm_case(kind, T, B, H, 49, cdt, cuda)
    g = (torch.randn(T, B, H, device=cuda), torch.randn(B, H, device=cuda),
        torch.randn(B, H, device=cuda))
    with torch.no_grad():
        outs, hT, cT, cseq = fwd(*args, cdt)
        want = bwd(*args, outs, cseq, *g, cdt)
        before = _launches()
        with pytest.raises(ValueError, match=slab):
            launch_backward(*args, outs, cseq, *g, cdt)
        assert _launches() == before
    leaves = [t.clone().requires_grad_() for t in args]
    got = scan(*leaves, cdt)
    torch.autograd.backward(got, g)
    torch.cuda.synchronize()
    after = _launches()
    assert all(after[fn] == before[fn] + 1 for fn in fns)
    for a, w in zip(got, (outs, hT, cT)):
        assert torch.equal(a, w)
    for t, w in zip(leaves, want):
        assert torch.equal(t.grad, w)


@pytest.mark.parametrize('T,B,H', [(16, 1000, 128), (5, 65, 32)])
def test_cat_f32_autograd_keeps_the_slab(cuda, T, B, H):
    """lstm_scan_cat in f32 through autograd keeps its x @ W_ih slab
    (_check_autograd_keeps_the_slab)."""
    _check_autograd_keeps_the_slab(cuda, 'cat', T, B, H)


def test_cat_f32_plan_and_usage(cuda):
    """Cat's f32 loops take enc5's tilings (lstm_cat.f32_plan equal to
    lstm_enc.f32_plan at every shape: the same loops, built into another
    library); their smallest tile is 32 rows, so the db partials sized
    ceil(B / 32) hold every tile; every f32 kernel of cat's library
    reports its registers (lstm_cat.f32_usage) without a launch, those of
    the templates enc5's library builds too (all but cat's pre-pass, which
    continues the kept slab) as many as enc5's."""
    from pufferlib_tpu_torch.ops.cuda import lstm_cat, lstm_enc
    before = _launches()
    for H in (32, 64, 128):
        usage = lstm_cat.f32_usage(H)
        assert len(usage) == 8 and all(r > 0 for r, _ in usage.values())
        enc_usage = lstm_enc.f32_usage(H)
        for name in usage:
            if name != 'pre-pass':
                assert usage[name][0] == enc_usage[name][0], (H, name)
        for B in (1, 512, 1000, 8192):
            plan = lstm_cat.f32_plan(H, B)
            assert plan == lstm_enc.f32_plan(H, B), (H, B)
            for part in ('forward', 'backward'):
                units, rt, clusters = plan[part]
                rows = 256 // units * rt
                assert rows >= 32 and H % units == 0 and clusters > 0, (
                    H, B, part, plan)
    assert _launches() == before


# cat's f32 pair at hidden 256 (D = H; clusters of 8 blocks of 32 units, 9
# row groups: 36 rows a cluster): config.yaml's nethack, minihack and nmmo
# updates (B 512), nmmo3's (B 1024), a ragged batch whose last tile holds
# 28 rows (B 1000), one of 8 rows (B 1052), one row, one step
CAT_F32_H256_SHAPES = [(16, 512, 256), (16, 1000, 256), (16, 1024, 256),
    (16, 1052, 256), (1, 1, 256), (3, 45, 256)]


@pytest.mark.parametrize('T,B,H', CAT_F32_H256_SHAPES)
def test_cat_f32_h256_matches_plain(cuda, T, B, H):
    """Forward, dx and every other gradient of cat's f32 pair at H 256
    against lstm_cat_reference / lstm_cat_backward_reference within
    LSTM_TOL, one launch each way."""
    _check_lstm_pair(cuda, 'cat', T, B, H, torch.float32)


@pytest.mark.parametrize('T,B', [(16, 512), (16, 1000), (16, 1024)])
def test_cat_f32_h256_repeats_bit_for_bit(cuda, T, B):
    """At H 256 the loops' clusters are of 8 blocks: h goes to eight
    blocks a step and the partial dh_prev of eight ranks are added in rank
    order; twenty runs are equal bit for bit."""
    _check_deterministic(cuda, 'cat', T, B, 256, cdt=torch.float32,
        runs=20)


@pytest.mark.parametrize('T,B', [(16, 512), (16, 1000), (16, 1024),
    (3, 45)])
def test_cat_f32_h256_writes_only_its_buffers(cuda, monkeypatch, T, B):
    """Every buffer of an f32 cat call at H 256 between guards
    (_check_f32_guards), at whole tiles and ragged last tiles."""
    _check_f32_guards(cuda, monkeypatch, 'cat', T, B, 256)


def test_cat_f32_h256_autograd_keeps_the_slab(cuda):
    """lstm_scan_cat in f32 at H 256 through autograd keeps its x @ W_ih
    slab (_check_autograd_keeps_the_slab) and launches the resident
    pair."""
    _check_autograd_keeps_the_slab(cuda, 'cat', 16, 512, 256)


def test_cat_f32_h256_plan_and_usage(cuda):
    """At H 256 cat's f32 loops have one tiling: 32 units a block and 4
    rows a thread in clusters of 8 blocks, every cluster the card may hold
    at once (more than 0) at every batch, forward and backward; every f32
    kernel reports its registers and no spilled byte in the loops
    (lstm_cat.f32_usage, both tiling slots the one loop) without a
    launch. The other families are not built for H 256."""
    from pufferlib_tpu_torch.ops.cuda import lstm_cat, lstm_enc, lstm_scan
    before = _launches()
    usage = lstm_cat.f32_usage(256)
    assert len(usage) == 8 and all(r > 0 for r, _ in usage.values())
    for part in ('forward', 'backward'):
        big, small = (usage[f'{part} loop ({t})'] for t in ('big', 'small'))
        assert big == small and small[1] == 0, (part, usage)
    for B in (1, 512, 1000, 1024, 8192):
        plan = lstm_cat.f32_plan(256, B)
        for part in ('forward', 'backward'):
            units, rt, clusters = plan[part]
            assert (units, rt) == (32, 4) and clusters > 0, (B, part, plan)
    for fn in (lstm_enc.f32_plan, lstm_scan.f32_plan):
        with pytest.raises(RuntimeError, match='cudaError'):
            fn(256, 512)
    assert _launches() == before


# lstm_scan_fused's f32 pair (csrc/lstm_f32.cuh with two sums) over the
# reach of the FMA cell it replaced: cat's f32 shapes (both loop tilings of
# each hidden size, ragged batches, one row, one step)
@pytest.mark.parametrize('T,B,H', CAT_F32_SHAPES)
def test_fused_f32_matches_plain(cuda, T, B, H):
    _check_lstm_pair(cuda, 'fused', T, B, H, torch.float32)


@pytest.mark.parametrize('T,B,H', [(16, 8192, 128), (16, 1000, 128),
    (5, 65, 64), (4, 200, 32), (8, 512, 128)])
def test_fused_f32_repeats_bit_for_bit(cuda, T, B, H):
    """Fused's f32 loops exchange h and the partial dh_prev through
    distributed shared memory behind cluster barriers, the split-K and
    dx's split add their partials in split order, db its tiles' in tile
    order: twenty runs are equal bit for bit."""
    _check_deterministic(cuda, 'fused', T, B, H, cdt=torch.float32, runs=20)


@pytest.mark.parametrize('T,B,H', [(3, 45, 128), (8, 512, 128),
    (16, 1000, 64), (4, 200, 32), (3, 65, 128), (2, 8000, 128)])
def test_fused_f32_writes_only_its_buffers(cuda, monkeypatch, T, B, H):
    """Every buffer of an f32 fused call between guards
    (_check_f32_guards), at cat's shapes."""
    _check_f32_guards(cuda, monkeypatch, 'fused', T, B, H)


@pytest.mark.parametrize('T,B,H', [(16, 1000, 128), (5, 65, 32)])
def test_fused_f32_autograd_keeps_the_slab(cuda, T, B, H):
    """lstm_scan_fused in f32 through autograd keeps its x @ W_ih + b slab
    (_check_autograd_keeps_the_slab)."""
    _check_autograd_keeps_the_slab(cuda, 'fused', T, B, H)


def test_fused_f32_plan_and_usage(cuda):
    """Fused's f32 loops take cat's tilings (lstm_scan.f32_plan equal to
    lstm_cat.f32_plan at every shape: its forward loop differs only in
    where the slab is added, its backward loop is cat's); every f32 kernel
    of lstm_scan's library reports its registers (lstm_scan.f32_usage)
    without a launch, those built from the same templates as cat's (the
    backward loops, the projection, dx, dW) as many as cat's."""
    from pufferlib_tpu_torch.ops.cuda import lstm_cat, lstm_scan
    before = _launches()
    shared = ('backward loop (big)', 'backward loop (small)', 'projection',
        'dx', 'dW')
    for H in (32, 64, 128):
        usage = lstm_scan.f32_usage(H)
        assert len(usage) == 8 and all(r > 0 for r, _ in usage.values())
        cat_usage = lstm_cat.f32_usage(H)
        for name in shared:
            assert usage[name][0] == cat_usage[name][0], (H, name)
        for B in (1, 512, 1000, 8192):
            assert lstm_scan.f32_plan(H, B) == lstm_cat.f32_plan(H, B), (H, B)
    assert _launches() == before


@pytest.mark.parametrize('kind', ARCHIVED_ENC)
@pytest.mark.parametrize('T,B,H', [(16, 8192, 128), (16, 1000, 128),
    (3, 45, 32), (5, 980, 64)])
@pytest.mark.parametrize('cdt', [torch.float32, torch.bfloat16])
def test_archived_enc_kernels_match_plain(cuda, kind, T, B, H, cdt):
    """enc2, enc3, enc4 and enc6: forward, every gradient, and the
    forward handed a null cseq. B = 980 leaves a short last block of
    rows."""
    _check_pair_and_primal(cuda, kind, T, B, H, cdt)


# the archived backwards with a tensor-core design in bf16 (lstm_tc.cuh:
# mode ENC5's path with each variant's roundings; enc2's pre-pass rounds
# its projection): all four
ARCHIVED_TC = ARCHIVED_ENC


@pytest.mark.parametrize('kind', ARCHIVED_TC)
@pytest.mark.parametrize('H', [32, 64, 128])
@pytest.mark.parametrize('B', [65, 72])
def test_archived_tensor_core_backwards_match_plain_and_repeat(cuda, kind, H,
        B):
    """The archived bf16 backwards at every hidden size, at batches that
    leave a second 64-row block of one and of eight rows: within
    2e-2 of max(1, max |plain|) of the plain versions, and two runs equal
    bit for bit (db and every weight gradient summed in a fixed order)."""
    _check_lstm_pair(cuda, kind, 5, B, H, torch.bfloat16)
    _check_deterministic(cuda, kind, 5, B, H)


@pytest.mark.parametrize('kind', ('enc3', 'enc6'))
@pytest.mark.parametrize('H', [32, 64, 128])
@pytest.mark.parametrize('B', [8192, 1000, 980])
def test_enc3_enc6_bf16_backwards_match_plain(cuda, kind, H, B):
    """enc3's and enc6's bf16 backwards on the tensor cores at every
    hidden size, at the bench batch and at ragged ones (1000; 980): within
    2e-2 of max(1, max |plain|) of the plain versions, with one launch of
    each C function."""
    _check_lstm_pair(cuda, kind, 16, B, H, torch.bfloat16)


@pytest.mark.parametrize('H', [32, 64, 128])
@pytest.mark.parametrize('B', [8192, 980])
def test_enc6_bf16_gradients_are_enc5s(cuda, H, B):
    """enc6 is enc5's function and, in bf16, enc5's tensor-core backward
    (mode ENC6 runs ENC5's reverse loop): on the same inputs its forward
    and every gradient equal lstm_scan_enc5's bit for bit."""
    kinds = _lstm_kinds()
    args = _lstm_case('enc6', 16, B, H, 49, torch.bfloat16, cuda)
    g = (torch.randn(16, B, H, device=cuda).to(torch.bfloat16),
        torch.randn(B, H, device=cuda), torch.randn(B, H, device=cuda))
    runs = []
    with torch.no_grad():
        for kind in ('enc5', 'enc6'):
            fwd, bwd = kinds[kind][:2]
            outs, hT, cT, cseq = fwd(*args, torch.bfloat16)
            runs.append((outs, hT, cT, cseq) + bwd(*args, outs, cseq, *g,
                torch.bfloat16))
    torch.cuda.synchronize()
    for a, w in zip(*runs):
        assert torch.equal(a, w)


@pytest.mark.parametrize('kind', ARCHIVED_TC)
def test_archived_bf16_backwards_run_the_tensor_core_path(cuda, kind):
    """In bf16 the C function runs lstm_tc.cuh's path, which needs its
    scratch (the P slab, the bf16 weights): handed none, it refuses. In
    f32 all four run lstm_f32.cuh (archive.design 'cluster'), which needs
    its work slab in the P slab's place, refuses without it, and takes the
    phases. The launcher's phases 1 .. 3 stop the bf16 path early without
    an error."""
    from pufferlib_tpu_torch.ops.cuda import archive
    fwd, bwd = _lstm_kinds()[kind][:2]
    fn = f'lstm_{kind}_backward'
    T, B, H, F = 3, 70, 64, 49
    for cdt in (torch.bfloat16, torch.float32):
        args = _lstm_case(kind, T, B, H, F, cdt, cuda)
        with torch.no_grad():
            outs, _, _, cseq = fwd(*args, cdt)
        g = (torch.zeros(T, B, H, device=cuda, dtype=cdt),
            torch.zeros(B, H, device=cuda), torch.zeros(B, H, device=cuda))
        real = archive.KERNEL.lib()
        seen = []

        class NoScratch:
            """The library, with null tensor-core scratch in fn's calls."""

            def __getattr__(self, name):
                f = getattr(real, name)
                if name != fn:
                    return f

                def call(*a):
                    a = list(a)
                    seen.append(a[25] is not None)
                    a[25] = a[26] = None
                    return f(*a)
                return call
        assert archive.design(fn, cdt) == ('tc' if cdt == torch.bfloat16
            else 'cluster')
        archive.KERNEL._lib = NoScratch()
        try:
            with pytest.raises(RuntimeError):
                bwd(*args, outs, cseq, *g, cdt)
        finally:
            archive.KERNEL._lib = real
        if cdt == torch.float32:
            bwd(*args, outs, cseq, *g, cdt)
            bwd(*args, outs, cseq, *g, cdt, phases=2)
        assert seen[0]
    args = _lstm_case(kind, T, B, H, F, torch.bfloat16, cuda)
    with torch.no_grad():
        outs, _, _, cseq = fwd(*args, torch.bfloat16)
        for phases in (1, 2, 3):
            bwd(*args, outs, cseq, *(torch.zeros_like(t) for t in (outs,
                args[1], args[2])), torch.bfloat16, phases=phases)
    torch.cuda.synchronize()


@pytest.mark.parametrize('B', [8192, 1000])
def test_enc2_f32_backward_on_the_cluster_design(cuda, monkeypatch, B):
    """The archived enc2's f32 backward runs csrc/lstm_f32.cuh (enc5's f32
    backward with lstm_scan_fused's two sums; its projection slab held in
    the dgates scratch until the loop writes over it): at the bench's
    batch and a ragged one, within LSTM_TOL of the plain version with
    every buffer between guards, and five runs equal bit for bit."""
    from pufferlib_tpu_torch.ops.cuda import archive
    assert archive.design('lstm_enc2_backward', torch.float32) == 'cluster'
    _check_f32_guards(cuda, monkeypatch, 'enc2', 16, B, 128)
    _check_deterministic(cuda, 'enc2', 16, B, 128, cdt=torch.float32, runs=5)


@pytest.mark.parametrize('B', [8192, 1000])
@pytest.mark.parametrize('H', [32, 64, 128])
def test_enc2_f32_forward_on_the_cluster_design(cuda, monkeypatch, B, H):
    """The archived enc2's f32 forward runs csrc/lstm_f32.cuh (enc5's f32
    forward with lstm_scan_fused's two sums: the encoder and x @ W_ih + b
    as SGEMMs into f32 scratch, then fused's cluster loop): at the bench's
    batch and a ragged one, at every hidden size (both loop tilings),
    within LSTM_TOL of the plain version with every buffer between guards,
    five runs equal bit for bit, a call without a cell sequence writing
    none and giving the same outputs, and phases 1 (the encoder and the
    projection) and 2 running without a fault."""
    from pufferlib_tpu_torch.ops.cuda import archive
    assert archive.design('lstm_enc2_forward', torch.float32) == 'cluster'
    _check_f32_guards(cuda, monkeypatch, 'enc2', 16, B, H)
    _check_deterministic(cuda, 'enc2', 16, B, H, cdt=torch.float32, runs=5)
    fwd = _lstm_kinds()['enc2'][0]
    args = _lstm_case('enc2', 16, B, H, 49, torch.float32, cuda)
    with torch.no_grad():
        whole = fwd(*args, torch.float32)
        alone = fwd(*args, torch.float32, save_cseq=False)
        for phases in (1, 2):
            fwd(*args, torch.float32, phases=phases)
    torch.cuda.synchronize()
    assert alone[3] is None and whole[3] is not None
    for a, w in zip(alone[:3], whole[:3]):
        assert torch.equal(a, w)


def _check_f32_backward_is_enc5s(cuda, monkeypatch, kind, B):
    """`kind`'s f32 backward, which runs csrc/lstm_f32.cuh's enc5 backward
    with enc5's one sum: at T 16, H 128 and batch B, within LSTM_TOL of its
    plain versions with every buffer between guards (_check_f32_guards),
    two runs equal bit for bit, the seven gradients equal bit for bit to
    row 4's f32 backward (lstm_enc_backward) on the same inputs, and
    phases 1 .. 3 stopping early without a fault."""
    _check_f32_guards(cuda, monkeypatch, kind, 16, B, 128)
    _check_deterministic(cuda, kind, 16, B, 128, cdt=torch.float32)
    kinds = _lstm_kinds()
    args = _lstm_case(kind, 16, B, 128, 49, torch.float32, cuda)
    g = (torch.randn(16, B, 128, device=cuda), torch.randn(B, 128,
        device=cuda), torch.randn(B, 128, device=cuda))
    with torch.no_grad():
        outs, _, _, cseq = kinds['enc5'][0](*args, torch.float32)
        bargs = (*args, outs, cseq, *g, torch.float32)
        want = kinds['enc5'][1](*bargs)
        got = kinds[kind][1](*bargs)
        for phases in (1, 2, 3):
            kinds[kind][1](*bargs, phases=phases)
    torch.cuda.synchronize()
    assert len(got) == len(want) == 7
    for a, w in zip(got, want):
        assert torch.equal(a, w)


@pytest.mark.parametrize('kind', ['enc4', 'enc6'])
@pytest.mark.parametrize('B', [8192, 1000])
def test_enc4_enc6_f32_backwards_are_enc5s(cuda, monkeypatch, kind, B):
    """The archived enc4's and enc6's f32 backwards run enc5's
    (archive.design 'cluster'), their function being enc5's in f32, at
    the bench's batch and a ragged one (_check_f32_backward_is_enc5s)."""
    from pufferlib_tpu_torch.ops.cuda import archive
    assert archive.design(f'lstm_{kind}_backward', torch.float32) == 'cluster'
    _check_f32_backward_is_enc5s(cuda, monkeypatch, kind, B)


@pytest.mark.parametrize('kind', ['enc', 'enc3'])
@pytest.mark.parametrize('B', [8192, 1000, 980])
def test_enc_enc3_f32_backwards_are_enc5s(cuda, monkeypatch, kind, B):
    """lstm_scan_enc's step backward (lstm_enc.design) and the archived
    enc3's (archive.design) run enc5's f32 backward ('cluster'), their
    functions being enc5's in f32, at the bench's batch and ragged ones
    (_check_f32_backward_is_enc5s)."""
    from pufferlib_tpu_torch.ops.cuda import archive, lstm_enc
    design = lstm_enc.design('lstm_enc_step_backward', torch.float32) \
        if kind == 'enc' else archive.design('lstm_enc3_backward',
            torch.float32)
    assert design == 'cluster'
    _check_f32_backward_is_enc5s(cuda, monkeypatch, kind, B)


@pytest.mark.parametrize('kind', ['enc', 'enc3', 'enc4', 'enc6'])
@pytest.mark.parametrize('T,B,F,H', [(3, 45, 128, 32), (5, 980, 49, 64),
    (2, 64, 128, 128), (3, 65, 108, 128)])
def test_enc4_enc6_f32_take_every_fma_shape(cuda, monkeypatch, kind, T, B, F,
        H):
    """Where the f32 FMA kernels served them (D == H, F <= 128),
    lstm_scan_enc's step backward and the archived enc3's, enc4's and
    enc6's f32 backwards still run, now on lstm_f32.cuh: the widest
    feature width at every hidden size (enc6's two-tile FMA block took at
    most 107 features at hidden size 128), with every buffer between
    guards and the results within LSTM_TOL of the plain versions."""
    _check_f32_guards(cuda, monkeypatch, kind, T, B, H, F=F)


@pytest.mark.parametrize('kind', ARCHIVED_TC)
@pytest.mark.parametrize('T,B,F,H', [(3, 45, 7, 32), (4, 200, 49, 64),
    (16, 1000, 49, 128), (2, 64, 128, 128)])
@pytest.mark.parametrize('cdt', [torch.float32, torch.bfloat16])
def test_archived_tc_backwards_write_only_their_buffers(cuda, monkeypatch,
        kind, T, B, F, H, cdt):
    """Every input, output and scratch buffer of the archived forward and
    backward (the P slab, the bf16 weights, db_part at 64 rows a block;
    in f32 lstm_f32.cuh's work slab)
    sits between guards; after both calls no guard has changed, at a
    ragged last block (45, 200 and 1000 rows), at the widest feature width
    the archive takes, and the results still match the plain versions
    within LSTM_TOL."""
    from pufferlib_tpu_torch.ops.cuda import archive, lstm_common, lstm_enc
    fwd, bwd, fwd_plain, bwd_plain, _ = _lstm_kinds()[kind]
    guarded = _GuardedTorch()
    args = tuple(guarded.guarded(t.shape, t.dtype, t.device).copy_(t)
        for t in _lstm_case(kind, T, B, H, F, cdt, cuda))
    g = tuple(guarded.guarded(t.shape, t.dtype, t.device).copy_(t) for t in (
        torch.randn(T, B, H, device=cuda).to(cdt),
        torch.randn(B, H, device=cuda), torch.randn(B, H, device=cuda)))
    with torch.no_grad():
        want = fwd_plain(*args, cdt)
        bargs = (*args, want[0], want[3], *g, cdt)
        want += bwd_plain(*bargs)
        for module in (archive, lstm_common, lstm_enc):
            monkeypatch.setattr(module, 'torch', guarded)
        inputs = len(guarded.buffers)
        got = fwd(*args, cdt)
        got += bwd(*bargs)
    assert guarded.overwritten() == []
    assert len(guarded.buffers) > inputs + len(got)
    for a, w in zip(got, want):
        scale = max(1.0, w.float().abs().max().item())
        torch.testing.assert_close(a.float(), w.float(), rtol=0,
            atol=LSTM_TOL[cdt] * scale)


def test_archive_tc_usage(cuda):
    """Registers and spills of the archive's own bf16 kernels (enc2's
    pre-pass, whose epilogue rounds the projection, the reverse loop of
    enc2 and enc4, ENC5's with f32 activations, and enc3's, ENC5's with db
    from the unrounded dgates; enc2's forward projection GEMM and its
    forward loop, mode XP's on bf16 x_proj) at every hidden size: the
    loops' 512 threads may hold 128 registers each (one block an SM), the
    GEMMs' 256 threads 128 (two blocks an SM). The reverse loops and the
    projection GEMM spill nothing, the pre-pass at most the 16 bytes that
    enc5's backward pre-pass spills (as on the H100 when this test was
    written), the forward loop at most what lstm_scan's spills
    (test_lstm_scan_tc_usage)."""
    import ctypes
    from pufferlib_tpu_torch.ops.cuda import archive
    for H in (32, 64, 128):
        out = (ctypes.c_int * 10)()
        assert archive.KERNEL.lib().lstm_archive_tc_usage(H, out) == 0
        regs, spilled = list(out)[::2], list(out)[1::2]
        assert all(0 < r <= 128 for r in regs), (H, regs)
        assert spilled[0] <= 16 and spilled[1:4] == [0, 0, 0], (H, spilled)
        assert spilled[4] <= (8 if H == 128 else 0), (H, spilled)


def test_enc_tc_usage(cuda):
    """Registers and spills of lstm_enc.cu's bf16 kernels: enc5's six
    (the encoder, both pre-passes, both loops, dpre), then the reverse
    loop of lstm_scan_enc's step backward (mode ENC: f32 activations, db
    from the unrounded dgates; CAT's and FUSED's loop) at every hidden
    size, within the launch bounds' 128 registers; that loop spills
    nothing, as the archived enc3's and enc4's do not."""
    import ctypes
    from pufferlib_tpu_torch.ops.cuda import lstm_enc
    for H in (32, 64, 128):
        out = (ctypes.c_int * 14)()
        assert lstm_enc.KERNEL.lib().lstm_enc_tc_usage(H, out) == 0
        regs, spilled = list(out)[::2], list(out)[1::2]
        assert all(0 < r <= 128 for r in regs), (H, regs)
        assert spilled[6] == 0, (H, spilled)


@pytest.mark.parametrize('kind', ['enc', 'enc2'])
@pytest.mark.parametrize('T,B,D,H,F', [(16, 8192, 96, 128, 200),
    (16, 1000, 96, 128, 200), (5, 65, 40, 32, 49), (3, 100, 200, 64, 768),
    (2, 64, 640, 128, 49), (8, 512, 128, 128, 1)])
def test_enc_and_enc2_tensor_core_kernels_take_other_widths(cuda, kind, T,
        B, D, H, F):
    """lstm_scan_enc's and the archived enc2's bf16 kernels at enc5's
    reach (encoder widths D != H up to 640 at H = 128, feature widths past
    the FMA kernels' 128, one feature) against the plain versions, and
    twice bit for bit."""
    _check_lstm_pair(cuda, kind, T, B, H, torch.bfloat16, D=D, F=F)
    _check_deterministic(cuda, kind, T, B, H, D=D, F=F)


def test_enc_step_backward_and_enc2_forward_run_the_tensor_core_path(cuda):
    """In bf16 lstm_enc_step_backward and lstm_enc2_forward run
    lstm_tc.cuh's path, which needs its scratch (the backward's P slab and
    bf16 weights; the forward's encoded inputs, projection and bf16
    weights): handed none, they refuse. The bf16 launchers' phases stop
    early without an error; so do the step backward's and enc2's forward's
    in f32, where they run enc5's f32 backward and enc5's f32 forward with
    two sums."""
    from pufferlib_tpu_torch.ops.cuda import archive, lstm_enc
    T, B, H, F = 3, 70, 64, 49
    for kind, kernel, fn, nulls in (
            ('enc', lstm_enc.KERNEL, 'lstm_enc_step_backward', (25, 26)),
            ('enc2', archive.KERNEL, 'lstm_enc2_forward', (12, 13, 14))):
        fwd, bwd = _lstm_kinds()[kind][:2]
        args = _lstm_case(kind, T, B, H, F, torch.bfloat16, cuda)
        g = (torch.zeros(T, B, H, device=cuda, dtype=torch.bfloat16),
            torch.zeros(B, H, device=cuda), torch.zeros(B, H, device=cuda))
        with torch.no_grad():
            outs, _, _, cseq = fwd(*args, torch.bfloat16)
        real = kernel.lib()

        class NoScratch:
            """The library, with null tensor-core scratch in fn's calls."""

            def __getattr__(self, name):
                f = getattr(real, name)
                if name != fn:
                    return f

                def call(*a):
                    a = list(a)
                    for i in nulls:
                        a[i] = None
                    return f(*a)
                return call
        kernel._lib = NoScratch()
        try:
            with pytest.raises(RuntimeError), torch.no_grad():
                if kind == 'enc':
                    bwd(*args, outs, cseq, *g, torch.bfloat16)
                else:
                    fwd(*args, torch.bfloat16)
        finally:
            kernel._lib = real
        with torch.no_grad():
            if kind == 'enc':
                for phases in (1, 2, 3):
                    bwd(*args, outs, cseq, *g, torch.bfloat16, phases=phases)
            else:
                fwd(*args, torch.bfloat16, phases=1)
        f32 = _lstm_case(kind, T, B, H, F, torch.float32, cuda)
        with torch.no_grad():
            outs, _, _, cseq = fwd(*f32, torch.float32)
            if kind == 'enc':
                for phases in (1, 2, 3):
                    bwd(*f32, outs, cseq, *(t.float() for t in g),
                        torch.float32, phases=phases)
            else:
                fwd(*f32, torch.float32, phases=1)
    torch.cuda.synchronize()


@pytest.mark.parametrize('T,B,H', [(16, 8192, 128), (16, 1000, 128),
    (3, 45, 32), (5, 100, 64), (1, 33, 32)])
@pytest.mark.parametrize('cdt,xp_dtype', [(torch.float32, None),
    (torch.bfloat16, None), (torch.bfloat16, torch.float32),
    (torch.float32, torch.bfloat16)])
def test_archived_tm_kernels_match_plain(cuda, T, B, H, cdt, xp_dtype):
    """The time-major scan, T launches of the step kernel each way
    (counted in _check_lstm_pair), x_proj in the compute dtype and in the
    other one."""
    _check_lstm_pair(cuda, 'tm', T, B, H, cdt, xp_dtype)


# tm's bf16 kernels against lstm_scan's: the bench shape, a ragged batch,
# another hidden size, and one step of one row past a 32-row half block
TM_SCAN_SHAPES = [(16, 8192, 128), (16, 1000, 128), (5, 100, 64), (1, 33, 32)]


@pytest.mark.parametrize('T,B,H', TM_SCAN_SHAPES)
@pytest.mark.parametrize('xp_dtype', [torch.bfloat16, torch.float32])
def test_archived_tm_bf16_is_lstm_scan_bit_for_bit(cuda, T, B, H, xp_dtype):
    """tm's bf16 kernels (mode XP's loops one step a launch, the carries
    in f32 buffers between launches, dW_hh on the ring split-K after step
    0) on lstm_scan's inputs: every output and gradient equal to
    lstm_scan's bf16 kernels' bit for bit, x_proj in bf16 and in f32. The
    carries are the values lstm_scan's loops keep in registers and every
    sum runs in the same order, so nothing may differ."""
    kinds = _lstm_kinds()
    cdt = torch.bfloat16
    args = _lstm_case('tm', T, B, H, 49, cdt, cuda, xp_dtype)
    g = (torch.randn(T, B, H, device=cuda).to(cdt),
        torch.randn(B, H, device=cuda), torch.randn(B, H, device=cuda))
    runs = []
    with torch.no_grad():
        for kind in ('scan', 'tm'):
            fwd, bwd = kinds[kind][:2]
            outs, hT, cT, cseq = fwd(*args, cdt)
            runs.append((outs, hT, cT, cseq) + bwd(*args, outs, cseq, *g,
                cdt))
    torch.cuda.synchronize()
    for a, w in zip(*runs):
        assert a.dtype == w.dtype and torch.equal(a, w)


@pytest.mark.parametrize('T,B,H', [(16, 8192, 128), (16, 1000, 128),
    (5, 65, 32)])
def test_archived_tm_bf16_is_deterministic(cuda, T, B, H):
    """tm's bf16 kernels add every partial sum in a fixed order (no
    atomics): the same inputs twice give the same outputs and gradients
    bit for bit."""
    _check_deterministic(cuda, 'tm', T, B, H)


def test_archived_tm_runs_the_tensor_core_path_in_bf16(cuda):
    """archive.design and F32_FUNCTIONS name tm's step kernels in bf16
    ('tc'; in f32 both 'cluster': lstm_scan's f32 forward and backward one
    step a launch). The bf16 C functions need
    their scratch (W_hh, and in the backward h0, rounded to bf16), the f32
    backward its W_hh^T: handed none, they refuse before any launch; the
    f32 forward refuses scratch it does not use. The backward's phases 1
    leaves dW_hh out in both dtypes."""
    from pufferlib_tpu_torch.ops.cuda import archive
    fwd, bwd = _lstm_kinds()['tm'][:2]
    T, B, H = 3, 70, 64
    scratch = {'lstm_tm_step_forward': 8, 'lstm_tm_step_backward': 15}
    for cdt in (torch.bfloat16, torch.float32):
        bf16 = cdt == torch.bfloat16
        assert archive.design('lstm_tm_step_forward', cdt) == (
            'tc' if bf16 else 'cluster')
        assert archive.design('lstm_tm_step_backward', cdt) == (
            'tc' if bf16 else 'cluster')
        assert set(scratch) <= set(archive.F32_FUNCTIONS)
        args = _lstm_case('tm', T, B, H, 49, cdt, cuda)
        with torch.no_grad():
            outs, _, _, cseq = fwd(*args, cdt)
        g = (torch.zeros(T, B, H, device=cuda, dtype=cdt),
            torch.zeros(B, H, device=cuda), torch.zeros(B, H, device=cuda))
        real = archive.KERNEL.lib()
        spare = torch.empty(H * 4 * H + B * H, dtype=torch.bfloat16,
            device=cuda)

        class Swapped:
            """The library, with the scratch of tm's calls swapped: null
            where the call needs one, a spare buffer for the f32 forward,
            which needs none."""

            def __getattr__(self, name):
                f = getattr(real, name)
                if name not in scratch:
                    return f
                uses = bf16 or name == 'lstm_tm_step_backward'

                def call(*a):
                    a = list(a)
                    i = scratch[name]
                    assert (a[i] is not None) == uses
                    a[i] = None if uses else spare.data_ptr()
                    return f(*a)
                return call
        before = _launches()
        archive.KERNEL._lib = Swapped()
        try:
            with pytest.raises(RuntimeError, match='lstm_tm_step_forward'):
                fwd(*args, cdt)
            with pytest.raises(RuntimeError, match='lstm_tm_step_backward'):
                bwd(*args, outs, cseq, *g, cdt)
        finally:
            archive.KERNEL._lib = real
        assert _launches() == before
        with torch.no_grad():
            bwd(*args, outs, cseq, *g, cdt, phases=1)
    torch.cuda.synchronize()


def test_archived_tm_tc_usage(cuda):
    """Registers and spills of tm's bf16 kernels (lstm_tm_tc_usage: mode
    XP's forward and reverse loops with bf16 and f32 x_proj, and the ring
    split-K), built into the archive's library from lstm_scan's
    templates: equal to lstm_scan_tc_usage's at every hidden size."""
    import ctypes
    from pufferlib_tpu_torch.ops.cuda import archive, lstm_scan
    for H in (32, 64, 128):
        tm = (ctypes.c_int * 10)()
        scan = (ctypes.c_int * 10)()
        assert archive.KERNEL.lib().lstm_tm_tc_usage(H, tm) == 0
        assert lstm_scan.KERNEL.lib().lstm_scan_tc_usage(H, scan) == 0
        assert list(tm) == list(scan), (H, list(tm), list(scan))


# mode XP's f32 backward (csrc/lstm_f32.cuh): lstm_scan's, and the
# archived tm's one step a launch, at each hidden size and both loop
# tilings: a ragged batch, a short last tile, one row; and the bench shape
XP_F32_SHAPES = [(T, B, H) for H in (32, 64, 128)
    for T, B in ((16, 1000), (5, 33), (3, 1))] + [(16, 8192, 128)]


@pytest.mark.parametrize('kind', XP_KINDS)
@pytest.mark.parametrize('T,B,H', XP_F32_SHAPES)
@pytest.mark.parametrize('xp_dtype', [torch.float32, torch.bfloat16])
def test_xp_f32_backward_matches_plain(cuda, kind, T, B, H, xp_dtype):
    """lstm_scan's and tm's f32 backwards on the cluster design (tm: T
    launches of its step backward, counted in _check_lstm_pair) against
    their plain versions, x_proj in f32 and in bf16 (dx_proj in x_proj's
    dtype)."""
    from pufferlib_tpu_torch.ops.cuda import archive, lstm_scan
    assert lstm_scan.design('lstm_scan_backward', torch.float32) == \
        archive.design('lstm_tm_step_backward', torch.float32) == 'cluster'
    _check_lstm_pair(cuda, kind, T, B, H, torch.float32, xp_dtype)


@pytest.mark.parametrize('kind', XP_KINDS)
@pytest.mark.parametrize('T,B,H', [(3, 45, 128), (5, 33, 32), (4, 200, 64),
    (2, 1, 128)])
@pytest.mark.parametrize('xp_dtype', [torch.float32, torch.bfloat16])
def test_xp_f32_backward_writes_only_its_buffers(cuda, monkeypatch, kind, T,
        B, H, xp_dtype):
    """Every buffer of an f32 call of lstm_scan or tm between guards
    (_check_f32_guards): x_proj, dx_proj, the dgates scratch that holds
    the activations with bf16 x_proj, W_hh^T and the split-K's partials,
    at ragged batches and one row."""
    _check_f32_guards(cuda, monkeypatch, kind, T, B, H, xp_dtype=xp_dtype)


@pytest.mark.parametrize('kind', XP_KINDS)
@pytest.mark.parametrize('T,B,H,xp_dtype', [(16, 8192, 128, torch.float32),
    (16, 1000, 128, torch.bfloat16), (5, 65, 64, torch.float32),
    (4, 33, 32, torch.bfloat16)])
def test_xp_f32_backward_repeats_bit_for_bit(cuda, kind, T, B, H, xp_dtype):
    """The reverse loop's clusters exchange the partial dh_prev through
    distributed shared memory behind cluster barriers, the loop writes the
    dgates over the activations it reads, and the split-K adds its
    partials in split order: twenty runs are equal bit for bit."""
    _check_deterministic(cuda, kind, T, B, H, cdt=torch.float32, runs=20,
        xp_dtype=xp_dtype)


@pytest.mark.parametrize('T,B,H', TM_SCAN_SHAPES)
@pytest.mark.parametrize('xp_dtype', [torch.bfloat16, torch.float32])
def test_archived_tm_f32_is_lstm_scan_bit_for_bit(cuda, T, B, H, xp_dtype):
    """tm's f32 kernels (lstm_scan's f32 forward, the cluster loop, one
    step a launch, the h/c carries in f32 buffers; lstm_scan's f32
    backward one step a launch, the pre-pass with the first step and dW_hh
    with the last, the dh/dc carries in f32 buffers) on lstm_scan's
    inputs: every output and gradient equal to lstm_scan's f32 kernels'
    bit for bit, x_proj in f32 and in bf16."""
    kinds = _lstm_kinds()
    cdt = torch.float32
    args = _lstm_case('tm', T, B, H, 49, cdt, cuda, xp_dtype)
    g = (torch.randn(T, B, H, device=cuda), torch.randn(B, H, device=cuda),
        torch.randn(B, H, device=cuda))
    runs = []
    with torch.no_grad():
        for kind in ('scan', 'tm'):
            fwd, bwd = kinds[kind][:2]
            outs, hT, cT, cseq = fwd(*args, cdt)
            runs.append((outs, hT, cT, cseq) + bwd(*args, outs, cseq, *g,
                cdt))
    torch.cuda.synchronize()
    for a, w in zip(*runs):
        assert a.dtype == w.dtype and torch.equal(a, w)


# mode XP's f32 forward (csrc/lstm_f32.cuh xp_forward): lstm_scan's, and
# the archived tm's one step a launch, at each hidden size and both loop
# tilings: the bench's batch, a ragged one, a short last tile, one row
XP_F32_FORWARD_SHAPES = [(T, B, H) for H in (32, 64, 128)
    for T, B in ((16, 8192), (16, 1000), (5, 33), (3, 1))]


@pytest.mark.parametrize('kind', XP_KINDS)
@pytest.mark.parametrize('T,B,H', XP_F32_FORWARD_SHAPES)
@pytest.mark.parametrize('xp_dtype', [torch.float32, torch.bfloat16])
def test_xp_f32_forward_matches_plain(cuda, kind, T, B, H, xp_dtype):
    """lstm_scan's and tm's f32 forwards on the cluster design against
    their plain versions (outs, hT, cT, cseq within LSTM_TOL of f32: the
    same products summed in another order), x_proj in f32 and in bf16,
    one launch a call (tm: T); lstm_scan's forward handed no cseq
    (save_cseq off) gives the same outs, hT and cT bit for bit."""
    from pufferlib_tpu_torch.ops.cuda import archive, lstm_scan
    assert lstm_scan.design('lstm_scan_forward', torch.float32) == \
        archive.design('lstm_tm_step_forward', torch.float32) == 'cluster'
    fwd, _, fwd_plain, _, fns = _lstm_kinds()[kind]
    cdt = torch.float32
    args = _lstm_case(kind, T, B, H, 49, cdt, cuda, xp_dtype)
    before = _launches()
    with torch.no_grad():
        got = fwd(*args, cdt)
        want = fwd_plain(*args, cdt)
    torch.cuda.synchronize()
    after = _launches()
    assert all(after[fn] == n + (fn == fns[0]) * _steps(kind, T)
        for fn, n in before.items())
    for a, w in zip(got, want):
        assert a.dtype == w.dtype == cdt and a.shape == w.shape
        scale = max(1.0, w.abs().max().item())
        torch.testing.assert_close(a, w, rtol=0,
            atol=LSTM_TOL[cdt] * scale)
    if kind == 'scan':
        with torch.no_grad():
            primal = fwd(*args, cdt, False)
        torch.cuda.synchronize()
        assert primal[3] is None
        for a, w in zip(primal[:3], got[:3]):
            assert torch.equal(a, w)


@pytest.mark.parametrize('kind', XP_KINDS)
@pytest.mark.parametrize('T,B,H', [(16, 1000, 128), (5, 33, 64), (3, 1, 32),
    (2, 8192, 128)])
@pytest.mark.parametrize('xp_dtype', [torch.float32, torch.bfloat16])
def test_xp_f32_forward_writes_only_its_buffers(cuda, monkeypatch, kind, T,
        B, H, xp_dtype):
    """Every buffer of an f32 call of lstm_scan or tm between guards
    (_check_f32_guards): x_proj, outs, cseq, hT, cT (tm: its two carry
    pairs) and the backward's, at ragged batches, one row and the bench's
    batch."""
    _check_f32_guards(cuda, monkeypatch, kind, T, B, H, xp_dtype=xp_dtype)


@pytest.mark.parametrize('kind', XP_KINDS)
@pytest.mark.parametrize('T,B,H,xp_dtype', [(16, 8192, 128, torch.float32),
    (16, 8192, 128, torch.bfloat16), (16, 1000, 128, torch.float32),
    (16, 1000, 64, torch.bfloat16), (5, 65, 32, torch.float32)])
def test_xp_f32_forward_repeats_bit_for_bit(cuda, kind, T, B, H, xp_dtype):
    """The forward loop's clusters exchange h through distributed shared
    memory behind a cluster barrier each step (tm: one step a launch, the
    carries in device buffers): twenty forwards on the same inputs are
    equal bit for bit."""
    fwd = _lstm_kinds()[kind][0]
    cdt = torch.float32
    args = _lstm_case(kind, T, B, H, 49, cdt, cuda, xp_dtype)
    with torch.no_grad():
        runs = [fwd(*args, cdt) for _ in range(20)]
    torch.cuda.synchronize()
    for later in runs[1:]:
        for a, w in zip(later, runs[0]):
            assert torch.equal(a, w)


def _check_pair_and_primal(cuda, kind, T, B, H, cdt):
    fwd = _lstm_kinds()[kind][0]
    args, got = _check_lstm_pair(cuda, kind, T, B, H, cdt)
    with torch.no_grad():
        primal = fwd(*args, cdt, False)
    torch.cuda.synchronize()
    assert primal[3] is None
    for a, w in zip(primal[:3], got[:3]):
        assert torch.equal(a, w)


@pytest.mark.parametrize('T,B,H', [(5, 1000, 128), (5, 45, 32)]
    + FUSED_EDGES)
@pytest.mark.parametrize('cdt,xp_dtype', [(torch.bfloat16, torch.float32),
    (torch.float32, torch.bfloat16)])
def test_lstm_scan_x_proj_dtype_apart_from_compute_dtype(cuda, T, B, H, cdt,
        xp_dtype):
    """x_proj in one dtype under the other compute dtype; dx_proj comes
    back in x_proj's (checked with the dtypes in _check_lstm_pair). The
    bf16 kernels (f32 x_proj: the loops read it as pairs of f32, the
    backward writes dx_proj in f32 beside the rounded dgates slab) also at
    one step, one row, and one row past a 64-row block."""
    _check_lstm_pair(cuda, 'scan', T, B, H, cdt, xp_dtype)


@pytest.mark.parametrize('T,B,H', [(16, 1000, 128), (5, 65, 32),
    (16, 8192, 128)])
def test_lstm_scan_bf16_is_deterministic(cuda, T, B, H):
    """lstm_scan's bf16 kernels (mode XP, the ring split-K of dW_hh) add
    every partial sum in a fixed order: the same inputs twice give the
    same outputs and gradients bit for bit."""
    _check_deterministic(cuda, 'scan', T, B, H)


# every kind whose bf16 backward runs the split-K of lstm_common.cuh: the
# ring where its sources are bf16 rows (cat, fused, scan, tm, enc5's [x |
# h_prev], the FMA backwards' [xs | h_prev]), the register-staged kernel
# for the rest (enc5's [feats | 1], the feature rows of odd width)
SPLITK_KINDS = ('enc5', 'enc', 'cat', 'fused', 'scan', 'tm') + ARCHIVED_ENC


@pytest.mark.parametrize('kind', SPLITK_KINDS)
@pytest.mark.parametrize('T,B,H', [(16, 8192, 128), (5, 65, 64)])
def test_bf16_backwards_on_the_split_k_match_plain_and_repeat(cuda, kind, T,
        B, H):
    """Each bf16 backward whose weight gradients run the split-K: within
    2e-2 of its plain version, and two runs equal bit for bit."""
    _check_lstm_pair(cuda, kind, T, B, H, torch.bfloat16)
    _check_deterministic(cuda, kind, T, B, H)


def test_lstm_scan_tc_usage(cuda):
    """Registers and spills of lstm_scan's bf16 kernels (mode XP: the
    forward and the reverse loop, each with bf16 and with f32 x_proj, and
    the ring split-K) at every hidden size. The loops' 512 threads may
    hold 128 registers each (one block an SM), the ring's 256 threads 128
    (two blocks an SM). Nothing spills at H = 32 and 64, nor in the ring;
    at H = 128 the loops spill at most what they spilled on the H100 when
    this test was written (the forward 8 and 32 bytes, the reverse loop 16
    and 64, as fused's forward loop spills 16)."""
    import ctypes
    from pufferlib_tpu_torch.ops.cuda import lstm_scan
    for H in (32, 64, 128):
        out = (ctypes.c_int * 10)()
        assert lstm_scan.KERNEL.lib().lstm_scan_tc_usage(H, out) == 0
        regs, spilled = list(out)[::2], list(out)[1::2]
        assert all(0 < r <= 128 for r in regs), (H, regs)
        most = [8, 32, 16, 64, 0] if H == 128 else [0] * 5
        assert all(s <= m for s, m in zip(spilled, most)), (H, spilled)


def test_lstm_scan_autograd_on_the_card(cuda):
    """The autograd.Functions of the validation path and of the archive
    on CUDA tensors launch their kernels, and a call under no_grad
    launches the forward alone."""
    from pufferlib_tpu_torch.ops.cuda import lstm_enc, lstm_scan
    cdt = torch.float32
    T = 4
    functions = [('scan', lstm_scan.lstm_scan),
        ('fused', lstm_scan.lstm_scan_fused), ('enc', lstm_enc.lstm_scan_enc)]
    functions += [(kind, getattr(_archived(kind), f'lstm_scan_{kind}'))
        for kind in ARCHIVED_ENC + ('tm',)]
    for kind, fn in functions:
        _, _, fwd_plain, bwd_plain, fns = _lstm_kinds()[kind]
        args = _lstm_case(kind, T, 40, 32, 49, cdt, cuda)
        first = 1 if kind in ENC_KINDS else 0
        for t in args[first:]:
            t.requires_grad_()
        before = _launches()
        with torch.no_grad():
            fn(*args, cdt)
        assert _launches()[fns[0]] == before[fns[0]] + _steps(kind, T)
        assert _launches()[fns[1]] == before[fns[1]]
        outs, hT, cT = fn(*args, cdt)
        (outs.square().sum() + (hT * cT).sum()).backward()
        torch.cuda.synchronize()
        assert _launches()[fns[1]] == before[fns[1]] + _steps(kind, T)
        with torch.no_grad():
            want = fwd_plain(*args, cdt)
            want_g = bwd_plain(*args, want[0], want[3], 2 * want[0], want[2],
                want[1], cdt)
        for t, w in zip(args[first:], want_g):
            scale = max(1.0, w.abs().max().item())
            torch.testing.assert_close(t.grad, w, rtol=0,
                atol=LSTM_TOL[cdt] * scale)


@pytest.mark.parametrize('kind', ARCHIVED_ENC + ('tm',))
def test_archived_launchers_refuse_what_the_kernels_do_not_serve(cuda, kind):
    """The archived kernels keep the others' reach: hidden sizes 32, 64
    and 128, an input width equal to the hidden size, at most 128
    features. ValueError, and no launch."""
    fwd, bwd = _lstm_kinds()[kind][:2]
    cdt = torch.float32
    before = _launches()

    def case(T, B, F, D, H):
        z = lambda *shape: torch.zeros(*shape, device=cuda)
        if kind == 'tm':
            args = (z(T, B, 4 * H), z(B, H), z(B, H), z(H, 4 * H))
        else:
            args = (z(T, B, F), z(B, H), z(B, H), z(F, D), z(D), z(D, 4 * H),
                z(H, 4 * H), z(4 * H))
        return args, (z(T, B, H), z(T, B, H), z(T, B, H), z(B, H), z(B, H))

    shapes = [(2, 8, 7, 256, 256, r'\(32, 64, 128\)')]
    if kind != 'tm':
        shapes += [(2, 8, 7, 64, 128, r'\(32, 64, 128\)'),
            (2, 8, 129, 32, 32, 'at most 128 features')]
    for T, B, F, D, H, message in shapes:
        args, rest = case(T, B, F, D, H)
        with pytest.raises(ValueError, match=message):
            fwd(*args, cdt)
        with pytest.raises(ValueError, match=message):
            bwd(*args, *rest, cdt)
    assert _launches() == before


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


def test_lstm_default_route_on_the_card(cuda):
    """LSTMWrapper in bf16 on the card: with use_kernel=None, input 96 with
    hidden 128 runs enc5's kernels (the tensor-core pair takes D != H, as
    the JAX package runs enc5 there), two layers run cat's (enc5 cannot
    fuse the encoder), hidden 256 runs enc5's streamed design with
    use_kernel=None and with use_kernel=True, each with finite gradients;
    hidden 256 runs the 'off' scan with no LSTM launch where the caller
    asks for it (use_kernel=False). Hidden 48 and 200, no multiples of
    32, run enc5's streamed design too (padded to 64 and 224). Hidden 1473,
    past what any kernel serves in bf16, raises with use_kernel=None and
    with use_kernel=True before any launch."""
    from pufferlib_tpu_torch import spaces
    from pufferlib_tpu_torch.models import Default, LSTMWrapper
    torch.manual_seed(0)
    x = torch.randn(40, 6, 7, 7, device=cuda)
    cdt = torch.bfloat16
    kernels = {'enc5': {'lstm_enc_forward', 'lstm_enc_backward'},
        'cat': {'lstm_cat_forward', 'lstm_cat_backward'}, 'off': set(),
        'stream': {'lstm_enc_stream_forward', 'lstm_enc_stream_backward'}}

    def wrapper(D, H, layers, use):
        return LSTMWrapper(Default((7, 7), spaces.Discrete(5), hidden_size=D,
            dtype=cdt, decoder_input_size=H), obs_shape=(7, 7), input_size=D,
            hidden_size=H, num_layers=layers, dtype=cdt,
            use_kernel=use).to(cuda)
    for D, H, layers, use, route, design in ((96, 128, 1, None, 'enc5',
            'enc5'), (128, 128, 2, None, 'cat', 'cat'),
            (256, 256, 1, False, 'off', 'off'),
            (256, 256, 1, None, 'enc5', 'stream'),
            (256, 256, 1, True, 'enc5', 'stream'),
            (48, 48, 1, None, 'enc5', 'stream'),
            (200, 200, 1, None, 'enc5', 'stream')):
        mod = wrapper(D, H, layers, use)
        assert mod.route(6, cuda) == route
        before = _launches()
        logits, value, (h, c) = mod(x)
        (logits.square().sum() + value.sum() + (h * c).sum()).backward()
        torch.cuda.synchronize()
        after = _launches()
        launched = {fn for fn, n in after.items()
            if fn.startswith('lstm_') and n > before[fn]}
        assert launched == kernels[design]
        assert all(torch.isfinite(p.grad).all() for p in mod.parameters())
    mod = wrapper(1473, 1473, 1, None)
    for use, message in ((None, 'up to 1472.*use_kernel=False'),
            (True, 'up to 1472')):
        mod.use_kernel = use
        with pytest.raises(ValueError, match=message):
            mod(x)
    assert _launches() == after


def test_tc_max_input_is_the_kernels_limit(cuda):
    """lstm_common.tc_max_input, which the checks before a launch use,
    copies lstm_tc.cuh's constants: it must equal the widest input the C
    side serves (lstm_tc_max_input), at every hidden size."""
    import ctypes
    from pufferlib_tpu_torch.ops.cuda import lstm_cat, lstm_common
    for H in (32, 64, 128):
        out = (ctypes.c_int * 1)()
        assert lstm_cat.KERNEL.lib().lstm_tc_max_input(H, out) == 0
        assert out[0] == lstm_common.tc_max_input(H), H


@pytest.mark.parametrize('N', [1024, 5])
def test_ocean_burn_kernel_equals_plain_bit_for_bit(cuda, N):
    """The Performance envs' burn: each product and sum rounded on its
    own, as the plain version's two torch operations; counts <= 0 leave
    their lanes."""
    from pufferlib_tpu_torch.ops.cuda import burn
    rng = np.random.RandomState(N)
    x = torch.from_numpy(rng.rand(N).astype(np.float32)).to(cuda)
    iters = torch.from_numpy(rng.randint(-3, 300, N).astype(np.int32)).to(
        cuda)
    before = burn.KERNEL.launches
    got = burn.burn(x, iters)
    want = burn.burn_reference(x, iters)
    torch.cuda.synchronize()
    assert burn.KERNEL.launches == before + 1
    assert torch.equal(got, want)
