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
widths up to the encoder's limit) and their FMA kernels in f32.
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
        'enc': (lstm_enc._launch_enc_forward,
            lstm_enc._launch_step_backward, lstm_enc.lstm_enc_reference,
            lstm_enc.lstm_scan_enc_backward_reference,
            ('lstm_enc_forward', 'lstm_enc_step_backward')),
        'cat': (lstm_cat._launch_forward,
            lstm_cat._launch_backward, lstm_cat.lstm_cat_reference,
            lstm_cat.lstm_cat_backward_reference,
            ('lstm_cat_forward', 'lstm_cat_backward')),
        'cat_stream': (*lstm_cat.kept_gates(
            lstm_cat._launch_stream_forward, lstm_cat._launch_stream_backward),
            lstm_cat.lstm_cat_reference,
            lstm_cat.lstm_cat_backward_reference,
            ('lstm_cat_stream_forward', 'lstm_cat_stream_backward')),
        'enc5_stream': (*lstm_cat.kept_gates(
            lstm_enc._launch_stream_forward, lstm_enc._launch_stream_backward),
            lstm_enc.lstm_enc_reference,
            lstm_enc.lstm_enc_backward_reference,
            ('lstm_enc_stream_forward', 'lstm_enc_stream_backward')),
        'fused': (lstm_scan._launch_fused_forward,
            lstm_scan._launch_fused_backward,
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
        cdt=torch.bfloat16, runs=2):
    """`runs` forward and backward calls on the same inputs: every one
    equal to the first bit for bit."""
    fwd, bwd = _lstm_kinds()[kind][:2]
    args = _lstm_case(kind, T, B, H, F, cdt, cuda, D=D)
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
    """lstm_scan_cat launches the resident kernels where they serve and
    the streamed ones elsewhere (hidden 100 padded to 128); a hidden size
    no design takes raises before a launch."""
    from pufferlib_tpu_torch.ops.cuda.lstm_cat import lstm_scan_cat
    for D, H, cdt, fn in ((128, 128, torch.bfloat16, 'lstm_cat_forward'),
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
    in f32 (FMA) D != H and more than 128 features. lstm_scan_enc, whose
    backward runs on FMA, keeps FMA's reach in bf16 too. ValueError, and
    no launch."""
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


@pytest.mark.parametrize('kind', ARCHIVED_ENC)
@pytest.mark.parametrize('T,B,H', [(16, 8192, 128), (16, 1000, 128),
    (3, 45, 32), (5, 980, 64)])
@pytest.mark.parametrize('cdt', [torch.float32, torch.bfloat16])
def test_archived_enc_kernels_match_plain(cuda, kind, T, B, H, cdt):
    """enc2, enc3, enc4 and enc6: forward, every gradient, and the
    forward handed a null cseq. B = 980 leaves enc6's last block (64 rows
    as two tiles of 32) a short first tile and an empty second one."""
    _check_pair_and_primal(cuda, kind, T, B, H, cdt)


# the archived backwards with a tensor-core design in bf16 (lstm_tc.cuh:
# mode ENC5's path with each variant's roundings; enc2's pre-pass rounds
# its projection): all four
ARCHIVED_TC = ARCHIVED_ENC
# those whose f32 FMA kernel keeps every step's activations in a slab,
# handed over in the P slab's place
ACTS_SLAB = ('enc3', 'enc6')


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
    hidden size, at the bench batch and at ragged ones (1000; 980, which
    left enc6's last FMA block of two tiles a short first tile and an
    empty second one): within 2e-2 of max(1, max |plain|) of the plain
    versions, with one launch of each C function."""
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
    scratch (the P slab, the bf16 weights): handed none, it refuses. The
    FMA kernel, which f32 runs, takes only the whole backward (phases =
    4) and reads no bf16 weights; enc2's and enc4's read no slab either,
    enc3's and enc6's their activations slab in the P slab's place, and
    refuse without it. The launcher's phases 1 .. 3 stop the bf16 path
    early without an error."""
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
        archive.KERNEL._lib = NoScratch()
        try:
            if cdt == torch.bfloat16 or kind in ACTS_SLAB:
                with pytest.raises(RuntimeError):
                    bwd(*args, outs, cseq, *g, cdt)
            else:
                bwd(*args, outs, cseq, *g, cdt)
        finally:
            archive.KERNEL._lib = real
        if cdt == torch.float32:
            bwd(*args, outs, cseq, *g, cdt)
            with pytest.raises(RuntimeError):
                bwd(*args, outs, cseq, *g, cdt, phases=2)
        assert seen[0] == (cdt == torch.bfloat16 or kind in ACTS_SLAB)
    args = _lstm_case(kind, T, B, H, F, torch.bfloat16, cuda)
    with torch.no_grad():
        outs, _, _, cseq = fwd(*args, torch.bfloat16)
        for phases in (1, 2, 3):
            bwd(*args, outs, cseq, *(torch.zeros_like(t) for t in (outs,
                args[1], args[2])), torch.bfloat16, phases=phases)
    torch.cuda.synchronize()


@pytest.mark.parametrize('kind', ARCHIVED_TC)
@pytest.mark.parametrize('T,B,F,H', [(3, 45, 7, 32), (4, 200, 49, 64),
    (16, 1000, 49, 128), (2, 64, 128, 128)])
@pytest.mark.parametrize('cdt', [torch.float32, torch.bfloat16])
def test_archived_tc_backwards_write_only_their_buffers(cuda, monkeypatch,
        kind, T, B, F, H, cdt):
    """Every input, output and scratch buffer of the archived forward and
    backward (the P slab, the bf16 weights, db_part at 64 rows a block;
    in f32 enc3's and enc6's activations slab) sits between guards; after
    both calls no guard has changed, at a ragged last block (45, 200 and
    1000 rows), at the widest feature width the archive takes (for enc6
    in f32, whose block of two dgates tiles the launcher refuses past 107
    features at hidden size 128, that one), and the results still match
    the plain versions within LSTM_TOL."""
    from pufferlib_tpu_torch.ops.cuda import archive, lstm_common, lstm_enc
    fwd, bwd, fwd_plain, bwd_plain, _ = _lstm_kinds()[kind]
    if kind == 'enc6' and cdt == torch.float32 and H == 128:
        F = min(F, 107)
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
    from the unrounded dgates) at every hidden size: the loops' 512
    threads may hold 128 registers each (one block an SM), the GEMM's 256
    threads 128 (two blocks an SM). The loops spill nothing, the GEMM at
    most the 16 bytes that enc5's backward pre-pass spills (as on the H100
    when this test was written)."""
    import ctypes
    from pufferlib_tpu_torch.ops.cuda import archive
    for H in (32, 64, 128):
        out = (ctypes.c_int * 6)()
        assert archive.KERNEL.lib().lstm_archive_tc_usage(H, out) == 0
        regs, spilled = list(out)[::2], list(out)[1::2]
        assert all(0 < r <= 128 for r in regs), (H, regs)
        assert spilled[0] <= 16 and spilled[1:] == [0, 0], (H, spilled)


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
# ring where its sources are bf16 rows (cat, fused, scan, enc5's [x |
# h_prev], the FMA backwards' [xs | h_prev]), the register-staged kernel
# for the rest (enc5's [feats | 1], the feature rows of odd width)
SPLITK_KINDS = ('enc5', 'enc', 'cat', 'fused', 'scan') + ARCHIVED_ENC


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
    features; enc6, whose block holds two tiles of dgates, also refuses a
    feature width that its shared memory cannot hold. ValueError, and no
    launch."""
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
    if kind == 'enc6':
        args, rest = case(2, 8, 128, 128, 128)
        with pytest.raises(ValueError, match='shared memory'):
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
