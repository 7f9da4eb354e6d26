"""The archived LSTM variants of the PyTorch port (ops/cuda/archive: enc2,
enc3, enc4, enc6, tm) against the JAX package's archive, on the CPU.

The port's side runs the kernels' plain versions (explicit forward and
backward in PyTorch, what the autograd.Functions run for CPU tensors).
The JAX side runs as tests/test_pallas_archive.py runs it: the Pallas
kernels under pltpu.force_tpu_interpret_mode(), at that test's shapes
(T = 3, B = 16, F = 49, D = 96, H = 128; tm: T = 5, B = 16, H = 8) and
with its losses. Inputs come from numpy.random.RandomState(seed) and go
into both.

Tolerances. float32: outputs 1e-5; gradients 1e-4 of max(1, max
|reference|) per tensor (the JAX test allows 5e-4 absolute; the largest
difference reached here is 2.9e-6 on a gradient of magnitude 14, and 4e-7
of a tensor's scale: the same f32 products summed in another order); tm
1e-6 and 1e-5, as the JAX test.
bfloat16: 2e-2 of max(1, max |reference|): h, c, the activations and
dgates round to bf16 inside the recurrence, so a sum on the other side of
a rounding boundary rounds one ulp (2^-8) the other way and carries on
(reached here: at most 3.9e-3, on enc4's dW_ih of magnitude 4.2; enc2
agrees to 8e-6).
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from pufferlib_tpu.ops.pallas import lstm as jax_lstm
from pufferlib_tpu.ops.pallas import lstm_enc as jax_lstm_enc
from pufferlib_tpu.ops.pallas.archive import lstm_enc2 as jax_lstm_enc2
from pufferlib_tpu.ops.pallas.archive import lstm_tm as jax_lstm_tm

from pufferlib_tpu_torch.ops.cuda import archive, lstm_enc, lstm_scan
from pufferlib_tpu_torch.ops.cuda.archive import lstm_tm

torch.set_num_threads(1)

ENC_VARIANTS = ('enc2', 'enc3', 'enc4', 'enc6')
JD = {'float32': jnp.float32, 'bfloat16': jnp.bfloat16}
TD = {'float32': torch.float32, 'bfloat16': torch.bfloat16}
ENC_GRADS = ('dh0', 'dc0', 'dw_enc', 'db_enc', 'dw_ih', 'dw_hh', 'db')
TM_GRADS = ('dx_proj', 'dh0', 'dc0', 'dw_hh')


def port_module(variant):
    return importlib.import_module(
        f'pufferlib_tpu_torch.ops.cuda.archive.lstm_{variant}')


def port_scan(variant):
    return getattr(port_module(variant), f'lstm_scan_{variant}')


def jax_scan(variant):
    mod = importlib.import_module(
        f'pufferlib_tpu.ops.pallas.archive.lstm_{variant}')
    return getattr(mod, f'lstm_scan_{variant}')


def rounded(a, dtype):
    """a with the values of dtype, as float32: both packages start from
    the same bits."""
    return np.array(jnp.asarray(a).astype(JD[dtype]).astype(jnp.float32))


def enc_inputs(seed, dtype='float32', T=3, B=16, F=49, D=96, H=128):
    """tests/test_pallas_archive.py's shapes and scales."""
    rng = np.random.RandomState(seed)
    shapes = ((T, B, F), (B, H), (B, H), (F, D), (D,), (D, 4 * H),
        (H, 4 * H), (4 * H,))
    scales = (0.5, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1)
    arrays = [(rng.randn(*s) * k).astype(np.float32)
        for s, k in zip(shapes, scales)]
    arrays[0] = rounded(arrays[0], dtype)
    return arrays


def tm_inputs(seed, dtype='float32', T=5, B=16, H=8):
    rng = np.random.RandomState(seed)
    shapes = ((T, B, 4 * H), (B, H), (B, H), (H, 4 * H))
    scales = (0.3, 0.2, 0.2, 0.2)
    arrays = [(rng.randn(*s) * k).astype(np.float32)
        for s, k in zip(shapes, scales)]
    arrays[0] = rounded(arrays[0], dtype)
    return arrays


def enc_loss(o, h, c):
    return (o ** 2).sum() + (h * c).sum() + (o * 0.3).sum()


def tm_loss(o, h, c):
    return (o * 0.7).sum() + (h * 1.3).sum() + (c * 0.5).sum()


def to_np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def jax_run(fn, arrays, cdt, seq_dtype, first, loss):
    """(outs, hT, cT) and the gradients of the loss from argument `first`
    on."""
    args = [jnp.asarray(arrays[0]).astype(JD[seq_dtype])] + [
        jnp.asarray(a) for a in arrays[1:]]

    def f(*a):
        o, h, c = fn(*a, JD[cdt])
        return loss(o.astype(jnp.float32), h, c)
    outs = fn(*args, JD[cdt])
    grads = jax.grad(f, argnums=tuple(range(first, len(args))))(*args)
    return outs, grads


def torch_run(fn, arrays, cdt, seq_dtype, first, loss):
    tensors = [torch.from_numpy(arrays[0]).to(TD[seq_dtype])] + [
        torch.from_numpy(a) for a in arrays[1:]]
    for t in tensors[first:]:
        t.requires_grad_()
    outs = fn(*tensors, TD[cdt])
    loss(outs[0].float(), outs[1], outs[2]).backward()
    return outs, [t.grad for t in tensors[first:]]


def assert_close(got, want, tol, relative, what):
    want = to_np(want)
    if relative:
        tol = tol * max(1.0, np.abs(want).max())
    np.testing.assert_allclose(to_np(got), want, rtol=0, atol=tol,
        err_msg=what)


def compare(got, want, names, out_tol, grad_tol, out_relative=False):
    """Outputs (absolute unless out_relative) and gradients (of max(1,
    max |want|)) of one run against another."""
    (outs, grads), (wouts, wgrads) = got, want
    for name, a, w in zip(('outs', 'hT', 'cT'), outs, wouts):
        assert_close(a, w, out_tol, out_relative, name)
    assert len(grads) == len(wgrads) == len(names)
    for name, a, w in zip(names, grads, wgrads):
        assert a.shape == tuple(w.shape), name
        assert_close(a, w, grad_tol, True, name)


@pytest.mark.parametrize('cdt', sorted(TD))
@pytest.mark.parametrize('variant', ENC_VARIANTS)
def test_enc_variant_matches_pallas_kernel(variant, cdt):
    """Outputs and all seven gradients against the archived Pallas kernel
    in interpret mode."""
    arrays = enc_inputs(7, cdt)
    with pltpu.force_tpu_interpret_mode():
        want = jax_run(jax_scan(variant), arrays, cdt, cdt, 1, enc_loss)
    got = torch_run(port_scan(variant), arrays, cdt, cdt, 1, enc_loss)
    assert got[0][0].dtype == TD[cdt] and got[0][1].dtype == torch.float32
    if cdt == 'bfloat16':
        compare(got, want, ENC_GRADS, 2e-2, 2e-2, out_relative=True)
    else:
        compare(got, want, ENC_GRADS, 1e-5, 1e-4)


@pytest.mark.parametrize('seq,cdt', [('float32', 'float32'),
    ('bfloat16', 'bfloat16'), ('float32', 'bfloat16'),
    ('bfloat16', 'float32')])
def test_tm_matches_pallas_kernel(seq, cdt):
    """lstm_scan_tm against the time-major Pallas kernel in interpret
    mode, with x_proj in the compute dtype and in the other one; dx_proj
    comes back in x_proj's dtype."""
    arrays = tm_inputs(3, seq)
    with pltpu.force_tpu_interpret_mode():
        want = jax_run(jax_lstm_tm.lstm_scan_tm, arrays, cdt, seq, 0, tm_loss)
    got = torch_run(lstm_tm.lstm_scan_tm, arrays, cdt, seq, 0, tm_loss)
    assert got[1][0].dtype == TD[seq] and got[0][0].dtype == TD[cdt]
    if 'bfloat16' in (seq, cdt):
        compare(got, want, TM_GRADS, 2e-2, 2e-2, out_relative=True)
    else:
        compare(got, want, TM_GRADS, 1e-6, 1e-5)


@pytest.mark.parametrize('variant', ENC_VARIANTS + ('tm',))
def test_ragged_batch_matches_jax_reference(variant):
    """B = 12, not a multiple of 8 (which the Pallas kernels need) nor of
    the CUDA kernels' 32 rows per block: against jax.grad of the pure-JAX
    reference, f32."""
    if variant == 'tm':
        arrays = tm_inputs(11, B=12)
        want = jax_run(lambda *a: jax_lstm.lstm_scan_reference(*a[:-1]),
            arrays, 'float32', 'float32', 0, tm_loss)
        got = torch_run(lstm_tm.lstm_scan_tm, arrays, 'float32', 'float32',
            0, tm_loss)
        compare(got, want, TM_GRADS, 1e-6, 1e-5)
    else:
        arrays = enc_inputs(11, B=12, F=7, D=24, H=32)
        want = jax_run(jax_lstm_enc.lstm_scan_enc_reference, arrays,
            'float32', 'float32', 1, enc_loss)
        got = torch_run(port_scan(variant), arrays, 'float32', 'float32', 1,
            enc_loss)
        compare(got, want, ENC_GRADS, 1e-5, 1e-4)


def plain_pair(variant):
    if variant == 'tm':
        return lstm_tm.lstm_tm_reference, lstm_tm.lstm_tm_backward_reference
    v = port_module(variant).VARIANT
    return v.forward_plain, v.backward_plain


@pytest.mark.parametrize('variant', ENC_VARIANTS + ('tm',))
def test_explicit_backward_matches_autograd(variant):
    """The hand-written plain backward against torch.autograd through the
    plain forward, f32, to 1e-5 of max(1, max |gradient|) (the same math
    in another order)."""
    fwd, bwd = plain_pair(variant)
    if variant == 'tm':
        arrays, first, names = tm_inputs(4, T=4, B=12, H=32), 0, TM_GRADS
    else:
        arrays, first, names = enc_inputs(4, B=12, F=7, D=24, H=32), 1, \
            ENC_GRADS
    T, B, H = arrays[0].shape[0], 12, 32
    tensors = [torch.from_numpy(a) for a in arrays]
    for t in tensors[first:]:
        t.requires_grad_()
    outs, hT, cT, cseq = fwd(*tensors, torch.float32)
    rng = np.random.RandomState(5)
    cot = [torch.from_numpy(rng.randn(*s).astype(np.float32))
        for s in ((T, B, H), (B, H), (B, H))]
    want = torch.autograd.grad([outs, hT, cT], tensors[first:], cot)
    with torch.no_grad():
        got = bwd(*tensors, outs, cseq, *cot, torch.float32)
    assert len(got) == len(want) == len(names)
    for name, a, w in zip(names, got, want):
        assert_close(a, w, 1e-5, True, f'{variant} {name}')


@pytest.mark.parametrize('cdt', sorted(TD))
@pytest.mark.parametrize('variant', ['enc3', 'enc4', 'enc6'])
def test_forward_is_lstm_scan_enc_forward(variant, cdt):
    """enc3, enc4 and enc6 change the backward alone: outs, hT and cT
    equal lstm_scan_enc's bit for bit."""
    tensors = [torch.from_numpy(a) for a in enc_inputs(8, cdt)]
    tensors[0] = tensors[0].to(TD[cdt])
    got = port_scan(variant)(*tensors, TD[cdt])
    want = lstm_enc.lstm_scan_enc(*tensors, TD[cdt])
    for a, w in zip(got, want):
        assert torch.equal(a, w)


def test_enc2_is_enc_in_f32_and_rounds_xp_in_bf16():
    """f32: enc2 agrees with lstm_scan_enc to 1e-5 (two sums instead of
    one). bf16: xp = x @ W_ih + b passes through bf16 before h @ W_hh is
    added, which enc's single sum never does. With h0 = 0, W_hh = 0 and a
    projection whose value 1 + 2^-9 lies between two bf16 numbers, enc2's
    gates see 1.0 and enc's see 1 + 2^-9, and the outputs differ."""
    enc2 = port_scan('enc2')
    arrays = enc_inputs(9)
    tensors = [torch.from_numpy(a) for a in arrays]
    for a, w in zip(enc2(*tensors, torch.float32),
            lstm_enc.lstm_scan_enc(*tensors, torch.float32)):
        assert_close(a, w, 1e-5, False, 'enc2 vs enc, f32')

    T, B, F, D, H = 1, 8, 2, 2, 32
    bf16 = torch.bfloat16
    feats = torch.ones(T, B, F).to(bf16)
    w_enc = torch.eye(F, D)                    # x = relu(feats) = 1
    w_ih = torch.zeros(D, 4 * H)
    w_ih[0] = 1.0
    w_ih[1] = 2.0 ** -9            # x @ W_ih = 1 + 2^-9, exact in f32
    zeros = dict(h0=torch.zeros(B, H), c0=torch.zeros(B, H),
        b_enc=torch.zeros(D), w_hh=torch.zeros(H, 4 * H),
        b=torch.zeros(4 * H))
    args = (feats, zeros['h0'], zeros['c0'], w_enc, zeros['b_enc'], w_ih,
        zeros['w_hh'], zeros['b'], bf16)
    _, h2, c2 = enc2(*args)
    _, h1, c1 = lstm_enc.lstm_scan_enc(*args)
    # enc2's gate pre-activation is exactly 1.0, enc's 1 + 2^-9
    g2, g1 = torch.tensor(1.0), torch.tensor(1.0 + 2.0 ** -9)
    for g, h, c in ((g2, h2, c2), (g1, h1, c1)):
        want_c = torch.sigmoid(g) * torch.tanh(g)
        torch.testing.assert_close(c, want_c.expand(B, H), rtol=0, atol=1e-6)
        torch.testing.assert_close(h, (torch.sigmoid(g) * torch.tanh(want_c))
            .expand(B, H), rtol=0, atol=1e-6)
    assert not torch.equal(c2, c1)


@pytest.mark.parametrize('variant,cdt', [('enc6', 'bfloat16'),
    ('enc6', 'float32'), ('enc4', 'float32'), ('enc3', 'float32')])
def test_enc6_gradients_are_enc5_gradients(variant, cdt):
    """enc6 is a schedule of enc5's function: on the CPU the same plain
    versions run, and every output and gradient is equal bit for bit.
    enc4's and enc3's backwards round at their own places, which are the
    identity in f32, where they compute enc5's function too (and on the
    card run enc5's f32 backward): their plain f32 gradients within 1e-6
    of max(1, max |enc5's|) of enc5's (enc4's gate recompute a step at a
    time, enc3's dW carried through its loop: the same products summed in
    another order)."""
    arrays = enc_inputs(10, cdt)
    got = torch_run(port_scan(variant), arrays, cdt, cdt, 1, enc_loss)
    enc5 = torch_run(lstm_enc.lstm_scan_enc5, arrays, cdt, cdt, 1, enc_loss)
    if variant == 'enc6':
        for a, w in zip(got[0] + tuple(got[1]), enc5[0] + tuple(enc5[1])):
            assert torch.equal(a, w)
    else:
        compare(got, enc5, ENC_GRADS, 0.0, 1e-6)


@pytest.mark.parametrize('seq,cdt', [('float32', 'float32'),
    ('bfloat16', 'bfloat16'), ('float32', 'bfloat16')])
def test_tm_is_lstm_scan(seq, cdt):
    """The time-major scan computes lstm_scan's function: outputs and
    gradients to 1e-6 (in fact equal: the same operations in the same
    order on the CPU)."""
    arrays = tm_inputs(12, seq, T=4, B=12, H=32)
    tm = torch_run(lstm_tm.lstm_scan_tm, arrays, cdt, seq, 0, tm_loss)
    scan = torch_run(lstm_scan.lstm_scan, arrays, cdt, seq, 0, tm_loss)
    compare(tm, scan, TM_GRADS, 1e-6, 1e-6)


@pytest.mark.parametrize('variant', ENC_VARIANTS)
def test_no_cell_sequence_without_gradients(variant, monkeypatch):
    """A call that needs no gradient asks the forward for no cseq (the
    kernel is then handed a null pointer) and returns the same outputs;
    one that needs a gradient asks for it."""
    mod = port_module(variant)
    fwd = mod.VARIANT.forward_plain
    seen = []

    def recording(*args):
        seen.append(args[-1])
        result = fwd(*args)
        assert (result[3] is None) == (not args[-1])
        return result
    monkeypatch.setattr(mod, 'VARIANT',
        mod.VARIANT._replace(forward_plain=recording))
    scan = port_scan(variant)
    tensors = [torch.from_numpy(a) for a in enc_inputs(13, B=12, F=7, D=24,
        H=32)]
    primal = scan(*tensors, torch.float32)
    tensors[-1].requires_grad_()
    with torch.no_grad():
        scan(*tensors, torch.float32)
    saving = scan(*tensors, torch.float32)
    assert seen == [False, False, True]
    assert saving[0].requires_grad and not primal[0].requires_grad
    for a, w in zip(primal, saving):
        assert torch.equal(a, w)


@pytest.mark.parametrize('variant', ENC_VARIANTS + ('tm',))
def test_launchers_refuse_cpu_tensors(variant):
    """No quiet way from the kernel to the plain version: a launcher
    handed CPU tensors raises."""
    if variant == 'tm':
        tensors = [torch.from_numpy(a) for a in tm_inputs(14, H=32)]
        launch_fwd, launch_bwd = lstm_tm._launch_forward, \
            lstm_tm._launch_backward
        outs, _, _, cseq = lstm_tm.lstm_tm_reference(*tensors, torch.float32)
    else:
        tensors = [torch.from_numpy(a) for a in enc_inputs(14, F=7, D=32,
            H=32)]
        v = port_module(variant).VARIANT
        launch_fwd, launch_bwd = v.forward_launch, v.backward_launch
        outs, _, _, cseq = v.forward_plain(*tensors, torch.float32)
    cot = (torch.zeros_like(outs), torch.zeros_like(tensors[1]),
        torch.zeros_like(tensors[2]))
    with pytest.raises(ValueError, match='no LSTM kernel for device cpu'):
        launch_fwd(*tensors, torch.float32)
    with pytest.raises(ValueError, match='no LSTM kernel for device cpu'):
        launch_bwd(*tensors, outs, cseq, *cot, torch.float32)


def test_wrappers_check_their_inputs():
    feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b = (torch.from_numpy(a)
        for a in enc_inputs(15, B=8, F=7, D=24, H=32))
    enc4 = port_scan('enc4')
    with pytest.raises(ValueError, match='feats must be'):
        enc4(feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b, torch.bfloat16)
    with pytest.raises(ValueError, match='w_enc'):
        enc4(feats, h0, c0, w_enc.t(), b_enc, w_ih, w_hh, b, torch.float32)
    with pytest.raises(ValueError, match='compute dtype'):
        enc4(feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b, torch.float16)
    x_proj, h0, c0, w_hh = (torch.from_numpy(a) for a in tm_inputs(15))
    with pytest.raises(ValueError, match='x_proj'):
        lstm_tm.lstm_scan_tm(x_proj.double(), h0, c0, w_hh, torch.float32)
    with pytest.raises(ValueError, match='w_hh'):
        lstm_tm.lstm_scan_tm(x_proj, h0, c0, w_hh.t(), torch.float32)


def test_archive_kernel_is_built_and_counted_with_the_others():
    """The archive's C functions are in ops.cuda.KERNELS (so build_all
    builds them and the launch counters see them; lstm_archive_tc_usage
    and lstm_tm_tc_usage read registers and launch nothing), while the
    trainer's LSTMWrapper keeps refusing the archived kinds."""
    from pufferlib_tpu_torch import spaces
    from pufferlib_tpu_torch.models import Default, LSTMWrapper
    from pufferlib_tpu_torch.ops.cuda import KERNELS
    assert archive.KERNEL in KERNELS
    assert set(archive.KERNEL.fn_launches) == {'lstm_enc2_forward',
        'lstm_enc2_backward', 'lstm_enc3_backward', 'lstm_enc4_backward',
        'lstm_enc6_backward', 'lstm_tm_step_forward', 'lstm_tm_step_backward',
        'lstm_archive_tc_usage', 'lstm_tm_tc_usage'}
    assert all(n == 0 for n in archive.KERNEL.fn_launches.values())
    for kind in ENC_VARIANTS + ('tm',):
        with pytest.raises(ValueError, match='kernel'):
            LSTMWrapper(Default((7, 7), spaces.Discrete(5), hidden_size=32),
                obs_shape=(7, 7), input_size=32, hidden_size=32, kernel=kind)


# every C function of the archive that launches a kernel, and the design it
# runs in (bf16, f32): every bf16 one on the tensor cores, every f32 one on
# csrc/lstm_f32.cuh (enc2's pair enc5's with two sums, the other three
# backwards enc5's, tm's lstm_scan's one step a launch)
ARCHIVE_DESIGNS = {
    'lstm_enc2_forward': ('tc', 'cluster'),
    'lstm_enc2_backward': ('tc', 'cluster'),
    'lstm_enc3_backward': ('tc', 'cluster'),
    'lstm_enc4_backward': ('tc', 'cluster'),
    'lstm_enc6_backward': ('tc', 'cluster'),
    'lstm_tm_step_forward': ('tc', 'cluster'),
    'lstm_tm_step_backward': ('tc', 'cluster'),
}


@pytest.mark.parametrize('fn', sorted(ARCHIVE_DESIGNS))
def test_archive_design_table(fn):
    assert archive.design(fn, torch.bfloat16) == ARCHIVE_DESIGNS[fn][0]
    assert archive.design(fn, torch.float32) == ARCHIVE_DESIGNS[fn][1]
    assert (fn in archive.F32_FUNCTIONS) == (ARCHIVE_DESIGNS[fn][1]
        == 'cluster')


@pytest.mark.parametrize('fn', ['lstm_archive_tc_usage', 'lstm_tm_tc_usage'])
def test_archive_design_refuses_a_query(fn):
    """The registers-and-spills queries of the archive's library launch
    nothing, so they have no design: archive.design raises for them in
    both dtypes, as it does for a name that is no C function of the
    archive."""
    for cdt in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError, match='not a launch'):
            archive.design(fn, cdt)
    with pytest.raises(ValueError, match='not a C function'):
        archive.design('lstm_enc_forward', torch.float32)


# (F, D, H) of enc2's f32 forward: inside enc5's f32 reach (D == H in 32,
# 64, 128, at most 128 features) and just past it (D != H, 129 features,
# hidden 96)
ENC2_F32_FORWARD_SHAPES = [(49, 128, 128), (1, 32, 32), (128, 64, 64),
    (49, 96, 128), (129, 128, 128), (49, 96, 96)]


@pytest.mark.parametrize('F,D,H', ENC2_F32_FORWARD_SHAPES)
def test_enc2_f32_forward_launch_takes_f32_scratch(F, D, H, monkeypatch):
    """enc2's f32 forward launches lstm_enc2_forward (design 'cluster':
    csrc/lstm_f32.cuh's enc5 forward with two sums) through
    lstm_enc.launch_forward with enc5's f32 scratch: the encoded inputs
    (T, B, D) and the projection x @ W_ih + b (T * B * 4H), both f32, and
    no bf16 weights; phases 1 (the encoder and the projection) and 2 (the
    whole forward) both reach the launch, and a call without a gradient
    passes no cell sequence. A shape past enc5's f32 reach is refused
    before any launch. The device check is taken out and the pointers
    handed over as the tensors themselves, and the launch is recorded,
    not made, so that CPU tensors reach it."""
    from pufferlib_tpu_torch.ops.cuda import lstm_common

    def refuse_shape(device, err):
        if err is not None:
            raise ValueError(err)
    calls = []

    def record(fn, *args):
        calls.append((fn, args))
    monkeypatch.setattr(lstm_common, '_refuse', refuse_shape)
    monkeypatch.setattr(lstm_enc, 'ptr', lambda t: t)
    monkeypatch.setattr(lstm_enc, 'ptr_or_null', lambda t: t)
    monkeypatch.setattr(lstm_enc, 'stream_handle', lambda t: None)
    monkeypatch.setattr(archive.KERNEL, 'launch', record)
    assert archive.design('lstm_enc2_forward', torch.float32) == 'cluster'
    launch = port_module('enc2').VARIANT.forward_launch
    T, B = 2, 5
    tensors = [torch.from_numpy(a) for a in enc_inputs(32, T=T, B=B, F=F,
        D=D, H=H)]
    err = lstm_common.fma_encoder_shape_error(F, D, H)
    assert (err is None) == (D == H and H in lstm_common.KERNEL_HIDDEN
        and F <= lstm_common.KERNEL_MAX_FEATURES)
    if err is not None:
        with pytest.raises(ValueError, match='on FMA'):
            launch(*tensors, torch.float32)
        assert calls == []
        return
    for phases, save_cseq in ((1, True), (2, True), (2, False)):
        outs, hT, cT, cseq = launch(*tensors, torch.float32, save_cseq,
            phases)
        fn, args = calls[-1]
        assert fn == 'lstm_enc2_forward' and len(args) == 23
        assert args[8] is outs and args[9] is cseq
        assert (cseq is None) != save_cseq
        xs, xp, w16 = args[12:15]
        assert xs.dtype == xp.dtype == torch.float32
        assert xs.shape == (T, B, D) and xp.shape == (T * B * 4 * H,)
        assert w16 is None
        assert args[15:22] == (T, B, F, D, H, 0, phases)
    assert len(calls) == 3


# (F, H) at the edges of the f32 reach of the step backward and enc3, enc4
# and enc6 (D == H): one
# feature, the bench's 49, 107 and 108 (enc6's old FMA block of two dgates
# tiles held at most 107 features at hidden size 128 in its shared memory)
# and the most, 128; 129 is past lstm_common.KERNEL_MAX_FEATURES
F32_REACH = [(F, H) for H in (32, 64, 128) for F in (1, 49, 107, 108, 128,
    129)]


@pytest.mark.parametrize('variant', ['enc', 'enc3', 'enc4', 'enc6'])
@pytest.mark.parametrize('F,H', F32_REACH)
def test_f32_backward_reach_is_the_fma_kernels(variant, F, H, monkeypatch):
    """lstm_scan_enc's step backward (variant 'enc',
    lstm_enc_step_backward) and the archived enc3's, enc4's and enc6's f32
    backwards run csrc/lstm_f32.cuh (design 'cluster') and serve every
    (F, D, H) that fma_encoder_shape_error allows (their FMA kernels'
    reach): the launcher checks that shape, refuses nothing past it, and
    hands lstm_enc.launch_backward an f32 call of the function on its own
    library. The check before a launch is held with the device test taken
    out (so that CPU tensors reach it); the launch is recorded, not
    made."""
    from pufferlib_tpu_torch.ops.cuda import lstm_common

    def refuse_shape(device, err):
        if err is not None:
            raise ValueError(err)
    calls = []

    def record(kernel, fn, *args, **kwargs):
        # after the 13 tensors: cdt, phases
        calls.append((kernel, fn, args[13:], kwargs))
        return 'launched'
    monkeypatch.setattr(lstm_common, '_refuse', refuse_shape)
    monkeypatch.setattr(lstm_enc, 'launch_backward', record)
    if variant == 'enc':
        kernel, fn = lstm_enc.KERNEL, 'lstm_enc_step_backward'
        launch, design = lstm_enc._launch_step_backward, lstm_enc.design
    else:
        kernel, fn = archive.KERNEL, f'lstm_{variant}_backward'
        launch = port_module(variant).VARIANT.backward_launch
        design = archive.design
    assert design(fn, torch.float32) == 'cluster'
    T, B = 2, 3
    tensors = [torch.from_numpy(a) for a in enc_inputs(23, T=T, B=B, F=F,
        D=H, H=H)]
    rest = (torch.zeros(T, B, H), torch.zeros(T, B, H), torch.zeros(T, B, H),
        torch.zeros(B, H), torch.zeros(B, H))
    err = lstm_common.fma_encoder_shape_error(F, H, H)
    assert (err is None) == (F <= lstm_common.KERNEL_MAX_FEATURES)
    if err is not None:
        with pytest.raises(ValueError, match='at most 128 features'):
            launch(*tensors, *rest, torch.float32)
        assert calls == []
        return
    assert launch(*tensors, *rest, torch.float32) == 'launched'
    assert calls == [(kernel, fn, (torch.float32,
        lstm_common.BACKWARD_PHASES), {})]


def test_enc2_f32_backward_matches_jax_bwd():
    """enc2's plain f32 backward (what its f32 kernel, enc5's backward with
    two sums, is held to on the card) against the JAX custom_vjp's `_bwd`,
    its Pallas kernel in interpret mode, on the same residuals (the JAX
    forward's outs and cseq) and cotangents, at T 3, B 16, H = D 32, F 5:
    the seven gradients within 1e-4 of max(1, max |reference|)."""
    T, B, F, H = 3, 16, 5, 32
    arrays = enc_inputs(21, T=T, B=B, F=F, D=H, H=H)
    rng = np.random.RandomState(22)
    cot = [(rng.randn(*s) * 0.5).astype(np.float32)
        for s in ((T, B, H), (B, H), (B, H))]
    with pltpu.force_tpu_interpret_mode():
        (_, _, _), residuals = jax_lstm_enc2._fwd(
            *(jnp.asarray(a) for a in arrays), jnp.float32)
        want = jax_lstm_enc2._bwd(jnp.float32, residuals,
            tuple(jnp.asarray(c) for c in cot))
    outs, cseq = (torch.from_numpy(np.array(r)) for r in residuals[8:])
    tensors = [torch.from_numpy(a) for a in arrays]
    got = port_module('enc2').lstm_enc2_backward_reference(*tensors, outs,
        cseq, *(torch.from_numpy(c) for c in cot), torch.float32)
    # JAX returns the feats cotangent first (zero by contract); the port
    # returns the seven others
    assert len(want) == 8 and len(got) == len(ENC_GRADS)
    for name, a, w in zip(ENC_GRADS, got, want[1:]):
        assert tuple(a.shape) == tuple(w.shape), name
        assert_close(a, w, 1e-4, True, f'enc2 {name}')


# mode XP's backward: the JAX custom_vjp's forward (for its residuals) and
# backward, and the port's plain backward
XP_BWD = {
    'scan': (jax_lstm._lstm_scan_fwd, jax_lstm._lstm_scan_bwd,
        lstm_scan.lstm_scan_backward_reference),
    'tm': (jax_lstm_tm._lstm_tm_fwd, jax_lstm_tm._lstm_tm_bwd,
        lstm_tm.lstm_tm_backward_reference),
}


def xp_bwd_case(seed, seq, T, B, H):
    """tm_inputs with x_proj in seq, and cotangents (g_outs, g_hT, g_cT)."""
    arrays = tm_inputs(seed, seq, T=T, B=B, H=H)
    rng = np.random.RandomState(seed + 1)
    cot = [(rng.randn(*s) * 0.5).astype(np.float32)
        for s in ((T, B, H), (B, H), (B, H))]
    tensors = [torch.from_numpy(arrays[0]).to(TD[seq])] + [
        torch.from_numpy(a) for a in arrays[1:]]
    return arrays, cot, tensors


def assert_xp_grads(got, want, seq, what):
    """dx_proj in x_proj's dtype; in bf16 a dgate one f32 ulp apart may
    round to the next bf16 value (2e-2 of the scale, the module's bf16
    tolerance), else 1e-5 of max(1, max |reference|) (the same f32
    products summed in another order)."""
    assert len(got) == len(want) == len(TM_GRADS)
    assert got[0].dtype == TD[seq]
    for name, a, w in zip(TM_GRADS, got, want):
        assert tuple(a.shape) == tuple(w.shape), name
        tol = 2e-2 if a.dtype == torch.bfloat16 else 1e-5
        assert_close(a, w, tol, True, f'{what} {name}')


@pytest.mark.parametrize('seq', ['float32', 'bfloat16'])
@pytest.mark.parametrize('kind', sorted(XP_BWD))
def test_xp_f32_backward_matches_jax_bwd(kind, seq):
    """lstm_scan's and tm's plain f32 backwards (what their kernels, mode
    XP's backward on csrc/lstm_f32.cuh, are held to on the card) against
    the JAX custom_vjp's backward, `_lstm_scan_bwd` / `_lstm_tm_bwd`, its
    Pallas kernel in interpret mode, on the same residuals (the JAX
    forward's outs and cseq) and cotangents, x_proj in f32 and in bf16
    under f32 compute, at T 5, B 16 (the Pallas kernels tile B by 8), H
    32; tolerances of assert_xp_grads."""
    T, B, H = 5, 16, 32
    arrays, cot, tensors = xp_bwd_case(31, seq, T, B, H)
    fwd, bwd, plain = XP_BWD[kind]
    args = [jnp.asarray(arrays[0]).astype(JD[seq])] + [
        jnp.asarray(a) for a in arrays[1:]]
    with pltpu.force_tpu_interpret_mode():
        _, residuals = fwd(*args, jnp.float32)
        want = bwd(jnp.float32, residuals, tuple(jnp.asarray(c) for c in cot))
    outs, cseq = (torch.from_numpy(np.array(r)) for r in residuals[4:])
    got = plain(*tensors, outs, cseq, *(torch.from_numpy(c) for c in cot),
        torch.float32)
    assert_xp_grads(got, want, seq, f'{kind} x_proj {seq}')


@pytest.mark.parametrize('seq', ['float32', 'bfloat16'])
@pytest.mark.parametrize('kind', sorted(XP_BWD))
def test_xp_f32_backward_at_a_ragged_batch_matches_jax_reference(kind, seq):
    """The same at T 5, B 10, H 32, a batch no Pallas LSTM kernel tiles:
    against jax.vjp of the pure-JAX lstm_scan_reference in f32 (tm's
    function is lstm_scan's), on the port's plain forward's residuals;
    tolerances of assert_xp_grads."""
    T, B, H = 5, 10, 32
    arrays, cot, tensors = xp_bwd_case(33, seq, T, B, H)
    fwd = lstm_scan.lstm_scan_reference if kind == 'scan' \
        else lstm_tm.lstm_tm_reference
    outs, _, _, cseq = fwd(*tensors, torch.float32)
    got = XP_BWD[kind][2](*tensors, outs, cseq,
        *(torch.from_numpy(c) for c in cot), torch.float32)
    args = [jnp.asarray(arrays[0]).astype(JD[seq])] + [
        jnp.asarray(a) for a in arrays[1:]]
    _, vjp = jax.vjp(lambda *a: jax_lstm.lstm_scan_reference(*a,
        jnp.float32), *args)
    want = vjp(tuple(jnp.asarray(c) for c in cot))
    assert_xp_grads(got, want, seq, f'{kind} B={B} x_proj {seq}')


# mode XP's forward with its cell sequence: the JAX Pallas forward, and
# the port's plain forward
XP_FWD = {
    'scan': (lambda *a: jax_lstm._lstm_fwd_impl(*a, with_cseq=True),
        lstm_scan.lstm_scan_reference),
    'tm': (jax_lstm_tm._fwd_impl_tm, lstm_tm.lstm_tm_reference),
}


@pytest.mark.parametrize('seq', ['float32', 'bfloat16'])
@pytest.mark.parametrize('kind', sorted(XP_FWD))
def test_xp_f32_forward_matches_jax_fwd(kind, seq):
    """lstm_scan's and tm's plain f32 forwards (what their kernels, mode
    XP's forward on csrc/lstm_f32.cuh, are held to on the card) against
    the JAX forward with its cell sequence, `_lstm_fwd_impl` /
    `_fwd_impl_tm`, its Pallas kernel in interpret mode, x_proj in f32 and
    in bf16 under f32 compute, at T 5, B 16, H 32: outs, hT, cT and cseq
    within 1e-5 of max(1, max |reference|) (the same f32 products summed
    in another order)."""
    T, B, H = 5, 16, 32
    arrays, _, tensors = xp_bwd_case(37, seq, T, B, H)
    jax_fwd, plain = XP_FWD[kind]
    args = [jnp.asarray(arrays[0]).astype(JD[seq])] + [
        jnp.asarray(a) for a in arrays[1:]]
    with pltpu.force_tpu_interpret_mode():
        want = jax_fwd(*args, jnp.float32)
    got = plain(*tensors, torch.float32)
    assert len(got) == len(want) == 4
    for name, a, w in zip(('outs', 'hT', 'cT', 'cseq'), got, want):
        assert a.dtype == torch.float32 and tuple(a.shape) == tuple(w.shape)
        assert_close(a, w, 1e-5, True, f'{kind} x_proj {seq} {name}')


@pytest.mark.parametrize('seq', ['float32', 'bfloat16'])
@pytest.mark.parametrize('T,B,H', [(5, 10, 32), (3, 16, 64)])
def test_tm_f32_backward_is_scan_f32_backward(T, B, H, seq):
    """The plain f32 backwards of tm and lstm_scan on the same inputs,
    residuals and cotangents: every gradient equal bit for bit, as their
    kernels' are on the card (tm runs lstm_scan's f32 backward one step a
    launch)."""
    _, cot, tensors = xp_bwd_case(35, seq, T, B, H)
    outs, _, _, cseq = lstm_scan.lstm_scan_reference(*tensors, torch.float32)
    rest = (outs, cseq, *(torch.from_numpy(c) for c in cot), torch.float32)
    tm = lstm_tm.lstm_tm_backward_reference(*tensors, *rest)
    scan = lstm_scan.lstm_scan_backward_reference(*tensors, *rest)
    for name, a, w in zip(TM_GRADS, tm, scan):
        assert a.dtype == w.dtype and torch.equal(a, w), name
