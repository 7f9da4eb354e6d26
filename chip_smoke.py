"""Chip smoke test of pufferlib_tpu_torch on one NVIDIA GPU (sm_90a).

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout, holds each
against its plain PyTorch version at the trainer's shapes, times both
beside the least time the card could take, and drives the port's main
paths: the fused PPO trainer on Ocean `squared` with the `Default` MLP at
8192 lanes (GAE kernel), the same trainer with the fused MLP head kernel
(`Default(use_kernel=True)`), the recurrent trainer through the enc5 and
through the cat LSTM kernels, the recurrent trainer through LSTMWrapper's
default route at input width 96 (enc5's kernels), with two LSTM layers
(cat's: enc5 cannot fuse the encoder), at hidden size 256 with
use_kernel=False (the plain scan, which the caller must ask for), at
hidden 256 by default and with use_kernel=True (enc5's streamed design),
and at hidden 200 by default (the same, its hidden size padded to 224),
and the LSTM validation path
(tools/validate_lstm_torch.py: lstm_scan and lstm_scan_fused timed at
the bench shapes, then a 40-epoch learning proof that must reach score
0.9; tools/kernel_lab_torch.py over every variant, the archived enc2,
enc3, enc4, enc6 and tm among them). Last, small trainer updates and
12 steps of every Ocean env on the card are held against the same on the
CPU (the recurrent update also at hidden 256, through enc5's streamed
design). For the bf16
tensor-core kernels of lstm_scan, lstm_scan_cat, lstm_scan_fused, the
enc5 pair and the archived enc2, enc3, enc4 and enc6 backwards
(csrc/lstm_tc.cuh) it also prints each kernel's registers and spilled bytes after the build,
and the time of each phase at the main shape (pre-pass, loop, dx, dW +
db; enc5's encoder runs in both pre-pass phases, dpre takes dx's place
and dW_enc joins the last, and the archived backwards have enc5's
backward phases; lstm_scan's forward is its loop alone, its backward
loop and dW); cat,
fused and enc5 are also held to their plain versions at input width 96
(enc5 with 200 features), and the bf16 kernels of every pair whose
backward runs the split-K of csrc/lstm_common.cuh (enc5, scan, fused,
cat, enc and the archived enc2-enc6) run twice and must agree bit for
bit; the archived enc6's bf16 outputs and gradients must equal enc5's bit
for bit (its backward is enc5's tensor-core backward). GAE must equal its plain version bit for bit. The MLP head is held
to its plain version in bf16 (the tensor-core kernel, at the trainer's
two shapes, at F = 200 with H = 256 and 512 and O = 17, and with f32 x)
and in f32 (the FMA kernel); its bf16 kernel runs twice and must agree
bit for bit, and is timed beside cuBLAS's three-call bf16 composition.
Both MLP trainers run a warm-up epoch, three timed ones and the
rollout/update split.

The Ocean phase: the MLP head is also held to its plain version at the
Ocean envs' shapes (F = 1, 5 and 30 features; O = 3, 5 and 11 outputs;
B = 128 to 4096 rows) and enc5 at F = 1 (memory's one feature; hidden
128 at T = 8, hidden 64 at T = 4), and the Performance envs' burn kernel
(csrc/ocean_burn.cu, not a TPU kernel) against its plain version. Then
the fused trainer runs each of the ten Ocean envs at its config.yaml
section (Default hidden 128 in bf16; memory through LSTMWrapper's default
route, enc5), a warm-up epoch and two timed ones, and bandit, password and
spaces again with the fused MLP head; 12 steps of every env on the card
must equal the CPU exactly; and two learning proofs at the JAX package's
own test settings must pass: memory (best score > 0.9 within 60 epochs,
through enc5) and spaces (score > 0.8 after 40 epochs).

The pixel-env phase (since the conv policies and the host path): the
streamed design, csrc/lstm_cat_stream.cu (for the shapes the resident
kernels refuse: at few batch rows one persistent launch whose blocks hold
slices of W_hh in shared memory, the input products as GEMMs outside it;
at many rows blocks that own whole row tiles and stream the weights from
L2), cat's pair against its plain version in f32 and bf16 at the
Atari update's (T 16, B 256, D = H = 512) and three more shapes, timed
beside its bound and cuDNN's nn.LSTM, two runs bit-equal, and the kernels
a call launches counted at T = 16, 32 and 64 (the same; the backward
takes the gates its forward kept); enc5's pair against
lstm_enc_reference / lstm_enc_backward_reference at hidden 256, 200 and
512, at f32's encoder width 96, bf16's 800 features and minigrid's 147 in
f32, likewise timed and bit-equal, its kernels a call counted on both
schedules, and a line of every streamed shape's plain / kernel time; the
largest hidden size the streamed loops take held to its Python copy;
the route that sends Convolutional + LSTM(512) to it; the host trainer's
flat GAE through the GAE kernel at N = 16384 and 4096, bit-equal; the
native envpool driver built with g++. Then three trainers at full width:
the Atari configuration (fake ALE frames of 4x84x84 uint8 behind the
port's Atari wrappers in HostMultiprocessing with the native driver,
ppo_host with cpu_offload, Convolutional + LSTM 512 in f32; 16 launches
of each streamed cat function an epoch asserted; one more update under
the profiler for its kernel time), ProcgenResnet(16, 256)
through ppo_host on a fake procgen env, and Convolutional on VisualTarget
through the device trainer, whose tail score must reach 0.6 in 131072
steps, then two epochs of it in bf16 inside LSTMWrapper(128, 128) (the
resident cat); no phase imports gymnasium. The spawned envpool workers
import this script as their main module: its top level imports no torch.

The CLI phase (phase 17): the port's entry point, demo_torch.main,
trains config.yaml's squared and memory sections for 3 epochs each on the
card (GAE once an epoch; enc5's pair 16 times an epoch each way in
memory, f32, as config.yaml names no dtype: that shape is held to its
plain version first), runs --mode autotune over 8192 and 32768 lanes,
then bench_torch.py in a child process at 10 epochs, whose JSON lines it
prints as they came.

The data-parallel phase (phase 18): ppo.create(..., mesh=) on the
card. A world-size-1 NCCL mesh, joined in this process through a file
store, trains bench.py's MLP (fused head) and LSTM (enc5) lines and the
layouts that gather the batch, in bf16 and f32, each against the same
trainer with no mesh (losses, launches, steps/s); then two spawned gloo
ranks share the card (NCCL takes one rank a device) and hold their
losses and launches to that. Tensor parallelism and the scaling lines
need two or more cards and are held on the CPU only.

The transformer and self-play phase (phase 19): TransformerWrapper
at the bench line's width (hidden 128, window 16, 4 heads, B 8192), its
stepwise calls against one 16-step and one 20-step segment (past the
window) in f32 (within 1e-5) and bf16 (XF_TOL), and on the card against
the CPU at a small size; bench_torch.py's transformer line (8192 lanes x
64, bf16) for 2 epochs after a warm-up, GAE counted once an epoch and
nothing else launched (the attention is plain torch, as the JAX
package's is XLA), its rollout and update under the profiler; the
memory learning proof of tests/test_transformer.py (best score > 0.9
within 60 epochs); PolicyPool on the card (forced heads routed by the
cycle map, a TransformerPolicy pool against each policy alone); and
examples/selfplay_torch.py.

The zoo and frameworks phase (phase 20, last): cat's streamed pair
against its plain version in f32 at the zoo updates' shapes (T 16; B 512
and D = H = 256, B 1024 and 256, B 512 and 512), timed beside its bound,
the plain version and cuDNN's nn.LSTM; config.yaml's nethack section at
full width (nethack.Policy h256 + LSTM 256, 128 fake NLE envs through
the binding's own wrappers in HostMultiprocessing, ppo_host) for 2
counted epochs after a warm-up, launches asserted (cat's pair 16 times
an epoch, GAE once, nothing else), peak memory; one counted epoch each
of nmmo, nmmo3 and pokemon_red on their fakes (ZOO_OTHERS names the
cuts); a reference LSTMWrapper(Default) checkpoint (h128 on squared,
the reference's key layout, from a seed) through torch_import.convert,
held through enc5 and the plain scan to nn.Linear + nn.LSTM + split
heads on (8192, 16) segments, forward and gradients; demo_torch.py
--mode eval playing it. stable_baselines3 and ray are not installed on
the card's machine: their bridges are held on the CPU only.

Prints one line per phase, a `{"profiler_lost": [...]}` JSON line naming
the kernels whose second, profiler reading was lost (their device_ms is
null), a `{"kernels": [...]}` JSON line, the card's name and power
limit, and last `{"ok": true, "device": {...}}`. Any failing phase raises
and the script exits non-zero without that line.
It exits non-zero at once when no CUDA device is present. It imports
nothing of JAX.
"""
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))


# The host envpool's workers are spawned, and each imports this script as
# its main module: its top level stays free of torch, so the timing
# helpers (ops/cuda/timing.py, whose package imports torch) are reached
# through these.
def card_line():
    from pufferlib_tpu_torch.ops.cuda import timing
    return timing.card_line()


def l2_flush_buffer():
    from pufferlib_tpu_torch.ops.cuda import timing
    return timing.l2_flush_buffer()


# the kernels whose profiler reading was lost, named on a line of their own
PROFILER_LOST = []


def profiled_ms(fn, flush, name):
    """timing.profiled_ms, or None where the profiler lost the kernels'
    records in every window (CUPTI on the card's machine drops some): the
    profiler's time is a second reading beside the events' and decides
    nothing, but a lost one is logged and named on a line of its own."""
    from pufferlib_tpu_torch.ops.cuda import timing
    try:
        return timing.profiled_ms(fn, flush, name)
    except RuntimeError as e:
        log(f'profiler reading lost: {e}')
        PROFILER_LOST.append(name)
        return None


def fmt_ms(v):
    return 'not measured' if v is None else f'{v:.4f}'


def timed_ms(*args, **kwargs):
    from pufferlib_tpu_torch.ops.cuda import timing
    return timing.timed_ms(*args, **kwargs)

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM rate, bf16
# tensor-core rate, float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {'bfloat16': 989e12, 'float32': 67e12}

MLP_TOL = {
    # f32: the same products summed in another order (outputs of order 10)
    'float32': 1e-4,
    # bf16: a hidden unit whose f32 sum sits within an ulp of a bf16
    # rounding boundary may round the other way: one bf16 ulp (2^-8
    # relative) of that unit times its head weight
    'bfloat16': 2e-2,
}


def log(msg):
    print(msg, flush=True)


def bound(bytes_moved, flops, dtype_name):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def check_gae(torch, gae, flush, rng, T, E):
    """The GAE kernel against its plain version: equal bit for bit (every
    product and sum rounded on its own, in the plain version's order),
    then both timed beside the bound."""
    import numpy as np
    rewards = torch.from_numpy(rng.uniform(-1, 1, (T, E)).astype(
        np.float32)).cuda()
    values = torch.from_numpy(rng.randn(T, E).astype(np.float32)).cuda()
    dones = torch.from_numpy((rng.rand(T, E) < 0.3).astype(
        np.float32)).cuda()
    last_value = torch.from_numpy(rng.randn(E).astype(np.float32)).cuda()
    args = (rewards, values, dones, last_value, 0.99, 0.95)
    got = gae.compute_gae_cuda(*args)
    want = gae.compute_gae(*args)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if not (torch.isfinite(got).all() and torch.equal(got, want)):
        raise AssertionError(f'GAE ({T}, {E}): differs from the plain '
            f'version (max abs err {err})')
    ms = timed_ms(lambda: gae.compute_gae_cuda(*args), flush)
    device_ms = profiled_ms(lambda: gae.compute_gae_cuda(*args), flush,
        'gae_kernel')
    plain_ms = timed_ms(lambda: gae.compute_gae(*args), flush, reps=5)
    bytes_moved = (4 * T * E + E) * 4
    flops = 9 * T * E
    bound_ms, bound_by = bound(bytes_moved, flops, 'float32')
    log(f'gae ({T}, {E}) f32: equal to the plain version bit for bit; '
        f'kernel {ms:.4f} ms (profiler: {fmt_ms(device_ms)}), plain '
        f'{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) on '
        f'{card_line()}')
    return dict(err=err, ms=ms, device_ms=device_ms, plain_ms=plain_ms,
        bound_ms=bound_ms,
        bound_by=bound_by, shape=f'({T}, {E}) float32')


def mlp_case(torch, rng, B, F, H, O, x_dtype):
    """x dense normal in x_dtype (the trainer stores obs in the compute
    dtype; denser than squared's grid, so every sum has terms to round),
    weights scaled as the trainer's init."""
    import numpy as np
    x = torch.from_numpy(rng.randn(B, F).astype(np.float32)).cuda().to(
        x_dtype)
    w1 = torch.from_numpy((rng.randn(F, H) * np.sqrt(2 / F)).astype(
        np.float32)).cuda()
    b1 = torch.from_numpy((rng.randn(H) * 0.1).astype(np.float32)).cuda()
    w2 = torch.from_numpy((rng.randn(H, O) / np.sqrt(H)).astype(
        np.float32)).cuda()
    b2 = torch.from_numpy((rng.randn(O) * 0.1).astype(np.float32)).cuda()
    return x, w1, b1, w2, b2


def cublas_mlp_ms(torch, flush, x, w1, b1, w2, b2):
    """The bf16 composition the fused head stands in for, on cuBLAS:
    addmm, relu (the hidden layer already rounded to bf16), addmm. Three
    calls, so context for the kernel's time, not a single-call yardstick;
    the port never calls it. Weights converted before the timing."""
    bf16 = torch.bfloat16
    w1c, b1c, w2c, b2c = (t.to(bf16) for t in (w1, b1, w2, b2))
    xc = x.to(bf16)
    with torch.no_grad():
        return timed_ms(lambda: torch.addmm(b2c, torch.relu(
            torch.addmm(b1c, xc, w1c)), w2c), flush)


def check_mlp(torch, mlp, flush, rng, B, dtype_name, F=49, H=128, O=9,
        x_dtype_name=None):
    """The MLP head kernel of compute dtype dtype_name against its plain
    version on x of x_dtype_name (the compute dtype when None), within
    MLP_TOL; the kernel, the plain version and (bf16) cuBLAS's
    composition timed beside the bound. In bf16 the configuration the C
    side picks must be mlp.tc_config's."""
    cdt = getattr(torch, dtype_name)
    x_dtype = getattr(torch, x_dtype_name or dtype_name)
    x, w1, b1, w2, b2 = mlp_case(torch, rng, B, F, H, O, x_dtype)
    args = (x, w1, b1, w2, b2, cdt)
    before = mlp.KERNEL.launches
    with torch.no_grad():
        got = mlp.mlp_head(*args)
        want = mlp.mlp_head_reference(*args)
    torch.cuda.synchronize()
    what = f'B={B} F={F} H={H} O={O} {dtype_name}' + (
        f' x {x_dtype_name}' if x_dtype_name else '')
    if mlp.KERNEL.launches != before + 1:
        raise AssertionError(f'MLP head {what}: no launch counted')
    err = (got - want).abs().max().item()
    tol = MLP_TOL[dtype_name]
    if not (torch.isfinite(got).all() and err <= tol):
        raise AssertionError(f'MLP head {what}: max abs err {err} > {tol}')
    kernel = 'FMA'
    if cdt == torch.bfloat16:
        config = mlp.KERNEL.lib().mlp_head_tc_config(F, H, O,
            int(x_dtype == torch.bfloat16))
        if config != mlp.tc_config(F, H, O, x_dtype):
            raise AssertionError(f'MLP head {what}: the C side takes '
                f'configuration {config}, mlp.tc_config says '
                f'{mlp.tc_config(F, H, O, x_dtype)}')
        kernel = (f'tensor cores, configuration {config} '
            f'{mlp.TC_CONFIGS[config]}')
    with torch.no_grad():
        ms = timed_ms(lambda: mlp.mlp_head(*args), flush)
        device_ms = profiled_ms(lambda: mlp.mlp_head(*args), flush,
            'mlp_head')
        plain_ms = timed_ms(lambda: mlp.mlp_head_reference(*args), flush,
            reps=5)
    cublas_ms = cublas_mlp_ms(torch, flush, *args[:5]) \
        if cdt == torch.bfloat16 else None
    bytes_moved = (B * F * x.element_size() + 4 * (F * H + H + H * O + O)
        + 4 * B * O)
    flops = 2 * B * (F * H + H * O)
    bound_ms, bound_by = bound(bytes_moved, flops, dtype_name)
    log(f'mlp_head {what} ({kernel}): max abs err {err:.3g} (tol {tol}); '
        f'kernel {ms:.4f} ms (profiler: {fmt_ms(device_ms)}), plain '
        f'{plain_ms:.4f} ms, cuBLAS bf16 '
        f'addmm-relu-addmm {cublas_ms if cublas_ms is None else round(cublas_ms, 4)} '
        f'ms, bound {bound_ms:.4f} ms ({bound_by}) on {card_line()}')
    return dict(err=err, ms=ms, device_ms=device_ms, plain_ms=plain_ms,
        cublas_ms=cublas_ms,
        bound_ms=bound_ms, bound_by=bound_by,
        shape=f'({B}, {F}) {x_dtype_name or dtype_name}, H={H}, O={O}')


def check_mlp_bit_equal(torch, mlp, rng, B=131072, F=49, H=128, O=9):
    """The bf16 kernel twice on the same inputs: equal bit for bit (sums
    in a fixed order, no atomics)."""
    args = mlp_case(torch, rng, B, F, H, O, torch.bfloat16)
    with torch.no_grad():
        runs = [mlp.mlp_head(*args, torch.bfloat16) for _ in range(2)]
    torch.cuda.synchronize()
    if not torch.equal(*runs):
        raise AssertionError(f'MLP head bf16 B={B}: two runs differ')
    log(f'mlp_head bf16 B={B} F={F} H={H} O={O}: two runs equal bit for bit')


# |kernel - plain| <= tol * max(1, max |plain|), per output and gradient.
# f32: the same f32 products summed in another order (measured near 1e-6
# of the scale at the bench shapes). bf16: h, c, the activations and
# dgates round to bf16 inside the recurrence, so a sum that lands on the
# other side of a rounding boundary rounds one ulp (2^-8) the other way
# and carries on; 2e-2 is five ulps of the largest value.
LSTM_TOL = {'float32': 1e-5, 'bfloat16': 2e-2}
LSTM_OUTS = ('outs', 'hT', 'cT', 'cseq')
ENC_GRADS = ('dh0', 'dc0', 'dw_enc', 'db_enc', 'dw_ih', 'dw_hh', 'db')
CELL_GRADS = ('dx', 'dh0', 'dc0', 'dw_ih', 'dw_hh', 'db')


def lstm_kinds():
    """kind -> (kernel forward, kernel backward, plain forward, plain
    backward, gradient names). 'enc' is lstm_scan_enc: enc5's forward
    kernel with the step-by-step backward; enc3, enc4 and enc6 have that
    forward too, under their own backwards."""
    import importlib
    from pufferlib_tpu_torch.ops.cuda import lstm_cat, lstm_enc, lstm_scan
    from pufferlib_tpu_torch.ops.cuda.archive import lstm_tm
    scan_grads = ('dx_proj', 'dh0', 'dc0', 'dw_hh')
    archived = {}
    for kind in ARCHIVED_ENC_KINDS:
        v = importlib.import_module(
            f'pufferlib_tpu_torch.ops.cuda.archive.lstm_{kind}').VARIANT
        archived[kind] = (v.forward_launch, v.backward_launch,
            v.forward_plain, v.backward_plain, ENC_GRADS)
    return {
        **archived,
        'tm': (lstm_tm._launch_forward, lstm_tm._launch_backward,
            lstm_tm.lstm_tm_reference, lstm_tm.lstm_tm_backward_reference,
            scan_grads),
        'enc5': (lstm_enc._launch_forward, lstm_enc._launch_backward,
            lstm_enc.lstm_enc_reference,
            lstm_enc.lstm_enc_backward_reference, ENC_GRADS),
        'enc': (lstm_enc._launch_enc_forward, lstm_enc._launch_step_backward,
            lstm_enc.lstm_enc_reference,
            lstm_enc.lstm_scan_enc_backward_reference, ENC_GRADS),
        'cat': (lstm_cat._launch_forward, lstm_cat._launch_backward,
            lstm_cat.lstm_cat_reference,
            lstm_cat.lstm_cat_backward_reference, CELL_GRADS),
        'enc5_stream': (*lstm_cat.kept_gates(
            lstm_enc._launch_stream_forward, lstm_enc._launch_stream_backward),
            lstm_enc.lstm_enc_reference,
            lstm_enc.lstm_enc_backward_reference, ENC_GRADS),
        'cat_stream': (*lstm_cat.kept_gates(
            lstm_cat._launch_stream_forward, lstm_cat._launch_stream_backward),
            lstm_cat.lstm_cat_reference,
            lstm_cat.lstm_cat_backward_reference, CELL_GRADS),
        'fused': (lstm_scan._launch_fused_forward,
            lstm_scan._launch_fused_backward,
            lstm_scan.lstm_scan_fused_reference,
            lstm_scan.lstm_scan_fused_backward_reference, CELL_GRADS),
        'scan': (lstm_scan._launch_scan_forward,
            lstm_scan._launch_scan_backward, lstm_scan.lstm_scan_reference,
            lstm_scan.lstm_scan_backward_reference, scan_grads),
    }


ARCHIVED_ENC_KINDS = ('enc2', 'enc3', 'enc4', 'enc6')
# kinds that take feats behind the fused encoder; kinds that take x_proj
ENC_KINDS = ('enc5', 'enc', 'enc5_stream') + ARCHIVED_ENC_KINDS
# kinds whose backward takes the gates their forward kept
STREAM_KINDS = ('cat_stream', 'enc5_stream')
XP_KINDS = ('scan', 'tm')
# kinds whose forward takes save_cseq: without it the kernel is handed a
# null cseq and must give the same outs, hT and cT bit for bit
PRIMAL_KINDS = ('enc', 'fused', 'scan') + ARCHIVED_ENC_KINDS


def lstm_case(torch, rng, kind, T, B, dtype_name, F=49, H=128,
        xp_dtype_name=None, D=None):
    """Inputs at the trainer's shapes: (forward args, upstream gradients,
    cdt). Dense normal features and inputs, weights scaled as the
    trainer's orthogonal init. scan's and tm's x_proj is in xp_dtype_name
    (the compute dtype when None); cat's and fused's input width and the
    encoder width of the encoder-fused kinds is D (H when None)."""
    import numpy as np
    cdt = getattr(torch, dtype_name)
    D = D or H

    def arr(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(
            np.float32)).cuda()
    state = (arr(B, H, scale=0.5), arr(B, H, scale=0.5))
    weights = (arr(D, 4 * H, scale=D ** -0.5), arr(H, 4 * H, scale=H ** -0.5),
        arr(4 * H, scale=0.1))
    if kind in ENC_KINDS:
        args = (arr(T, B, F).to(cdt), *state, arr(F, D, scale=(2 / F) ** 0.5),
            arr(D, scale=0.1), *weights)
    elif kind in XP_KINDS:
        xp_dtype = getattr(torch, xp_dtype_name or dtype_name)
        args = (arr(T, B, 4 * H).to(xp_dtype), *state, weights[1])
    else:
        args = (arr(T, B, D, scale=0.5).to(cdt), *state, *weights)
    grads = (arr(T, B, H).to(cdt), arr(B, H), arr(B, H))
    return args, grads, cdt


def lstm_bounds(kind, args, T, B, H, dtype_name):
    """(forward, backward) bounds from this call's inputs: every input
    read once and every output written once, and the flops of the
    function, at the peak of the compute type. The bound is the
    function's, whatever the schedule: enc2, enc3, enc4 and enc6 have
    enc5's, tm has scan's. The streamed kinds' forward also writes every
    step's f32 gates, and their backward takes them as an input in place
    of recomputing them: it reads them and skips the gate product."""
    x = args[0]
    x_bytes = x.numel() * x.element_size()
    weights = sum(t.numel() for t in args[3:]) * 4
    state = 2 * B * H * 4
    seq = T * B * H * (2 if dtype_name == 'bfloat16' else 4)
    # in: the sequence, weights, h0/c0; out: outs, cseq, hT/cT
    fwd_bytes = x_bytes + weights + state + 2 * seq + state
    # in: the sequence, weights, h0/c0, outs, cseq, g_outs, g_hT/g_cT;
    # out: dh0/dc0 and the weight gradients
    bwd_bytes = x_bytes + weights + state + 3 * seq + state + state + weights
    # the gate recompute, the backward's share of the flops the streamed
    # kinds skip
    if kind in ENC_KINDS:
        F, D = args[3].shape
        recompute = 2 * T * B * (D + H) * 4 * H
        fwd_flops = 2 * T * B * (F * D + (D + H) * 4 * H)
        # the encoder recompute, the gates', [dx | dh_prev], dW and dW_enc
        bwd_flops = 2 * T * B * (2 * F * D + 2 * (D + H) * 4 * H
            + 4 * H * H + 4 * H * D)
    elif kind in XP_KINDS:
        # the recurrent product alone; backward: the gate recompute,
        # dh_prev and dW_hh, and dx_proj written
        fwd_flops = 2 * T * B * H * 4 * H
        recompute = fwd_flops
        bwd_flops = 3 * fwd_flops
        bwd_bytes += x_bytes
    else:
        D = x.shape[2]
        fwd_flops = 2 * T * B * (D + H) * 4 * H
        recompute = fwd_flops
        bwd_flops = 3 * fwd_flops
        bwd_bytes += x_bytes  # dx written
    if kind in STREAM_KINDS:
        gates = T * B * 4 * H * 4
        fwd_bytes += gates
        bwd_bytes += gates
        bwd_flops -= recompute
    return (bound(fwd_bytes, fwd_flops, dtype_name),
        bound(bwd_bytes, bwd_flops, dtype_name))


def check_lstm(torch, flush, rng, kind, B, dtype_name, T=16, H=128,
        timed=False, xp_dtype_name=None, D=None, F=49):
    """The LSTM kernel pair `kind` against its plain versions on the same
    inputs: every output and gradient within LSTM_TOL. With timed: the
    kernels', the plain versions' and (cat, fused) cuDNN's times and the
    bounds, beside the card's name and power limit."""
    fwd, bwd, fwd_plain, bwd_plain, grad_names = lstm_kinds()[kind]
    args, grads, cdt = lstm_case(torch, rng, kind, T, B, dtype_name, F=F,
        H=H, xp_dtype_name=xp_dtype_name, D=D)
    with torch.no_grad():
        got = fwd(*args, cdt)
        want = fwd_plain(*args, cdt)
        bargs = (*args, want[0], want[3], *grads, cdt)
        got_b = bwd(*bargs)
        want_b = bwd_plain(*bargs)
        primal = fwd(*args, cdt, False) if kind in PRIMAL_KINDS else None
    torch.cuda.synchronize()
    what = f'{kind} T={T} B={B}' + (f' D={D}' if D else '') + (
        f' F={F}' if kind in ENC_KINDS else '') + f' {dtype_name}' + (
        f' x_proj {xp_dtype_name}' if xp_dtype_name else '')
    if primal is not None:
        if primal[3] is not None or not all(torch.equal(a, w)
                for a, w in zip(primal[:3], got[:3])):
            raise AssertionError(f'{what}: the forward without cseq differs '
                'from the one that saves it')
    tol = LSTM_TOL['bfloat16' if 'bfloat16' in (dtype_name, xp_dtype_name)
        else 'float32']
    errs = {}
    for name, a, w in zip(LSTM_OUTS + grad_names, got + got_b,
            want + want_b):
        if a.dtype != w.dtype or a.shape != w.shape:
            raise AssertionError(f'{what} {name}: {a.dtype} {tuple(a.shape)} '
                f'against {w.dtype} {tuple(w.shape)}')
        err = (a.float() - w.float()).abs().max().item()
        scale = max(1.0, w.float().abs().max().item())
        if not (torch.isfinite(a).all() and err <= tol * scale):
            raise AssertionError(f'{what} {name}: max abs err {err} > {tol} '
                f'x {scale:.4g}')
        errs[name] = (err, tol * scale)
    log(f'lstm {what}, max abs err (tol): ' + ', '.join(
        f'{k} {e:.3g} ({t:.3g})' for k, (e, t) in errs.items()) + (
        '; forward without cseq equal bit for bit' if primal else ''))
    result = dict(fwd_err=max(errs[k][0] for k in LSTM_OUTS),
        bwd_err=max(errs[k][0] for k in grad_names),
        shape=f'T={T} B={B} D={D or H} H={H}' + (f' F={F}' if kind in
            ENC_KINDS else '') + f' {dtype_name}')
    if not timed:
        return result
    with torch.no_grad():
        result['fwd_ms'] = timed_ms(lambda: fwd(*args, cdt), flush)
        result['bwd_ms'] = timed_ms(lambda: bwd(*bargs), flush)
        result['fwd_plain_ms'] = timed_ms(lambda: fwd_plain(*args, cdt),
            flush, reps=5)
        result['bwd_plain_ms'] = timed_ms(lambda: bwd_plain(*bargs), flush,
            reps=5)
    (result['fwd_bound'], result['fwd_by']), (result['bwd_bound'],
        result['bwd_by']) = lstm_bounds(kind, args, T, B, H, dtype_name)
    # cuDNN's LSTM takes x, W_ih, W_hh and b: the cat and fused kernels'
    # function. No single PyTorch call fuses the encoder in, or takes the
    # projection x_proj as its input
    result['fwd_lib'] = result['bwd_lib'] = None
    if kind in ('cat', 'cat_stream', 'fused'):
        result['fwd_lib'], result['bwd_lib'] = cudnn_lstm_ms(torch, flush,
            args, grads[0])
    log(f'lstm {what}: forward {result["fwd_ms"]:.4f}'
        f' ms (plain {result["fwd_plain_ms"]:.4f}, bound '
        f'{result["fwd_bound"]:.4f} {result["fwd_by"]}, library '
        f'{result["fwd_lib"]}); backward {result["bwd_ms"]:.4f} ms (plain '
        f'{result["bwd_plain_ms"]:.4f}, bound {result["bwd_bound"]:.4f} '
        f'{result["bwd_by"]}, library {result["bwd_lib"]}) on {card_line()}')
    return result


# the bf16 kernels of lstm_scan_fused and lstm_scan_cat (csrc/lstm_tc.cuh),
# in the order of lstm_fused_tc_usage's and lstm_cat_tc_usage's output;
# enc5's, in the order of lstm_enc_tc_usage's
TC_KERNELS = ('forward pre-pass', 'forward loop', 'backward pre-pass',
    'backward loop', 'dx')
ENC5_TC_KERNELS = ('encoder', 'forward pre-pass', 'forward loop',
    'backward pre-pass', 'backward loop', 'dpre')
# lstm_scan's (mode XP), in the order of lstm_scan_tc_usage's output
SCAN_TC_KERNELS = ('forward loop (bf16 x_proj)', 'forward loop (f32 x_proj)',
    'backward loop (bf16 x_proj)', 'backward loop (f32 x_proj)',
    'dW split-K (ring)')
# the archived backwards' own, in the order of lstm_archive_tc_usage's
# output (their encoder, dpre and split-K, the other pre-pass and enc6's
# loop are enc5's)
ARCHIVE_TC_KERNELS = ('enc2 backward pre-pass',
    'enc2 / enc4 backward loop (f32 activations)',
    'enc3 backward loop (db from the unrounded dgates)')
# the phases a launch with phases=k runs the first k of
TC_PHASES = {
    'forward': ('pre-pass', 'loop'),
    'backward': ('pre-pass', 'loop', 'dx', 'dW + db'),
}
ENC5_PHASES = {
    'forward': ('encoder + pre-pass', 'loop'),
    'backward': ('encoder + pre-pass', 'loop', 'dpre', 'dW + db + dW_enc'),
}
# lstm_scan's: no pre-pass (the loops read x_proj, the reverse one
# recomputes the gates), no dx
SCAN_PHASES = {
    'forward': ('loop',),
    'backward': ('loop', 'dW'),
}
# the archived bf16 backwards, enc5's phases (their forwards take no
# phases: enc2's runs on FMA, enc3's, enc4's and enc6's is enc5's)
ARCHIVE_PHASES = {'forward': (), 'backward': ENC5_PHASES['backward']}
PHASES = {'enc5': ENC5_PHASES, 'scan': SCAN_PHASES, 'enc2': ARCHIVE_PHASES,
    'enc3': ARCHIVE_PHASES, 'enc4': ARCHIVE_PHASES, 'enc6': ARCHIVE_PHASES}


def log_tc_usage():
    """Registers and spilled bytes per thread of the bf16 kernels of
    lstm_scan, lstm_scan_fused, lstm_scan_cat, enc5 and the archived enc2,
    enc3, enc4 and enc6 backwards at each hidden size
    (cudaFuncGetAttributes), and the widest input and feature width they
    take, held against the wrappers' checks."""
    import ctypes
    from pufferlib_tpu_torch.ops.cuda import (
        archive, lstm_cat, lstm_enc, lstm_scan)
    from pufferlib_tpu_torch.ops.cuda.lstm_common import (
        tc_max_features, tc_max_input)
    for kind, kernel, fn, names in (
            ('lstm_scan', lstm_scan.KERNEL, 'lstm_scan_tc_usage',
                SCAN_TC_KERNELS),
            ('lstm_scan_fused', lstm_scan.KERNEL, 'lstm_fused_tc_usage',
                TC_KERNELS),
            ('lstm_scan_cat', lstm_cat.KERNEL, 'lstm_cat_tc_usage',
                TC_KERNELS),
            ('enc5', lstm_enc.KERNEL, 'lstm_enc_tc_usage', ENC5_TC_KERNELS),
            ('archive', archive.KERNEL, 'lstm_archive_tc_usage',
                ARCHIVE_TC_KERNELS)):
        for H in (32, 64, 128):
            out = (ctypes.c_int * (2 * len(names)))()
            err = getattr(kernel.lib(), fn)(H, out)
            if err:
                raise RuntimeError(f'{fn}({H}): cudaError {err}')
            log(f'  {kind} bf16 kernels, H={H}: ' + ', '.join(
                f'{name} {out[2 * i]} registers, {out[2 * i + 1]} bytes '
                f'spilled' for i, name in enumerate(names)))
    # the widest input and feature width the checks before a launch let
    # through are the ones the C side serves (lstm_common copies its
    # constants)
    for H in (32, 64, 128):
        out = (ctypes.c_int * 1)()
        lstm_cat.KERNEL.lib().lstm_tc_max_input(H, out)
        if out[0] != tc_max_input(H):
            raise AssertionError(f'lstm_tc_max_input({H}) = {out[0]}, but '
                f'lstm_common.tc_max_input({H}) = {tc_max_input(H)}')
    out = (ctypes.c_int * 1)()
    lstm_enc.KERNEL.lib().lstm_enc_tc_max_features(out)
    if out[0] != tc_max_features():
        raise AssertionError(f'lstm_enc_tc_max_features = {out[0]}, but '
            f'lstm_common.tc_max_features() = {tc_max_features()}')
    log('  bf16 tensor-core widest input by hidden size: ' + ', '.join(
        f'H={H}: {tc_max_input(H)}' for H in (32, 64, 128))
        + f'; enc5 widest feature width {tc_max_features()} (C and Python '
        'agree)')


def time_tc_phases(torch, flush, rng, kind='fused', T=16, B=8192):
    """Device ms of each phase of the bf16 tensor-core kernels of `kind`
    ('fused': lstm_scan_fused, 'cat': lstm_scan_cat, 'enc5', 'scan':
    lstm_scan with bf16 x_proj, and the backwards of the archived 'enc2',
    'enc3', 'enc4' and 'enc6') at the main shape: a launch runs the first k phases, so a
    phase's time is the difference of two such means (cold L2 each)."""
    launch_fwd, launch_bwd = lstm_kinds()[kind][:2]
    args, grads, cdt = lstm_case(torch, rng, kind, T, B, 'bfloat16')
    names = PHASES.get(kind, TC_PHASES)
    with torch.no_grad():
        outs, _, _, cseq = launch_fwd(*args, cdt)
        bargs = (*args, outs, cseq, *grads, cdt)
        fwd = [timed_ms(lambda: launch_fwd(*args, cdt, phases=k), flush)
            for k in range(1, len(names['forward']) + 1)]
        bwd = [timed_ms(lambda: launch_bwd(*bargs, phases=k), flush)
            for k in range(1, len(names['backward']) + 1)]
    phases = {}
    for part, cumulative in (('forward', fwd), ('backward', bwd)):
        for k, name in enumerate(names[part]):
            phases[f'{part} {name}'] = cumulative[k] - (cumulative[k - 1]
                if k else 0.0)
    title = {'enc5': 'enc5', 'scan': 'lstm_scan'}.get(kind,
        f'archived {kind}' if kind in ARCHIVED_ENC_KINDS
        else f'lstm_scan_{kind}')
    log(f'{title} bf16 phases T={T} B={B} H=128, ms: ' + ', '.join(
        f'{k} {v:.4f}' for k, v in phases.items())
        + (f'; whole forward {fwd[-1]:.4f}' if fwd else '')
        + f'; whole backward {bwd[-1]:.4f} on {card_line()}')
    return phases


def check_bit_equal(torch, rng, kind, B, T=16, D=None, F=49, H=128,
        dtype_name='bfloat16'):
    """The kernels of `kind` in dtype_name twice on the same inputs: every
    output and gradient must be equal bit for bit (sums in a fixed order,
    no atomics)."""
    fwd, bwd = lstm_kinds()[kind][:2]
    args, grads, cdt = lstm_case(torch, rng, kind, T, B, dtype_name, F=F,
        H=H, D=D)
    runs = []
    with torch.no_grad():
        for _ in range(2):
            outs, hT, cT, cseq = fwd(*args, cdt)
            runs.append((outs, hT, cT, cseq) + bwd(*args, outs, cseq,
                *grads, cdt))
    torch.cuda.synchronize()
    names = LSTM_OUTS + lstm_kinds()[kind][4]
    unequal = [n for n, a, w in zip(names, *runs) if not torch.equal(a, w)]
    what = f'{kind} {dtype_name} T={T} B={B} D={D or H} H={H}' + (
        f' F={F}' if kind in ENC_KINDS else '')
    if unequal:
        raise AssertionError(f'{what}: two runs differ in {unequal}')
    log(f'{what}: two runs equal bit for bit in {len(names)} outputs and '
        f'gradients')


def check_enc6_is_enc5(torch, rng, B, T=16, F=49, H=128):
    """The archived enc6 and enc5 in bf16 on the same inputs: enc6's
    backward is enc5's tensor-core backward (mode ENC6 runs ENC5's
    reverse loop), so every output and gradient must be equal bit for
    bit."""
    kinds = lstm_kinds()
    args, grads, cdt = lstm_case(torch, rng, 'enc6', T, B, 'bfloat16', F=F,
        H=H)
    runs = []
    with torch.no_grad():
        for kind in ('enc5', 'enc6'):
            fwd, bwd = kinds[kind][:2]
            outs, hT, cT, cseq = fwd(*args, cdt)
            runs.append((outs, hT, cT, cseq) + bwd(*args, outs, cseq,
                *grads, cdt))
    torch.cuda.synchronize()
    names = LSTM_OUTS + ENC_GRADS
    unequal = [n for n, a, w in zip(names, *runs) if not torch.equal(a, w)]
    what = f'enc6 against enc5, bf16 T={T} B={B} H={H} F={F}'
    if unequal:
        raise AssertionError(f'{what}: they differ in {unequal}')
    log(f'{what}: equal bit for bit in {len(names)} outputs and gradients')


# (T, B, D, H) of cat's streamed design (csrc/lstm_cat_stream.cu): the
# Atari update (16 segments of bptt 16 in a 4096-row minibatch, hidden
# 512), hidden 256, an input width apart from the hidden size (f32's
# resident kernels refuse it), and one that is no multiple of 8 (bf16's)
CAT_STREAM_SHAPES = ((16, 256, 512, 512), (16, 256, 256, 256),
    (8, 64, 200, 128), (4, 32, 9, 64))

# (T, B, F, D, H, dtypes) of enc5's streamed design: the default route's
# hidden 256 at the 8192-lane trainer's minibatch (phase 9; the rows
# schedule), hidden 200 there (no multiple of 32: padded to 224), hidden
# 512 at the Atari update's rows (the units schedule), f32's encoder width
# 96 apart from hidden 128, bf16's 800 features past the tensor-core
# encoder's 768, and minigrid's 147 features in f32 (past the FMA
# encoder's 128)
ENC5_STREAM_SHAPES = ((16, 8192, 49, 256, 256, ('bfloat16', 'float32')),
    (16, 8192, 49, 200, 200, ('bfloat16', 'float32')),
    (16, 256, 49, 512, 512, ('float32', 'bfloat16')),
    (16, 1000, 49, 96, 128, ('float32',)),
    (16, 1000, 800, 128, 128, ('bfloat16',)),
    (16, 1000, 147, 128, 128, ('float32',)))


def kernels_per_call(fn):
    """The kernels one call of fn launches through the streamed design's
    library, by its own host count (lstm_stream_kernels)."""
    import ctypes
    from pufferlib_tpu_torch.ops.cuda.lstm_cat import STREAM_KERNEL
    out = (ctypes.c_longlong * 1)()
    lib = STREAM_KERNEL.lib()
    lib.lstm_stream_kernels(out)
    before = out[0]
    fn()
    lib.lstm_stream_kernels(out)
    return out[0] - before


def check_stream_launches(torch, rng, kind, B, D, H, F=49, dtype_name=
        'float32', steps=(16, 32, 64)):
    """The kernels one forward and one backward call of the streamed kind
    launch, at each T in steps: they must not depend on T (the loops are
    one persistent launch each; the steps are long enough that the weight
    gradients split K, and add their splits, at every one). Returns {T:
    (forward, backward)}."""
    fwd, bwd = lstm_kinds()[kind][:2]
    counts = {}
    for T in steps:
        args, grads, cdt = lstm_case(torch, rng, kind, T, B, dtype_name,
            F=F, H=H, D=D)
        with torch.no_grad():
            outs, _, _, cseq = fwd(*args, cdt)
            counts[T] = (kernels_per_call(lambda: fwd(*args, cdt)),
                kernels_per_call(lambda: bwd(*args, outs, cseq, *grads,
                    cdt)))
    if len(set(counts.values())) != 1:
        raise AssertionError(f'{kind}: kernels per call depend on T: '
            f'{counts}')
    log(f'{kind} B={B} D={D} H={H} {dtype_name}: kernels per call '
        f'(forward, backward) by T {json.dumps(counts)}')
    return counts


def check_cat_stream(torch, flush, rng):
    """cat's streamed design against its plain version, forward and
    backward, in f32 and bf16, at CAT_STREAM_SHAPES, each timed beside
    its bound, the plain version and cuDNN's nn.LSTM, and run twice (equal
    bit for bit); then the kernels a call launches at T = 16, 32 and 64 in the
    Atari update's shape. Returns ({(shape, dtype): check_lstm's result},
    kernels per call)."""
    runs = {}
    for T, B, D, H in CAT_STREAM_SHAPES:
        for dtype_name in ('float32', 'bfloat16'):
            runs[(T, B, D, H), dtype_name] = check_lstm(torch, flush, rng,
                'cat_stream', B, dtype_name, T=T, H=H, D=D, timed=True)
            check_bit_equal(torch, rng, 'cat_stream', B, T=T, D=D, H=H,
                dtype_name=dtype_name)
    per_call = {d: check_stream_launches(torch, rng, 'cat_stream', 256, 512,
        512, dtype_name=d) for d in ('float32', 'bfloat16')}
    return runs, per_call


def check_enc5_stream(torch, flush, rng, cat_runs):
    """enc5's streamed design against lstm_enc_reference and
    lstm_enc_backward_reference at ENC5_STREAM_SHAPES, each timed beside
    its bound and the plain version and run twice (equal bit for bit);
    then its kernels per call at T = 16, 32 and 64 on both schedules (B
    1024: units; 8192: rows), and a line of the plain version's time over
    the kernel's for every streamed shape, enc5's and cat's (cat_runs).
    Returns {(shape, dtype): check_lstm's result}."""
    runs = {}
    for T, B, F, D, H, dtypes in ENC5_STREAM_SHAPES:
        for dtype_name in dtypes:
            runs[(T, B, F, D, H), dtype_name] = check_lstm(torch, flush, rng,
                'enc5_stream', B, dtype_name, T=T, H=H, D=D, F=F, timed=True)
            check_bit_equal(torch, rng, 'enc5_stream', B, T=T, D=D, F=F, H=H,
                dtype_name=dtype_name)
    for B in (1024, 8192):
        check_stream_launches(torch, rng, 'enc5_stream', B, 256, 256,
            dtype_name='bfloat16')
    log('streamed LSTM design, plain / kernel time (forward, backward): ' +
        '; '.join(f'{kind} {shape} {dtype_name} '
            f'{r["fwd_plain_ms"] / r["fwd_ms"]:.3f} '
            f'{r["bwd_plain_ms"] / r["bwd_ms"]:.3f}'
            for kind, rows in (('enc5', runs), ('cat', cat_runs))
            for (shape, dtype_name), r in rows.items()))
    return runs


def cudnn_lstm_ms(torch, flush, args, g_outs):
    """torch.nn.LSTM (cuDNN) on the cat kernel's inputs, as a yardstick:
    (forward ms, backward ms). Weights w_ih.T, w_hh.T, b and a zero
    b_hh; gate order i, f, g, o is the same. The port never calls it.
    Its sequence and state stay in the input's dtype (bf16 all through),
    so its numbers differ from the kernel's; only the time is kept."""
    x, h0, c0, w_ih, w_hh, b = args
    lstm = torch.nn.LSTM(x.shape[2], h0.shape[1]).cuda().to(x.dtype)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(w_ih.t())
        lstm.weight_hh_l0.copy_(w_hh.t())
        lstm.bias_ih_l0.copy_(b)
        lstm.bias_hh_l0.zero_()
    state = (h0[None].to(x.dtype), c0[None].to(x.dtype))
    with torch.no_grad():
        fwd_ms = timed_ms(lambda: lstm(x, state), flush)
    xg = x.detach().requires_grad_()
    outs, _ = lstm(xg, state)
    inputs = [xg] + list(lstm.parameters())
    bwd_ms = timed_ms(lambda: torch.autograd.grad(outs, inputs,
        g_outs, retain_graph=True), flush)
    return fwd_ms, bwd_ms


def make_trainer(torch, num_envs=8192, horizon=64, hidden=128,
        dtype_name='bfloat16', use_kernel=False, minibatch_size=131072,
        seed=0, device='cuda', lstm_kernel=None, lstm_use_kernel=None,
        lstm_input=None, lstm_layers=1, mesh=None, transformer_window=None,
        **overrides):
    """bench.py's `_8k_lanes` configuration (bench.py:33-81), on the port;
    with lstm_kernel ('enc5', 'cat' or 'off') its LSTM line instead
    (bench.py:53-57, 66): RecurrentPolicy(LSTMWrapper(Default)) with
    hidden size `hidden`, input size lstm_input (`hidden` when None:
    Default's encoder emits it, its head reads the LSTM's `hidden`) and
    lstm_layers layers, minibatch batch_size // 4 by the caller's choice
    of minibatch_size; with transformer_window its transformer line
    (bench.py:166-220, phase 19): TransformerPolicy(TransformerWrapper(
    Default)) of `hidden`, that window, 4 heads, ffn_mult 2. mesh:
    ppo.create's (phase 18); overrides: more config fields."""
    import pufferlib_tpu_torch.vector as vector
    from pufferlib_tpu_torch.models import (
        Default, LSTMWrapper, Policy, RecurrentPolicy, TransformerPolicy,
        TransformerWrapper)
    from pufferlib_tpu_torch.ocean import env_creator
    from pufferlib_tpu_torch.training import ppo
    dtype = getattr(torch, dtype_name)
    batch_size = num_envs * horizon
    vecenv = vector.make(env_creator('squared'),
        env_kwargs=dict(distance_to_target=3, num_targets=1),
        num_envs=num_envs, device=device)
    obs_shape = vecenv.single_observation_space.shape
    lstm_input = lstm_input or hidden
    module = Default(obs_shape=obs_shape,
        action_space=vecenv.single_action_space,
        hidden_size=hidden if lstm_kernel is None else lstm_input,
        dtype=dtype, use_kernel=use_kernel,
        generator=torch.Generator().manual_seed(seed),
        decoder_input_size=hidden)
    if transformer_window is not None:
        policy = TransformerPolicy(TransformerWrapper(module,
            obs_shape=obs_shape, input_size=hidden, hidden_size=hidden,
            window=transformer_window, num_heads=4, ffn_mult=2, dtype=dtype,
            generator=torch.Generator().manual_seed(seed + 1)))
    elif lstm_kernel is None:
        policy = Policy(module)
    else:
        policy = RecurrentPolicy(LSTMWrapper(module, obs_shape=obs_shape,
            input_size=lstm_input, hidden_size=hidden, num_layers=lstm_layers,
            dtype=dtype, kernel=lstm_kernel, use_kernel=lstm_use_kernel,
            generator=torch.Generator().manual_seed(seed + 1)))
    config = ppo.default_config(
        env='squared',
        batch_size=batch_size,
        minibatch_size=minibatch_size,
        bptt_horizon=16,
        total_timesteps=batch_size * 1_000_000,
        anneal_lr=False,
        obs_store_dtype='bfloat16' if dtype_name == 'bfloat16' else None,
        verbose=False,
        data_dir=os.path.join(REPO, 'experiments', 'chip_smoke'),
        checkpoint_interval=1_000_000,
        seed=seed,
        device=device,
        **overrides,
    )
    return ppo, ppo.create(config, vecenv, policy, mesh=mesh)


# launches of each LSTM C function per epoch of the 8192-lane trainer: 4
# update epochs x 4 time-slab minibatches, one forward and one backward
# each; the rollout's T == 1 steps run the plain cell
LSTM_PER_EPOCH = 16


# launches of the MLP head kernel per epoch of the 8192-lane trainer with
# use_kernel=True: 64 rollout steps and the bootstrap value at B = 8192, 4
# update epochs x 4 minibatches at B = 131072
MLP_PER_EPOCH = 65 + 16


def run_mlp_trainer(torch, card, use_kernel, epochs=3):
    """bench.py's MLP line on the card: a warm-up epoch, then `epochs`
    calls of ppo.step with every launch count set to 0 just before and
    read just after (GAE once an epoch; the MLP head MLP_PER_EPOCH times
    with use_kernel, else never), then the synchronised rollout/update
    split of two more epochs. Returns (MLP head launches, GAE launches)."""
    from pufferlib_tpu_torch.ops.cuda import KERNELS, gae, mlp
    torch.cuda.reset_peak_memory_stats()
    ppo, data = make_trainer(torch, use_kernel=use_kernel)
    ppo.step(data)  # warm-up epoch
    torch.cuda.synchronize()
    for k in KERNELS:
        k.reset_counts()
    start = time.perf_counter()
    for _ in range(epochs):
        ppo.step(data)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    launches = (mlp.KERNEL.launches, gae.KERNEL.launches)
    want = (MLP_PER_EPOCH * epochs if use_kernel else 0, epochs)
    others = sum(k.launches for k in KERNELS) - sum(launches)
    if launches != want or others:
        raise AssertionError(f'trainer use_kernel={use_kernel}: (MLP head, '
            f'GAE) launches {launches} in {epochs} epochs, expected {want}; '
            f'{others} other launches')
    losses = check_losses(data, f'trainer use_kernel={use_kernel}')
    sps = epochs * data.config.batch_size / elapsed
    log(f'trainer 8192 lanes x 64, Default h128 bf16, use_kernel='
        f'{use_kernel}: {sps:.1f} steps/s over {epochs} epochs after a '
        f'warm-up epoch ({elapsed / epochs * 1e3:.2f} ms/epoch) on {card}; '
        f'launches an epoch: MLP head {launches[0] // epochs}, GAE '
        f'{launches[1] // epochs}; losses {json.dumps(losses)}; stats '
        f'{json.dumps(data.stats)}')
    # where the epoch goes: the rollout and the update, each synchronised
    for _ in range(2):
        ppo.evaluate(data)
        ppo.train(data)
    timers = data._timers
    log(f'trainer use_kernel={use_kernel} split, 2 epochs: rollout '
        f'{timers["evaluate"].prev * 1e3:.2f} ms, update '
        f'{timers["train"].prev * 1e3:.2f} ms (last epoch); peak memory '
        f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    del data
    return launches


def run_lstm_trainer(torch, card, kernel, epochs, warmup):
    """The LSTM trainer of bench.py's LSTM line on the card: `epochs`
    calls of ppo.step with every launch count set to 0 just before and
    read just after. Returns (ppo, data, launches by C function)."""
    from pufferlib_tpu_torch.ops.cuda import KERNELS
    ppo, data = make_trainer(torch, lstm_kernel=kernel)
    if warmup:
        ppo.step(data)
        torch.cuda.synchronize()
    for k in KERNELS:
        k.reset_counts()
    start = time.perf_counter()
    for _ in range(epochs):
        ppo.step(data)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    launches = {fn: n for k in KERNELS for fn, n in k.fn_launches.items()}
    want = dict.fromkeys(launches, 0)
    want['gae_forward'] = epochs
    want[f'lstm_{kernel[:3]}_forward'] = LSTM_PER_EPOCH * epochs
    want[f'lstm_{kernel[:3]}_backward'] = LSTM_PER_EPOCH * epochs
    if launches != want:
        raise AssertionError(f'LSTM trainer kernel={kernel}: launches '
            f'{launches}, expected {want}')
    losses = check_losses(data, f'LSTM trainer kernel={kernel}')
    sps = epochs * data.config.batch_size / elapsed
    log(f'LSTM trainer kernel={kernel}, 8192 lanes x 64, Default h128 + LSTM '
        f'h128 bf16: {sps:.1f} steps/s over {epochs} epochs '
        f'({elapsed / epochs * 1e3:.2f} ms/epoch, '
        f'{"after a warm-up epoch" if warmup else "no warm-up"}) on {card}; '
        f'launches {json.dumps({k: v for k, v in launches.items() if v})}; '
        f'losses {json.dumps(losses)}')
    return ppo, data, launches


def run_default_routes(torch, card):
    """The LSTM trainer through LSTMWrapper's default route
    (use_kernel=None) off the bench shapes, one epoch each, every launch
    count set to 0 just before and read just after: input width 96 with
    hidden 128 must route to enc5's resident kernels (16 launches of each
    lstm_enc function, as the JAX package runs enc5 at D != H); two
    layers at hidden 128 to cat (enc5 cannot fuse the encoder: 16 launches
    of each cat function per layer); hidden 256 with use_kernel=False (the
    caller asks for the plain scan) must run it with no LSTM launch; hidden
    256 by default and with use_kernel=True must route to enc5's streamed
    design (16 launches of each lstm_enc_stream function), and so must
    hidden 200, which is no multiple of 32 (the launchers pad it to 224).
    All with finite losses. Returns the launches of the hidden 256,
    use_kernel=True run."""
    from pufferlib_tpu_torch.ops.cuda import KERNELS
    device = torch.device('cuda')
    for lstm_input, hidden, layers, use, route, fn in (
            (96, 128, 1, None, 'enc5', 'lstm_enc'),
            (128, 128, 2, None, 'cat', 'lstm_cat'),
            (256, 256, 1, False, 'off', None),
            (256, 256, 1, None, 'enc5', 'lstm_enc_stream'),
            (256, 256, 1, True, 'enc5', 'lstm_enc_stream'),
            (200, 200, 1, None, 'enc5', 'lstm_enc_stream')):
        what = (f'input {lstm_input}, hidden {hidden}, {layers} layer(s), '
            f'use_kernel={use}')
        ppo, data = make_trainer(torch, hidden=hidden, lstm_kernel='enc5',
            lstm_input=lstm_input, lstm_use_kernel=use, lstm_layers=layers)
        got = data.policy.module.route(16, device)
        if got != route:
            raise AssertionError(f'{what}: route {got}, expected {route}')
        for k in KERNELS:
            k.reset_counts()
        start = time.perf_counter()
        ppo.step(data)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - start
        launches = {fn: n for k in KERNELS for fn, n in k.fn_launches.items()}
        want = dict.fromkeys(launches, 0)
        want['gae_forward'] = 1
        if fn is not None:
            want[f'{fn}_forward'] = want[f'{fn}_backward'] = \
                LSTM_PER_EPOCH * layers
        if launches != want:
            raise AssertionError(f'{what}: launches {launches}, expected '
                f'{want}')
        losses = check_losses(data, what)
        log(f'LSTM trainer, {what}, bf16: route {got}; 1 epoch (no warm-up) '
            f'in {elapsed * 1e3:.2f} ms on {card}; launches '
            f'{json.dumps({k: v for k, v in launches.items() if v})}; '
            f'losses {json.dumps(losses)}')
        del data
        if (hidden, use) == (256, True):
            result = launches
    return result


def log_stream_limits(torch):
    """lstm_common.STREAM_MAX_HIDDEN and STREAM_ROWS, which the checks
    and allocations before a launch use, must equal the built library's
    limits in both dtypes."""
    from pufferlib_tpu_torch.ops.cuda import lstm_cat, lstm_common
    got = {}
    for cdt in (torch.float32, torch.bfloat16):
        limits = lstm_cat.stream_limits(cdt)
        want = (lstm_common.STREAM_MAX_HIDDEN[cdt], lstm_common.STREAM_ROWS)
        if limits != want:
            raise AssertionError(f'lstm_stream_limits in {cdt}: {limits}, '
                f'lstm_common: {want}')
        got[str(cdt)] = limits[0]
    log(f'streamed LSTM design: largest hidden size {json.dumps(got)}, '
        f'tiles of {lstm_common.STREAM_ROWS} rows')


def check_losses(data, what):
    import math
    losses = dict(data.losses)
    bad = {k: v for k, v in losses.items() if not math.isfinite(v)}
    if bad:
        raise AssertionError(f'{what}: non-finite losses {bad}')
    return losses


# a grid of MLP head shapes (F, H, O) around the Ocean envs', beside the
# ones ocean_kernel_shapes works out: bandit, stochastic and memory's one
# feature with bandit's 10 arms + value; password's 5 features; spaces' 30
# nativized features (25 f32 + 5 int8) with its MultiDiscrete [2, 2] +
# value; one feature with a binary action + value. B: rollout lanes (128,
# 256) and minibatches (1024, 4096)
OCEAN_MLP_SHAPES = ((1, 128, 11), (5, 128, 3), (30, 128, 5), (1, 128, 3))
OCEAN_MLP_ROWS = (128, 256, 1024, 4096)

# config.yaml's Ocean sections (config.yaml:55-157), layered default ->
# ocean -> env: num_envs, batch_size, minibatch_size, bptt_horizon,
# learning_rate. visual has no section of its own: the ocean package's
OCEAN_CONFIGS = {
    'squared': (256, 16384, 4096, 8, 0.017),
    'bandit': (128, 4096, 1024, 4, 0.017),
    'memory': (256, 16384, 4096, 8, 0.01),
    'password': (256, 8192, 2048, 4, 0.017),
    'stochastic': (128, 8192, 2048, 8, 0.017),
    'spaces': (128, 4096, 1024, 4, 0.017),
    'multiagent': (128, 4096, 1024, 4, 0.017),
    'performance': (1024, 16384, 4096, 8, 0.017),
    'performance_empiric': (1024, 16384, 4096, 8, 0.017),
    'visual': (256, 16384, 4096, 8, 0.017),
}
# config.yaml:81-94: memory trains recurrent
OCEAN_RECURRENT = ('memory',)
# the envs that phase 12 runs a second time with the fused MLP head
OCEAN_KERNEL_ENVS = ('bandit', 'password', 'spaces')
# the JAX package's learning tests (tests/test_training.py:103-133,
# tests/test_training_extra.py:105-130): (num_envs, batch_size,
# minibatch_size, bptt_horizon, learning_rate), hidden size, epochs at
# most, env kwargs, the score to pass
OCEAN_PROOFS = {
    'memory': ((128, 4096, 1024, 4, 0.01), 64, 60,
        dict(mem_length=2, mem_delay=0), 0.9),
    'spaces': ((64, 2048, 512, 8, 0.02), 64, 40, {}, 0.8),
}


def ocean_kernel_shapes():
    """The shapes at which phases 12 and 13 launch GAE (T, agent rows),
    the MLP head (B, F, H, O) and enc5 (T, segments, H, F), worked out
    from OCEAN_CONFIGS and OCEAN_PROOFS as the trainer runs them: GAE once
    an epoch over the rollout's T steps x agent rows; the MLP head (the
    use_kernel runs) on the agent rows at each rollout step and the
    bootstrap, and on each minibatch's rows; enc5 (the recurrent runs) on
    a minibatch's segments of bptt steps. F and O are Default's encoder
    and head widths on the env's emulated spaces."""
    import pufferlib_tpu_torch.vector as vector
    from pufferlib_tpu_torch.models import Default
    from pufferlib_tpu_torch.ocean import env_creator
    runs = [(name, config, 128, {}, False)
        for name, config in OCEAN_CONFIGS.items()]
    runs += [(name, OCEAN_CONFIGS[name], 128, {}, True)
        for name in OCEAN_KERNEL_ENVS]
    runs += [(name, config, hidden, kwargs, False)
        for name, (config, hidden, _, kwargs, _) in OCEAN_PROOFS.items()]
    gae, mlp, enc5 = {}, {}, {}  # ordered sets
    for name, config, H, kwargs, use_kernel in runs:
        num_envs, batch_size, minibatch_size, bptt, _ = config
        vecenv = vector.make(env_creator(name), env_kwargs=kwargs,
            num_envs=num_envs, device='cpu')
        module = Default(obs_shape=vecenv.single_observation_space.shape,
            action_space=vecenv.single_action_space, hidden_size=H,
            emulated=vecenv.emulated)
        F, O = module.encoder.in_features, module.head.out_features
        rows = vecenv.num_agents
        gae[batch_size // rows, rows] = None
        if use_kernel:
            mlp[rows, F, H, O] = mlp[minibatch_size, F, H, O] = None
        if name in OCEAN_RECURRENT:
            enc5[bptt, minibatch_size // bptt, H, F] = None
    return list(gae), list(mlp), list(enc5)


def check_burn(torch, flush, rng, N=1024, most=2000):
    """The Performance envs' burn kernel against its plain version on
    the same lanes and counts (0 to `most`): equal bit for bit (each
    product and sum rounded on its own, as the plain version's two torch
    operations), both timed (CUDA events). Not a TPU kernel: a line of
    its own, no entry in the kernels line."""
    import numpy as np
    from pufferlib_tpu_torch.ops.cuda import burn
    x = torch.from_numpy(rng.rand(N).astype(np.float32)).cuda()
    iters = torch.from_numpy(rng.randint(-5, most, N).astype(
        np.int32)).cuda()
    before = burn.KERNEL.launches
    got = burn.burn(x, iters)
    want = burn.burn_reference(x, iters)
    torch.cuda.synchronize()
    if burn.KERNEL.launches != before + 1:
        raise AssertionError('burn: no launch counted')
    if not torch.equal(got, want):
        raise AssertionError(f'burn: differs from the plain version (max '
            f'abs err {(got - want).abs().max().item()})')
    ms = timed_ms(lambda: burn.burn(x, iters), flush)
    plain_ms = timed_ms(lambda: burn.burn_reference(x, iters), flush, reps=3)
    log(f'ocean burn N={N}, counts up to {most}: equal to the plain version '
        f'bit for bit; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (a '
        f'latency-bound chain of {int(iters.max())} dependent multiply-adds) '
        f'on {card_line()}')


def make_ocean_trainer(torch, name, num_envs, batch_size, minibatch_size,
        bptt, lr, hidden=128, dtype_name='bfloat16', use_kernel=False,
        recurrent=False, env_kwargs=None, total_timesteps=None,
        device='cuda', seed=0):
    """The fused trainer on Ocean env `name`: Default (recurrent:
    RecurrentPolicy(LSTMWrapper(Default)) through the default route) of
    hidden size `hidden` in dtype_name, obs stored in bf16 unless they are
    byte-packed (a structured space: bytes must stay bytes). Without
    total_timesteps the learning rate stays constant."""
    import pufferlib_tpu_torch.vector as vector
    from pufferlib_tpu_torch.models import (
        Default, LSTMWrapper, Policy, RecurrentPolicy)
    from pufferlib_tpu_torch.ocean import env_creator
    from pufferlib_tpu_torch.training import ppo
    dtype = getattr(torch, dtype_name)
    vecenv = vector.make(env_creator(name), env_kwargs=env_kwargs or {},
        num_envs=num_envs, device=device)
    shape = vecenv.single_observation_space.shape
    module = Default(obs_shape=shape, action_space=vecenv.single_action_space,
        hidden_size=hidden, dtype=dtype, emulated=vecenv.emulated,
        use_kernel=use_kernel, generator=torch.Generator().manual_seed(seed))
    policy = RecurrentPolicy(LSTMWrapper(module, obs_shape=shape,
        input_size=hidden, hidden_size=hidden, dtype=dtype,
        generator=torch.Generator().manual_seed(seed + 1))) if recurrent \
        else Policy(module)
    structured = vecenv.emulated.emulated_observation_dtype.names is not None
    config = ppo.default_config(
        env=name,
        batch_size=batch_size,
        minibatch_size=minibatch_size,
        bptt_horizon=bptt,
        learning_rate=lr,
        total_timesteps=total_timesteps or batch_size * 1_000_000,
        anneal_lr=total_timesteps is not None,
        obs_store_dtype=None if structured or dtype_name != 'bfloat16'
            else 'bfloat16',
        verbose=False,
        data_dir=os.path.join(REPO, 'experiments', 'chip_smoke'),
        checkpoint_interval=1_000_000,
        seed=seed,
        device=device,
    )
    return ppo, ppo.create(config, vecenv, policy)


def run_ocean_trainer(torch, card, name, use_kernel=False, epochs=2):
    """The trainer on Ocean env `name` at its config.yaml section: a
    warm-up epoch, then `epochs` calls of ppo.step with every launch count
    set to 0 just before and read just after, then the synchronised
    rollout/update split of one more epoch. The launches of GAE, enc5,
    the MLP head and the burn must be what an epoch runs, and nothing
    else launches."""
    from pufferlib_tpu_torch.ops.cuda import KERNELS
    num_envs, batch_size, minibatch_size, bptt, lr = OCEAN_CONFIGS[name]
    recurrent = name in OCEAN_RECURRENT
    ppo, data = make_ocean_trainer(torch, name, num_envs, batch_size,
        minibatch_size, bptt, lr, use_kernel=use_kernel,
        recurrent=recurrent)
    T = batch_size // data.vecenv.num_agents
    minibatches = data.config.update_epochs * (batch_size // minibatch_size)
    if recurrent:
        route = data.policy.module.route(bptt, torch.device('cuda'))
        if route != 'enc5':
            raise AssertionError(f'ocean {name}: LSTM route {route}, '
                'expected enc5')
    ppo.step(data)  # warm-up epoch
    torch.cuda.synchronize()
    for k in KERNELS:
        k.reset_counts()
    start = time.perf_counter()
    for _ in range(epochs):
        ppo.step(data)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    launches = {fn: n for k in KERNELS for fn, n in k.fn_launches.items()}
    want = dict.fromkeys(launches, 0)
    want['gae_forward'] = epochs
    if use_kernel:
        # each rollout step and the bootstrap value, each minibatch
        want['mlp_head_forward'] = (T + 1 + minibatches) * epochs
    if recurrent:
        want['lstm_enc_forward'] = want['lstm_enc_backward'] = \
            minibatches * epochs
    if name.startswith('performance'):
        want['ocean_burn'] = T * epochs
    if launches != want:
        raise AssertionError(f'ocean {name} use_kernel={use_kernel}: '
            f'launches {launches}, expected {want}')
    losses = check_losses(data, f'ocean {name} use_kernel={use_kernel}')
    sps = epochs * batch_size / elapsed
    ppo.evaluate(data)
    ppo.train(data)
    timers = data._timers
    per_epoch = {k: v // epochs for k, v in launches.items() if v}
    log(f'ocean {name} ({num_envs} lanes x {T}, batch {batch_size}, '
        f'minibatch {minibatch_size}, bptt {bptt}, lr {lr}; '
        f'{"LSTMWrapper(Default) h128 (enc5)" if recurrent else "Default h128"}'
        f' bf16, use_kernel={use_kernel}): {sps:.1f} steps/s over {epochs} '
        f'epochs after a warm-up epoch ({elapsed / epochs * 1e3:.2f} '
        f'ms/epoch); split: rollout {timers["evaluate"].prev * 1e3:.2f} ms, '
        f'update {timers["train"].prev * 1e3:.2f} ms; launches an epoch '
        f'{json.dumps(per_epoch)}; losses {json.dumps(losses)}; stats '
        f'{json.dumps(data.stats)} on {card}')
    del data


def run_ocean_phase(torch, card):
    """Every Ocean env through the trainer, then bandit, password and
    spaces with the fused MLP head."""
    for name in OCEAN_CONFIGS:
        run_ocean_trainer(torch, card, name)
    for name in OCEAN_KERNEL_ENVS:
        run_ocean_trainer(torch, card, name, use_kernel=True)


def ocean_learning_proofs(torch, card):
    """The JAX package's own learning tests on the card, in bf16, at
    OCEAN_PROOFS' settings: memory (mem_length 2, mem_delay 0; the best
    score must pass 0.9, stopping there) through LSTMWrapper's default
    route, enc5, whose launches are counted; spaces (the score after all
    its epochs must pass 0.8)."""
    from pufferlib_tpu_torch.ops.cuda import KERNELS
    config, hidden, most, kwargs, goal = OCEAN_PROOFS['memory']
    total = config[1] * most
    ppo, data = make_ocean_trainer(torch, 'memory', *config, hidden=hidden,
        recurrent=True, env_kwargs=kwargs, total_timesteps=total)
    bptt = config[3]
    minibatches = config[1] // config[2]
    route = data.policy.module.route(bptt, torch.device('cuda'))
    for k in KERNELS:
        k.reset_counts()
    start = time.perf_counter()
    best, epochs = 0.0, 0
    while data.global_step < total:
        stats, _ = ppo.evaluate(data)
        ppo.train(data)
        epochs += 1
        best = max(best, stats.get('score', 0.0))
        if best > goal:
            break
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    launches = {fn: n for k in KERNELS for fn, n in k.fn_launches.items()
        if n}
    want = data.config.update_epochs * minibatches * epochs
    if route != 'enc5' or launches.get('lstm_enc_forward', 0) != want \
            or launches.get('lstm_enc_backward', 0) != want:
        raise AssertionError(f'memory proof: route {route}, launches '
            f'{launches} in {epochs} epochs')
    if not best > goal:
        raise AssertionError(f'memory proof: best score {best} after '
            f'{epochs} epochs')
    log(f'learning proof memory (mem_length 2, {config[0]} lanes, LSTM '
        f'h{hidden} bf16, enc5): best score {best:.4f} after {epochs} '
        f'epochs in {elapsed:.1f} s; launches {json.dumps(launches)} on '
        f'{card}')
    del data

    config, hidden, epochs, kwargs, goal = OCEAN_PROOFS['spaces']
    total = config[1] * epochs
    ppo, data = make_ocean_trainer(torch, 'spaces', *config, hidden=hidden,
        env_kwargs=kwargs, total_timesteps=total)
    start = time.perf_counter()
    while data.global_step < total:
        ppo.step(data)
    score = data.stats.get('score')
    elapsed = time.perf_counter() - start
    if score is None or not score > goal:
        raise AssertionError(f'spaces proof: score {score} after {epochs} '
            'epochs')
    log(f'learning proof spaces ({config[0]} lanes, Default h{hidden} '
        f'bf16): score {score:.4f} after {epochs} epochs in {elapsed:.1f} s '
        f'on {card}')


def check_envs_card_against_cpu(torch, np):
    """12 steps of every Ocean env (squared at distance 3, one target) on
    the card and on the CPU from the same draws and actions, 256 lanes:
    obs, reward, done, truncated, every info field and the Performance
    envs' burnt x exactly equal."""
    import pufferlib_tpu_torch.vector as vector
    from pufferlib_tpu_torch.ocean import env_creator
    N = 256
    kwargs = {
        'performance': dict(delay_mean=2e-6, delay_std=1e-6),
        'performance_empiric': dict(count_n=20, count_std=8),
    }
    for name in OCEAN_CONFIGS:
        envs = [vector.make(env_creator(name), env_kwargs=kwargs.get(name),
            num_envs=N, device=d) for d in ('cpu', 'cuda')]
        if name == 'performance':
            for env in envs:
                env.env.env.work_per_second = 10_000_000
        g = torch.Generator().manual_seed(len(name))
        env = envs[0].env
        draws = [(env.sample_reset(N, 'cpu', g), env.sample_step(N, 'cpu', g))
            for _ in range(13)]
        space = envs[0].single_action_space
        rng = np.random.RandomState(3)
        outs = [[e.reset(reset_draws=draws[0][0].to(e.device))[0].cpu()]
            for e in envs]
        for t in range(12):
            if hasattr(space, 'nvec'):
                actions = np.stack([rng.randint(0, n, envs[0].num_agents)
                    for n in space.nvec], axis=1)
            else:
                actions = rng.randint(0, space.n, envs[0].num_agents)
            reset, step = draws[t + 1]
            for e, out in zip(envs, outs):
                result = e.step(torch.from_numpy(actions).to(e.device),
                    reset_draws=reset.to(e.device),
                    step_draws=None if step is None else step.to(e.device))
                out.extend(x.cpu() for x in result[:4])
                out.extend(result[4][k].cpu() for k in sorted(result[4]))
                if name.startswith('performance'):
                    out.append(e._state.env['env']['x'].cpu())
        for a, b in zip(*outs):
            if not torch.equal(a, b):
                raise AssertionError(f'{name} on the card differs from the '
                    'CPU')
        log(f'env card vs CPU, {name}: 12 autoreset steps x {N} lanes '
            f'({envs[0].num_agents} agent rows), exactly equal')


def check_gae_flat(torch, gae, flush, rng, N):
    """The host trainer's flat GAE through the GAE kernel (one column of
    N - 1 steps) against its plain version, compute_gae_flat: equal bit
    for bit; both timed beside the bound."""
    import numpy as np
    dones, values, rewards = (torch.from_numpy(a).cuda() for a in (
        (rng.rand(N) < 0.05).astype(np.float32),
        rng.randn(N).astype(np.float32),
        rng.uniform(-1, 1, N).astype(np.float32)))
    args = (dones, values, rewards, 0.99, 0.95)
    before = gae.KERNEL.launches
    got = gae.compute_gae_flat_cuda(*args)
    want = gae.compute_gae_flat(*args)
    torch.cuda.synchronize()
    if gae.KERNEL.launches != before + 1:
        raise AssertionError(f'flat GAE N={N}: no launch counted')
    if not (torch.isfinite(got).all() and torch.equal(got, want)):
        raise AssertionError(f'flat GAE N={N}: differs from the plain '
            f'version (max abs err {(got - want).abs().max().item()})')
    ms = timed_ms(lambda: gae.compute_gae_flat_cuda(*args), flush)
    plain_ms = timed_ms(lambda: gae.compute_gae_flat(*args), flush, reps=3)
    bound_ms, bound_by = bound(4 * N * 4, 9 * N, 'float32')
    log(f'flat GAE N={N} (one column of {N - 1} steps): equal to the plain '
        f'version bit for bit; kernel {ms:.4f} ms, plain {plain_ms:.4f} '
        f'ms, bound {bound_ms:.4f} ms ({bound_by}) on {card_line()}')
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by)


def check_conv_routes(torch):
    """LSTMWrapper's route for the Atari configuration on the card:
    Convolutional (no encoder contract) + LSTM at input and hidden 512
    takes cat, its streamed design, in f32 and bf16."""
    from pufferlib_tpu_torch import spaces
    from pufferlib_tpu_torch.models import Convolutional, LSTMWrapper
    from pufferlib_tpu_torch.ops.cuda.lstm_common import cat_design
    for cdt in (torch.float32, torch.bfloat16):
        mod = LSTMWrapper(Convolutional(spaces.Discrete(4), 4, 64 * 7 * 7,
            hidden_size=512, dtype=cdt), obs_shape=(4, 84, 84),
            input_size=512, hidden_size=512, dtype=cdt)
        route = mod.route(16, torch.device('cuda'))
        design = cat_design(512, 512, cdt)
        if (route, design) != ('cat', 'stream'):
            raise AssertionError(f'Convolutional + LSTM(512) {cdt}: route '
                f'{route}, design {design}')
        log(f'Convolutional + LSTMWrapper(512, 512) {cdt} on the card: route '
            f'{route} ({design} design)')


def check_native_envpool():
    """The native envpool driver, built with g++ from the port's copy of
    csrc/envpool.cpp, loads."""
    from pufferlib_tpu_torch import native
    start = time.perf_counter()
    lib = native.load(required=True)
    log(f'native envpool driver: {native.library_path()} loaded ({lib}) in '
        f'{time.perf_counter() - start:.2f} s')


# config.yaml's atari section (config.yaml:159-170 over the defaults,
# :13-40): Convolutional (framestack 4, flat 64*7*7, hidden 512) +
# LSTMWrapper(512, 512) in f32, the modules' default dtype; batch 16384,
# minibatch 4096, bptt 16, 64 envs, lr 2.5e-4. The envpool runs 8 workers
# of 8 envs (the machine's 8 cores) and answers 32 envs a recv, two worker
# groups in flight.
ATARI = dict(num_envs=64, num_workers=8, env_batch=32, batch_size=16384,
    minibatch_size=4096, bptt=16, hidden=512)
# config.yaml's procgen section (:227-245): ProcgenResnet(16, 256), 64
# envs, minibatch 2048, lr 5e-4, gamma 0.999, 3 update epochs, clip 0.2;
# the batch cut from 16384 to 8192
PROCGEN = dict(num_envs=64, batch_size=8192, minibatch_size=2048, bptt=16,
    lr=5e-4, gamma=0.999, update_epochs=3, clip_coef=0.2)
# tools/head_to_head.py:67-69, the JAX package's conv learning proof
# (tests/test_visual_conv.py:119-137): visual, 64 envs, batch 4096,
# minibatch 1024, bptt 16, lr 1e-3, 131072 steps, tail score >= 0.6
VISUAL = dict(num_envs=64, batch_size=4096, minibatch_size=1024, bptt=16,
    lr=1e-3, steps=131072, goal=0.6)


def _host_epochs(torch, ppo_host, data, epochs):
    """A warm-up epoch, then `epochs` epochs with every launch count set
    to 0 just before and read just after: (elapsed s, launches by C
    function)."""
    from pufferlib_tpu_torch.ops.cuda import KERNELS
    ppo_host.evaluate(data)
    ppo_host.train(data)
    torch.cuda.synchronize()
    for k in KERNELS:
        k.reset_counts()
    start = time.perf_counter()
    for _ in range(epochs):
        ppo_host.evaluate(data)
        ppo_host.train(data)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    return elapsed, {fn: n for k in KERNELS for fn, n in
        k.fn_launches.items()}


def _host_line(data, what, elapsed, epochs, launches, card, split=None):
    """split: the last timed epoch's (evaluate, train) seconds, where the
    trainer ran more since"""
    timers, profile = data._timers, data.profile
    split = split or (timers['evaluate'].prev, timers['train'].prev)
    losses = check_losses(data, what)
    per_epoch = {k: v // epochs for k, v in launches.items() if v}
    log(f'{what}: {epochs * data.config.batch_size / elapsed:.1f} steps/s '
        f'over {epochs} epochs after a warm-up epoch '
        f'({elapsed / epochs * 1e3:.2f} ms/epoch; {os.cpu_count()} host '
        f'cores); last epoch: evaluate {split[0] * 1e3:.2f} '
        f'ms, train {split[1] * 1e3:.2f} ms; totals: env '
        f'{profile.env.elapsed:.2f} s, forward wait '
        f'{profile.eval_forward.elapsed:.2f} s, eval misc '
        f'{profile.eval_misc.elapsed:.2f} s, learn '
        f'{profile.learn.elapsed:.2f} s, train misc '
        f'{profile.train_misc.elapsed:.2f} s; launches an epoch '
        f'{json.dumps(per_epoch)}; losses {json.dumps(losses)}; stats '
        f'{json.dumps(data.stats)} on {card}')


def make_atari_trainer(torch):
    """The Atari configuration (ATARI) through the host path: the fake ALE
    (4x84x84 uint8 frames) behind the port's Atari wrappers, EpisodeStats
    and GymnasiumPufferEnv in HostMultiprocessing with the native driver
    and two worker groups in flight, ppo_host with cpu_offload; the LSTM
    routed to cat. Returns the trainer's data (ppo_host.close it)."""
    from pufferlib_tpu_torch import vector_host
    from pufferlib_tpu_torch.environments.test.host_fixtures import (
        make_fake_atari)
    from pufferlib_tpu_torch.models import (
        Convolutional, LSTMWrapper, RecurrentPolicy)
    from pufferlib_tpu_torch.training import ppo_host
    a = ATARI
    vec = vector_host.make(make_fake_atari,
        backend=vector_host.HostMultiprocessing, num_envs=a['num_envs'],
        num_workers=a['num_workers'], batch_size=a['env_batch'], native=True)
    if vec._lib is None or not vec.supports_pipeline:
        raise AssertionError('atari: the envpool has no native driver or '
            'no pipeline')
    shape = vec.single_observation_space.shape
    H = a['hidden']
    lstm = LSTMWrapper(Convolutional(vec.single_action_space, 4, 64 * 7 * 7,
        hidden_size=H, generator=torch.Generator().manual_seed(0)),
        obs_shape=shape, input_size=H, hidden_size=H,
        generator=torch.Generator().manual_seed(1))
    route = lstm.route(a['bptt'], torch.device('cuda'))
    if route != 'cat':
        raise AssertionError(f'atari: LSTM route {route}, expected cat')
    config = ppo_host.default_config(env='atari',
        batch_size=a['batch_size'], minibatch_size=a['minibatch_size'],
        bptt_horizon=a['bptt'], cpu_offload=True,
        total_timesteps=a['batch_size'] * 1000, verbose=False,
        data_dir=os.path.join(REPO, 'experiments', 'chip_smoke'),
        checkpoint_interval=10 ** 6, seed=0)
    return ppo_host.create(config, vec, RecurrentPolicy(lstm))


def run_atari_phase(torch, card, epochs=2):
    """make_atari_trainer's trainer: a warm-up epoch, then `epochs`. The
    update runs cat's streamed design at (T 16, B 256, D = H = 512) in
    f32: 16 launches of each of its C functions an epoch (4 update
    epochs x 4 minibatches), and the flat GAE once. Returns the launches
    by C function."""
    from pufferlib_tpu_torch.training import ppo_host
    a = ATARI
    data = make_atari_trainer(torch)
    config, H = data.config, a['hidden']
    try:
        elapsed, launches = _host_epochs(torch, ppo_host, data, epochs)
        # one more update, under the profiler: its kernels' device time,
        # beside the wall time of the last timed epoch's update
        split = (data._timers['evaluate'].prev, data._timers['train'].prev)
        ppo_host.evaluate(data)
        update = load_tool('profile_torch_trainer').profile_phase(torch,
            lambda: ppo_host.train(data), split[1] * 1e3)[1]
    finally:
        ppo_host.close(data)
    log(f'atari update under the profiler: wall {update["wall_ms"]:.2f} ms, '
        f'kernels {update["device_ms"]:.2f} ms, idle '
        f'{update["idle_share"]:.3f}, {update["launches"]} launches; top '
        f'{update["top"]} on {card}')
    minibatches = config.update_epochs * (a['batch_size']
        // a['minibatch_size'])
    want = dict.fromkeys(launches, 0)
    want['gae_forward'] = epochs
    want['lstm_cat_stream_forward'] = want['lstm_cat_stream_backward'] = \
        minibatches * epochs
    if launches != want:
        raise AssertionError(f'atari: launches {launches}, expected {want}')
    if 'episode_return' not in data.stats:
        raise AssertionError(f'atari: no episode stats ({data.stats})')
    _host_line(data, f'atari host trainer ({a["num_envs"]} fake ALE envs in '
        f'{a["num_workers"]} workers, {a["env_batch"]} a recv, native driver,'
        f' pipelined, cpu_offload; Convolutional h{H} + LSTM {H} f32, batch '
        f'{a["batch_size"]}, minibatch {a["minibatch_size"]}, bptt '
        f'{a["bptt"]})', elapsed, epochs, launches, card, split)
    return launches


def run_procgen_phase(torch, card, epochs=2):
    """ProcgenResnet(16, 256) through ppo_host (PROCGEN) on the fake
    procgen env (64x64x3 uint8) in HostSerial: no LSTM; the flat GAE once
    an epoch is its only kernel."""
    from pufferlib_tpu_torch import vector_host
    from pufferlib_tpu_torch.environments.test.host_fixtures import (
        make_fake_procgen)
    from pufferlib_tpu_torch.models import Policy, ProcgenResnet
    from pufferlib_tpu_torch.training import ppo_host
    p = PROCGEN
    vec = vector_host.make(make_fake_procgen,
        backend=vector_host.HostSerial, num_envs=p['num_envs'])
    policy = Policy(ProcgenResnet(vec.single_action_space, cnn_width=16,
        mlp_width=256, obs_shape=vec.single_observation_space.shape,
        generator=torch.Generator().manual_seed(0)))
    config = ppo_host.default_config(env='procgen',
        batch_size=p['batch_size'], minibatch_size=p['minibatch_size'],
        bptt_horizon=p['bptt'], learning_rate=p['lr'], gamma=p['gamma'],
        update_epochs=p['update_epochs'], clip_coef=p['clip_coef'],
        total_timesteps=p['batch_size'] * 1000, verbose=False,
        data_dir=os.path.join(REPO, 'experiments', 'chip_smoke'),
        checkpoint_interval=10 ** 6, seed=0)
    data = ppo_host.create(config, vec, policy)
    try:
        elapsed, launches = _host_epochs(torch, ppo_host, data, epochs)
    finally:
        ppo_host.close(data)
    want = dict.fromkeys(launches, 0)
    want['gae_forward'] = epochs
    if launches != want:
        raise AssertionError(f'procgen: launches {launches}, expected {want}')
    _host_line(data, f'procgen host trainer ({p["num_envs"]} fake procgen '
        f'envs, HostSerial; ProcgenResnet(16, 256) f32, batch '
        f'{p["batch_size"]}, minibatch {p["minibatch_size"]})', elapsed,
        epochs, launches, card)


def run_visual_phase(torch, card):
    """Convolutional(framestack 2, flat 64, hidden 128) on VisualTarget
    through the device trainer at VISUAL's settings, the JAX package's
    conv learning proof: the tail score (the mean of the last fifth of the
    epochs' scores, tools/head_to_head.py tail_mean) must reach 0.6. Then
    two epochs of the trained conv, in bf16, wrapped in LSTMWrapper(128,
    128): the resident cat kernels, 16 launches of each an epoch."""
    import pufferlib_tpu_torch.vector as vector
    from pufferlib_tpu_torch.models import (
        Convolutional, LSTMWrapper, Policy, RecurrentPolicy)
    from pufferlib_tpu_torch.ocean import env_creator
    from pufferlib_tpu_torch.ops.cuda import KERNELS
    from pufferlib_tpu_torch.training import ppo
    v = VISUAL

    def trainer(policy, total, seed):
        vecenv = vector.make(env_creator('visual'), num_envs=v['num_envs'],
            device='cuda')
        config = ppo.default_config(env='visual', seed=seed,
            total_timesteps=total, learning_rate=v['lr'],
            batch_size=v['batch_size'], minibatch_size=v['minibatch_size'],
            bptt_horizon=v['bptt'], verbose=False,
            data_dir=os.path.join(REPO, 'experiments', 'chip_smoke'),
            checkpoint_interval=10 ** 6)
        return ppo.create(config, vecenv, policy)

    space = env_creator('visual')().action_space
    conv = Convolutional(space, 2, 64, hidden_size=128,
        generator=torch.Generator().manual_seed(1))
    data = trainer(Policy(conv), v['steps'], 1)
    scores = []
    start = time.perf_counter()
    while data.global_step < v['steps']:
        ppo.evaluate(data)
        ppo.train(data)
        if 'score' in data.stats:
            scores.append(data.stats['score'])
    elapsed = time.perf_counter() - start
    tail = scores[-max(1, len(scores) // 5):]
    tail_mean = sum(tail) / len(tail) if tail else float('nan')
    if not tail_mean >= v['goal']:
        raise AssertionError(f'visual proof: tail score {tail_mean} '
            f'(scores {scores})')
    log(f'visual learning proof (Convolutional h128 f32, device trainer, '
        f'{v["num_envs"]} lanes, {v["steps"]} steps): tail score '
        f'{tail_mean:.4f} (goal {v["goal"]}) over {len(scores)} epochs in '
        f'{elapsed:.1f} s; losses {json.dumps(dict(data.losses))} on {card}')

    bf16 = Convolutional(space, 2, 64, hidden_size=128, dtype=torch.bfloat16)
    bf16.load_state_dict(conv.state_dict())
    lstm = LSTMWrapper(bf16, obs_shape=(2, 40, 40), input_size=128,
        hidden_size=128, dtype=torch.bfloat16,
        generator=torch.Generator().manual_seed(2))
    data = trainer(RecurrentPolicy(lstm), v['batch_size'] * 1000, 2)
    ppo.step(data)  # warm-up epoch
    torch.cuda.synchronize()
    for k in KERNELS:
        k.reset_counts()
    start = time.perf_counter()
    for _ in range(2):
        ppo.step(data)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    launches = {fn: n for k in KERNELS for fn, n in k.fn_launches.items()}
    want = dict.fromkeys(launches, 0)
    want['gae_forward'] = 2
    want['lstm_cat_forward'] = want['lstm_cat_backward'] = 32
    if launches != want:
        raise AssertionError(f'visual + LSTM: launches {launches}, expected '
            f'{want}')
    losses = check_losses(data, 'visual + LSTM')
    log(f'visual trainer, Convolutional + LSTMWrapper(128, 128) bf16 (resident'
        f' cat): {2 * v["batch_size"] / elapsed:.1f} steps/s over 2 epochs '
        f'after a warm-up epoch; launches '
        f'{json.dumps({k: n for k, n in launches.items() if n})}; losses '
        f'{json.dumps(losses)} on {card}')


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this script '
            'needs an NVIDIA GPU', file=sys.stderr)
        return 1
    import numpy as np
    from pufferlib_tpu_torch.ops.cuda import KERNELS, gae, mlp
    from pufferlib_tpu_torch.ops.cuda._build import build_all

    # phase 1: the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f'card: {card}')
    log(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
        f'{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}')

    # phase 2: build every kernel from this checkout, nvcc in parallel
    start = time.perf_counter()
    build_all(KERNELS)
    log(f'build: {time.perf_counter() - start:.1f} s wall')
    for k in KERNELS:
        seconds = 'cached' if k.build_seconds is None else \
            f'{k.build_seconds:.1f} s'
        usage = [line.strip() for line in k.build_log.splitlines()
            if 'registers' in line or 'spill' in line]
        log(f'  {k.source}: {seconds}; ' + ' | '.join(usage))
    log_tc_usage()

    # phases 3-4: each kernel against its plain version, then timed
    flush = l2_flush_buffer()
    rng = np.random.RandomState(0)
    ocean_gae, ocean_mlp, ocean_enc5 = ocean_kernel_shapes()
    log(f'Ocean phase shapes: GAE (T, rows) {ocean_gae}; MLP head (B, F, H, '
        f'O) {ocean_mlp}; enc5 (T, segments, H, F) {ocean_enc5}')
    # the bench trainer's shape, ragged ones, then every shape phases 12
    # and 13 run
    gae_runs = [check_gae(torch, gae, flush, rng, T, E)
        for T, E in ((64, 8192), (64, 1000), (100, 257), (7, 33))
            + tuple(ocean_gae)
            # the CLI phase's bench headline and autotune's widest rung
            + ((64, max(CLI_AUTOTUNE_LANES)),)]
    # the trainer's two shapes, then the bf16 kernel's other reach: H in
    # chunks (256, 512: configurations 1 and 2), a multidiscrete head (O =
    # 17), a ragged tile, f32 x under bf16 compute
    mlp_runs = {(B, d): check_mlp(torch, mlp, flush, rng, B, d)
        for B in (8192, 131072) for d in ('bfloat16', 'float32')}
    for H in (256, 512):
        for B in (8192, 1000):
            mlp_runs[B, f'bfloat16 F=200 H={H} O=17'] = check_mlp(torch, mlp,
                flush, rng, B, 'bfloat16', F=200, H=H, O=17)
    mlp_runs[1000, 'bfloat16 x float32'] = check_mlp(torch, mlp, flush, rng,
        1000, 'bfloat16', x_dtype_name='float32')
    mlp_runs[8192, 'bfloat16 x float32'] = check_mlp(torch, mlp, flush, rng,
        8192, 'bfloat16', x_dtype_name='float32')
    check_mlp_bit_equal(torch, mlp, rng)
    # every shape the use_kernel runs of phase 12 give it, then the
    # Ocean grid's others
    ocean_grid = [(B, F, H, O) for F, H, O in OCEAN_MLP_SHAPES
        for B in OCEAN_MLP_ROWS]
    for B, F, H, O in ocean_mlp + ocean_grid:
        key = B, f'bfloat16 F={F} H={H} O={O}'
        if key not in mlp_runs:
            mlp_runs[key] = check_mlp(torch, mlp, flush, rng, B, 'bfloat16',
                F=F, H=H, O=O)
    lstm_runs = {(kind, B, d): check_lstm(torch, flush, rng, kind, B, d,
            timed=(B, d) == (8192, 'bfloat16'))
        for kind in ('enc5', 'cat', 'scan', 'fused', 'enc')
            + ARCHIVED_ENC_KINDS + ('tm',)
        for B in (8192, 1000) for d in ('bfloat16', 'float32')}
    # the tensor-core kernels at an input width apart from the hidden size;
    # enc5 also with a feature width past the FMA kernels' 128
    for kind in ('cat', 'fused'):
        lstm_runs[kind, 8192, 'bfloat16 D=96'] = check_lstm(torch, flush,
            rng, kind, 8192, 'bfloat16', D=96)
    for B in (8192, 1000):
        lstm_runs['enc5', B, 'bfloat16 D=96 F=200'] = check_lstm(torch, flush,
            rng, 'enc5', B, 'bfloat16', D=96, F=200)
    # memory's one feature at the Ocean trainer's minibatch and the
    # learning proof's
    for T, B, H, F in ocean_enc5:
        lstm_runs['enc5', B, f'bfloat16 F={F} H={H} T={T}'] = check_lstm(
            torch, flush, rng, 'enc5', B, 'bfloat16', T=T, H=H, F=F,
            timed=True)
    # memory's (one feature, hidden 128) in f32, as the CLI phase's
    # memory run launches it: config.yaml names no dtype
    _, _, mb, bptt, _ = OCEAN_CONFIGS['memory']
    lstm_runs['enc5', mb // bptt, 'float32 F=1 H=128 T=8'] = check_lstm(
        torch, flush, rng, 'enc5', mb // bptt, 'float32', T=bptt, F=1)
    check_burn(torch, flush, rng)
    # enc5's bf16 kernels add every partial sum in a fixed order
    check_bit_equal(torch, rng, 'enc5', 8192)
    check_bit_equal(torch, rng, 'enc5', 1000, D=96, F=200)
    # x_proj and the compute dtype apart, both ways
    for kind in XP_KINDS:
        for B in (8192, 1000):
            lstm_runs[kind, B, 'bfloat16/f32 x_proj'] = check_lstm(torch,
                flush, rng, kind, B, 'bfloat16', xp_dtype_name='float32')
            lstm_runs[kind, B, 'float32/bf16 x_proj'] = check_lstm(torch,
                flush, rng, kind, B, 'float32', xp_dtype_name='bfloat16')
    for kind in ('scan', 'fused', 'cat', 'enc5') + ARCHIVED_ENC_KINDS:
        time_tc_phases(torch, flush, rng, kind)
    # every other bf16 backward whose weight gradients run the split-K
    # (lstm_common.cuh: the ring, or the register-staged kernel for
    # sources it cannot copy) repeats bit for bit too
    for kind in ('scan', 'fused', 'cat') + ARCHIVED_ENC_KINDS:
        check_bit_equal(torch, rng, kind, 8192)
    check_enc6_is_enc5(torch, rng, 8192)
    check_enc6_is_enc5(torch, rng, 980, H=64)
    for kind in ('enc',) + ARCHIVED_ENC_KINDS:
        check_bit_equal(torch, rng, kind, 1000)
    # cat's streamed design at the Atari update's shape and the others
    # the resident kernels refuse, the route that sends the Atari
    # configuration to it, the host trainer's flat GAE at the Atari and
    # a smaller batch, and the native envpool driver
    stream_runs, stream_per_call = check_cat_stream(torch, flush, rng)
    enc5_stream_runs = check_enc5_stream(torch, flush, rng, stream_runs)
    log_stream_limits(torch)
    check_conv_routes(torch)
    flat_runs = {N: check_gae_flat(torch, gae, flush, rng, N)
        for N in (16384, 4096)}
    check_native_envpool()
    del flush

    # phase 5: the main path, GAE kernel once per epoch
    run_mlp_trainer(torch, card, use_kernel=False)

    # phase 6: the opt-in fused MLP head on the same trainer
    mlp_launches, gae_launches = run_mlp_trainer(torch, card,
        use_kernel=True)

    # phase 7: the LSTM trainer through the enc5 kernels, then the synchronised rollout/update split of an epoch
    torch.cuda.reset_peak_memory_stats()
    ppo, data, enc5_launches = run_lstm_trainer(torch, card, 'enc5',
        epochs=2, warmup=True)
    for _ in range(2):
        ppo.evaluate(data)
        ppo.train(data)
    timers = data._timers
    log(f'LSTM trainer split, 2 epochs: rollout '
        f'{timers["evaluate"].prev * 1e3:.2f} ms, update '
        f'{timers["train"].prev * 1e3:.2f} ms (last epoch); peak memory '
        f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    del data

    # phase 8: the same trainer through the cat kernels (bf16: the
    # tensor-core ones)
    _, data, cat_launches = run_lstm_trainer(torch, card, 'cat', epochs=2,
        warmup=False)
    del data

    # phase 9: the default route (use_kernel=None) off the bench shapes:
    # input 96 (enc5), two layers (cat), hidden 256 with use_kernel=False
    # (the plain scan), and hidden 256 by default and with use_kernel=True
    # (enc5's streamed design)
    route_launches = run_default_routes(torch, card)

    # phase 10: the LSTM validation path, at its full settings
    validation_launches = run_validation_path(torch)

    # phase 11: the card against the CPU, at a small size in f32
    check_card_against_cpu(torch, np)
    check_lstm_card_against_cpu(torch, np)
    check_envs_card_against_cpu(torch, np)

    # phase 12: every Ocean env through the trainer at its config.yaml
    # section; bandit, password and spaces also with the fused MLP head
    run_ocean_phase(torch, card)

    # phase 13: the JAX package's learning tests of memory and spaces
    ocean_learning_proofs(torch, card)

    # phase 14: the Atari configuration through the host envpool and the
    # host trainer (cat's streamed design at hidden 512, the flat GAE)
    atari_launches = run_atari_phase(torch, card)

    # phase 15: ProcgenResnet through the host trainer
    run_procgen_phase(torch, card)
    # the host path runs without gymnasium, which the card's machine may
    # lack: nothing so far imported it
    if 'gymnasium' in sys.modules:
        raise AssertionError('the host phases imported gymnasium')

    # phase 16: Convolutional on the device trainer (the conv learning
    # proof), then wrapped in the LSTM (the resident cat kernels)
    run_visual_phase(torch, card)

    # phase 17: the command-line entry point (demo_torch.py) and its bench
    # (bench_torch.py)
    cli_launches = run_cli_phase(torch, card)

    # phase 18: data parallel on the card: a world-size-1 NCCL mesh
    # against no mesh, then two gloo ranks sharing the card
    dp_launches, dp2_launches = run_dp_phase(torch, card)

    # phase 19: the transformer family (the wrapper at the bench width on
    # the card, the bench line's trainer, the memory learning proof) and
    # self-play (PolicyPool, examples/selfplay_torch.py)
    xf_launches, xf_proof_launches = run_transformer_phase(torch, card)

    # phase 20: the zoo policies that reach an LSTM kernel (nethack at its
    # config.yaml widths, then one epoch each of nmmo, nmmo3 and
    # pokemon_red) and the frameworks bridge (a reference checkpoint
    # through torch_import, held to the reference math, then played by
    # demo_torch's eval)
    zoo_runs, zoo_launches, import_launches, zoo_peak = run_zoo_phase(torch,
        card, l2_flush_buffer(), rng)

    mlp_big, mlp_small = (mlp_runs[B, 'bfloat16'] for B in (131072, 8192))
    kernels = [
        dict(name='gae', route='cuda',
            source='pufferlib_tpu_torch/csrc/gae.cu',
            replaces='pufferlib_tpu/ops/pallas/gae.py:42',
            launches=gae_launches,
            max_abs_err=max(r['err'] for r in gae_runs),
            ms=gae_runs[0]['ms'], device_ms=gae_runs[0]['device_ms'],
            plain_ms=gae_runs[0]['plain_ms'],
            bound_ms=gae_runs[0]['bound_ms'], bound_by=gae_runs[0]['bound_by'],
            library_ms=None, shape=gae_runs[0]['shape'],
            # demo_torch's squared and memory runs (phase 17)
            cli_launches=sum(n['gae_forward'] for n in cli_launches.values()),
            # the host trainer's flat GAE: one column of N - 1 steps, at
            # the Atari batch, once an epoch of phase 14
            flat_launches=atari_launches['gae_forward'],
            flat_ms=flat_runs[16384]['ms'],
            flat_plain_ms=flat_runs[16384]['plain_ms'],
            flat_bound_ms=flat_runs[16384]['bound_ms'],
            flat_shape='N=16384 float32'),
        dict(name='mlp_head', route='cuda',
            source='pufferlib_tpu_torch/csrc/mlp_head.cu',
            replaces='pufferlib_tpu/ops/pallas/mlp.py:80',
            launches=mlp_launches,
            max_abs_err=max(r['err'] for r in mlp_runs.values()),
            ms=mlp_big['ms'], device_ms=mlp_big['device_ms'],
            plain_ms=mlp_big['plain_ms'],
            bound_ms=mlp_big['bound_ms'], bound_by=mlp_big['bound_by'],
            library_ms=None, shape=mlp_big['shape'],
            # the trainer's other shape (65 of its 81 launches an epoch),
            # and cuBLAS's three-call composition at both, as context
            ms_8192=mlp_small['ms'], device_ms_8192=mlp_small['device_ms'],
            plain_ms_8192=mlp_small['plain_ms'],
            bound_ms_8192=mlp_small['bound_ms'],
            cublas_composition_ms=mlp_big['cublas_ms'],
            cublas_composition_ms_8192=mlp_small['cublas_ms']),
    ]
    # (name, check_lstm kind, forward or backward, source, the TPU kernel,
    # launches on the path that runs it)
    lstm_rows = (
        ('lstm_enc5_forward', 'enc5', 'fwd', 'lstm_enc.cu',
            'lstm_enc.py:170', enc5_launches['lstm_enc_forward']),
        ('lstm_enc5_backward', 'enc5', 'bwd', 'lstm_enc.cu',
            'lstm_enc5.py:147', enc5_launches['lstm_enc_backward']),
        ('lstm_cat_forward', 'cat', 'fwd', 'lstm_cat.cu', 'lstm_cat.py:131',
            cat_launches['lstm_cat_forward']),
        ('lstm_cat_backward', 'cat', 'bwd', 'lstm_cat.cu', 'lstm_cat.py:185',
            cat_launches['lstm_cat_backward']),
        ('lstm_enc_step_backward', 'enc', 'bwd', 'lstm_enc.cu',
            'lstm_enc.py:241', validation_launches['lstm_enc_step_backward']),
        ('lstm_scan_forward', 'scan', 'fwd', 'lstm_scan.cu', 'lstm.py:185',
            validation_launches['lstm_scan_forward']),
        ('lstm_scan_backward', 'scan', 'bwd', 'lstm_scan.cu', 'lstm.py:236',
            validation_launches['lstm_scan_backward']),
        ('lstm_fused_forward', 'fused', 'fwd', 'lstm_scan.cu', 'lstm.py:407',
            validation_launches['lstm_fused_forward']),
        ('lstm_fused_backward', 'fused', 'bwd', 'lstm_scan.cu',
            'lstm.py:464', validation_launches['lstm_fused_backward']),
        ('lstm_enc2_forward', 'enc2', 'fwd', 'lstm_archive.cu',
            'archive/lstm_enc2.py:228',
            validation_launches['lstm_enc2_forward']),
        ('lstm_enc2_backward', 'enc2', 'bwd', 'lstm_archive.cu',
            'archive/lstm_enc2.py:273',
            validation_launches['lstm_enc2_backward']),
        ('lstm_enc3_backward', 'enc3', 'bwd', 'lstm_archive.cu',
            'archive/lstm_enc3.py:159',
            validation_launches['lstm_enc3_backward']),
        ('lstm_enc4_backward', 'enc4', 'bwd', 'lstm_archive.cu',
            'archive/lstm_enc4.py:142',
            validation_launches['lstm_enc4_backward']),
        ('lstm_enc6_backward', 'enc6', 'bwd', 'lstm_archive.cu',
            'archive/lstm_enc6.py:161',
            validation_launches['lstm_enc6_backward']),
        # one call of tm is T launches of its step kernel; the times are
        # one call's
        ('lstm_tm_step_forward', 'tm', 'fwd', 'lstm_archive.cu',
            'archive/lstm_tm.py:144',
            validation_launches['lstm_tm_step_forward']),
        ('lstm_tm_step_backward', 'tm', 'bwd', 'lstm_archive.cu',
            'archive/lstm_tm.py:199',
            validation_launches['lstm_tm_step_backward']),
    )
    for name, kind, part, source, replaces, launches in lstm_rows:
        main = lstm_runs[kind, 8192, 'bfloat16']
        kernels.append(dict(name=name, route='cuda',
            source=f'pufferlib_tpu_torch/csrc/{source}',
            replaces=f'pufferlib_tpu/ops/pallas/{replaces}',
            launches=launches,
            max_abs_err=max(r[f'{part}_err'] for (k, _, _), r in
                lstm_runs.items() if k == kind),
            ms=main[f'{part}_ms'], plain_ms=main[f'{part}_plain_ms'],
            bound_ms=main[f'{part}_bound'], bound_by=main[f'{part}_by'],
            library_ms=main[f'{part}_lib'], shape=main['shape']))
    # enc5's launches in demo_torch's memory run (phase 17, f32)
    rows = {row['name']: row for row in kernels}
    for part in ('forward', 'backward'):
        rows[f'lstm_enc5_{part}']['cli_launches'] = \
            cli_launches['memory'][f'lstm_enc_{part}']
    # phase 18's counted epochs (bf16): the world-size-1 mesh, and one of
    # the two ranks that share the card
    for row, leg, fn in (('gae', 0, 'gae_forward'),
            ('mlp_head', 0, 'mlp_head_forward'),
            ('lstm_enc5_forward', 1, 'lstm_enc_forward'),
            ('lstm_enc5_backward', 1, 'lstm_enc_backward')):
        rows[row]['dp_launches'] = dp_launches[leg, 'bfloat16'][fn]
        rows[row]['dp_rank_launches'] = dp2_launches[leg, 'bfloat16'][fn]
    # phase 19: the transformer line's counted epochs and the memory proof
    rows['gae']['transformer_launches'] = xf_launches
    rows['gae']['transformer_proof_launches'] = xf_proof_launches
    # cat's streamed design (csrc/lstm_cat_stream.cu): the Atari update's
    # shape in f32, as phase 14 runs it; enc5's at the default route's
    # hidden 256 in bf16, as phase 9 runs it, and in f32 (the same C
    # functions, so the same launches: rows named _f32). A C call is a
    # constant number of kernels (kernels_per_call); the times are one
    # call's
    atari = stream_runs[(16, 256, 512, 512), 'float32']
    enc5_256 = enc5_stream_runs[(16, 8192, 49, 256, 256), 'bfloat16']
    enc5_256_f32 = enc5_stream_runs[(16, 8192, 49, 256, 256), 'float32']
    for fn, part, replaces, launches, main, runs in (
            ('lstm_cat_stream_forward', 'fwd', 'lstm_cat.py:131',
                atari_launches['lstm_cat_stream_forward'], atari,
                stream_runs),
            ('lstm_cat_stream_backward', 'bwd', 'lstm_cat.py:185',
                atari_launches['lstm_cat_stream_backward'], atari,
                stream_runs),
            ('lstm_enc_stream_forward', 'fwd', 'lstm_enc.py:170',
                route_launches['lstm_enc_stream_forward'], enc5_256,
                enc5_stream_runs),
            ('lstm_enc_stream_backward', 'bwd', 'lstm_enc5.py:147',
                route_launches['lstm_enc_stream_backward'], enc5_256,
                enc5_stream_runs),
            ('lstm_enc_stream_forward_f32', 'fwd', 'lstm_enc.py:170',
                route_launches['lstm_enc_stream_forward'], enc5_256_f32,
                enc5_stream_runs),
            ('lstm_enc_stream_backward_f32', 'bwd', 'lstm_enc5.py:147',
                route_launches['lstm_enc_stream_backward'], enc5_256_f32,
                enc5_stream_runs)):
        kernels.append(dict(name=fn, route='cuda',
            source='pufferlib_tpu_torch/csrc/lstm_cat_stream.cu',
            replaces=f'pufferlib_tpu/ops/pallas/{replaces}',
            launches=launches,
            max_abs_err=max(r[f'{part}_err'] for r in runs.values()),
            ms=main[f'{part}_ms'], plain_ms=main[f'{part}_plain_ms'],
            bound_ms=main[f'{part}_bound'], bound_by=main[f'{part}_by'],
            library_ms=main[f'{part}_lib'], shape=main['shape']))
    kernels[-6]['kernels_per_call'] = stream_per_call['float32'][16][0]
    kernels[-5]['kernels_per_call'] = stream_per_call['float32'][16][1]
    # phase 20: the zoo trainers' flat GAE; enc5's launches in the
    # reference checkpoint's check; cat's streamed pair at the nethack
    # update's shape (rows named _zoo; launches: the nethack trainer's
    # counted epochs), its launches in each zoo trainer and its times at
    # the other zoo shapes
    rows['gae']['zoo_launches'] = {name: n['gae_forward'] for name, n in
        zoo_launches.items()}
    for part in ('forward', 'backward'):
        rows[f'lstm_enc5_{part}']['import_launches'] = \
            import_launches[f'lstm_enc_{part}']
    nethack = zoo_runs[ZOO_CAT_SHAPES[0]]
    for fn, part, replaces in (
            ('lstm_cat_stream_forward', 'fwd', 'lstm_cat.py:131'),
            ('lstm_cat_stream_backward', 'bwd', 'lstm_cat.py:185')):
        kernels.append(dict(name=f'{fn}_zoo', route='cuda',
            source='pufferlib_tpu_torch/csrc/lstm_cat_stream.cu',
            replaces=f'pufferlib_tpu/ops/pallas/{replaces}',
            launches=zoo_launches['nethack'][fn],
            max_abs_err=max(r[f'{part}_err'] for r in zoo_runs.values()),
            ms=nethack[f'{part}_ms'], plain_ms=nethack[f'{part}_plain_ms'],
            bound_ms=nethack[f'{part}_bound'], bound_by=nethack[f'{part}_by'],
            library_ms=nethack[f'{part}_lib'], shape=nethack['shape'],
            zoo_launches={name: n[fn] for name, n in zoo_launches.items()},
            other_shapes={r['shape']: dict(ms=r[f'{part}_ms'],
                plain_ms=r[f'{part}_plain_ms'],
                bound_ms=r[f'{part}_bound'],
                library_ms=r[f'{part}_lib']) for shape, r in
                zoo_runs.items() if shape != ZOO_CAT_SHAPES[0]},
            nethack_peak_memory_bytes=zoo_peak))
    print(json.dumps({'profiler_lost': PROFILER_LOST}), flush=True)
    print(json.dumps({'kernels': kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
        'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


# the CLI phase (phase 17): epochs of each config.yaml training run, the
# autotune ladder, and the bench's window
CLI_EPOCHS = 3
CLI_AUTOTUNE_LANES = (8192, 32768)
# 10 epochs after the warm-up chunk, so that the whole smoke stays near
# 480 s
CLI_BENCH_ENV = {'BENCH_EPOCHS': '10', 'BENCH_CHUNK': '10'}
CLI_BENCH_METRICS = ['ocean_squared_ppo_sps_8k_lanes',
    'ocean_squared_ppo_lstm_sps', 'ocean_squared_ppo_sps']


def run_cli_phase(torch, card):
    """The port's command-line entry point on the card. demo_torch.main
    trains config.yaml's squared section (256 lanes, batch 16384,
    minibatch 4096, bptt 8, Default h128) and its memory section
    (LSTMWrapper(128), the default route: enc5) for CLI_EPOCHS epochs
    each, every launch count set to 0 just before and read just after:
    GAE once an epoch, and in memory enc5's forward and backward 16 times
    an epoch each (4 update epochs x 4 minibatches), nothing else. Then
    --mode autotune over CLI_AUTOTUNE_LANES (GAE once an epoch of each
    rung: a warm-up and 8 timed), and bench_torch.py in a child process
    at CLI_BENCH_ENV, its lines printed as they came, each value finite
    and positive. Returns the launches of each training run by env."""
    import gc
    import math
    import subprocess
    import demo_torch
    from pufferlib_tpu_torch.ops.cuda import KERNELS

    def counted(argv):
        for k in KERNELS:
            k.reset_counts()
        start = time.perf_counter()
        result = demo_torch.main(argv)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - start
        launches = {fn: n for k in KERNELS for fn, n in k.fn_launches.items()}
        return result, elapsed, launches

    data_dir = os.path.join(REPO, 'experiments', 'chip_smoke_cli')
    train_launches = {}
    for env, per_epoch in (('squared', {'gae_forward': 1}),
            ('memory', {'gae_forward': 1, 'lstm_enc_forward': LSTM_PER_EPOCH,
                'lstm_enc_backward': LSTM_PER_EPOCH})):
        batch = OCEAN_CONFIGS[env][1]
        data, elapsed, launches = counted(['--env', env, '--mode', 'train',
            '--no-train.verbose', '--train.total_timesteps',
            str(CLI_EPOCHS * batch), '--train.data_dir', data_dir])
        want = dict.fromkeys(launches, 0)
        for fn, n in per_epoch.items():
            want[fn] = n * CLI_EPOCHS
        if data.epoch != CLI_EPOCHS or launches != want or \
                data.device.type != 'cuda':
            raise AssertionError(f'demo_torch --env {env}: {data.epoch} '
                f'epochs on {data.device}, launches {launches}, expected '
                f'{want}')
        losses = check_losses(data, f'demo_torch --env {env}')
        log(f'cli: demo_torch.main --env {env} (config.yaml section, '
            f'{data.vecenv.num_envs_total} lanes, batch {batch}): '
            f'{CLI_EPOCHS} epochs in {elapsed:.2f} s of main() wall, trainer '
            f'build included; launches '
            f'{json.dumps({k: v for k, v in launches.items() if v})}; '
            f'losses {json.dumps(losses)}; stats {json.dumps(data.stats)} '
            f'on {card}')
        train_launches[env] = launches
        del data

    os.environ['PUFFER_AUTOTUNE_LANES'] = ','.join(
        str(n) for n in CLI_AUTOTUNE_LANES)
    try:
        results, elapsed, launches = counted(['--env', 'squared', '--mode',
            'autotune'])
    finally:
        del os.environ['PUFFER_AUTOTUNE_LANES']
    want = dict.fromkeys(launches, 0)
    want['gae_forward'] = 9 * len(CLI_AUTOTUNE_LANES)
    if sorted(results) != list(CLI_AUTOTUNE_LANES) or launches != want:
        raise AssertionError(f'demo_torch --mode autotune: {results}, '
            f'launches {launches}, expected {want}')
    log(f'cli: demo_torch.main --mode autotune: steps/s by lanes '
        f'{json.dumps(results)} in {elapsed:.1f} s; launches '
        f'{json.dumps({k: v for k, v in launches.items() if v})} on {card}')

    gc.collect()
    torch.cuda.empty_cache()
    start = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(REPO,
        'bench_torch.py')], cwd=REPO, env=dict(os.environ, **CLI_BENCH_ENV),
        capture_output=True, text=True, timeout=600)
    elapsed = time.perf_counter() - start
    for line in proc.stderr.splitlines():
        log(f'cli: bench_torch.py: {line}')
    if proc.returncode:
        raise AssertionError(f'bench_torch.py exited {proc.returncode}')
    lines = [line for line in proc.stdout.splitlines() if line.strip()]
    for line in lines:
        print(line, flush=True)
    records = [json.loads(line) for line in lines]
    bad = [r for r in records
        if not (math.isfinite(r['value']) and r['value'] > 0)]
    if [r['metric'] for r in records] != CLI_BENCH_METRICS or bad:
        raise AssertionError(f'bench_torch.py: lines {records}, expected '
            f'{CLI_BENCH_METRICS} with finite positive values')
    log(f'cli: bench_torch.py ({CLI_BENCH_ENV}) ok in {elapsed:.1f} s')
    return train_launches


# phase 18: data parallel on the card. Each leg: (name, make_trainer's
# arguments, launches an epoch of each C function on a rank). The MLP
# (the fused head, contiguous: each rank trains on its own rows) and LSTM
# (enc5, time slabs) legs are bench.py's lines in the layouts that move no
# data; the others gather every minibatch ([r::k] of the whole batch)
DP_MLP = {'gae_forward': 1, 'mlp_head_forward': MLP_PER_EPOCH}
DP_LSTM = {'gae_forward': 1, 'lstm_enc_forward': LSTM_PER_EPOCH,
    'lstm_enc_backward': LSTM_PER_EPOCH}
DP_LEGS = (
    ('mlp', dict(use_kernel=True), DP_MLP),
    ('lstm', dict(lstm_kernel='enc5'), DP_LSTM),
    ('mlp agent-major (gather)', dict(use_kernel=True,
        mlp_contiguous_minibatches=False), DP_MLP),
    ('mlp shuffle (gather)', dict(use_kernel=True,
        shuffle_minibatches=True), DP_MLP),
    ('lstm agent-major (gather)', dict(lstm_kernel='enc5',
        lstm_time_slab_minibatches=False), DP_LSTM),
)
# the legs of the two ranks that share the card (gloo): the two layouts
# that move no data, and one through the gather path
DP2_LEGS = (0, 1, 2)
# a world-size-1 mesh against no mesh, and 2 ranks against 1: the first
# epoch's losses, each within rtol * |want| + atol. f32: the JAX mesh
# tests' tolerance; bf16: one rounding of a weight to bf16 can move a
# loss by its last bits, and the sums are taken in another order
DP_TOL = {'float32': (1e-4, 1e-5), 'bfloat16': (1e-2, 1e-4)}
DP_EPOCHS = 2


def _dp_compare(got, want, dtype_name, what):
    rtol, atol = DP_TOL[dtype_name]
    bad = {k: (got[k], v) for k, v in want.items()
        if not abs(got[k] - v) <= rtol * abs(v) + atol}
    if bad:
        raise AssertionError(f'{what}: losses (got, want) {bad} past rtol '
            f'{rtol}, atol {atol}')
    return max(abs(got[k] - v) for k, v in want.items())


def _dp_leg(torch, mesh, kwargs, per_epoch, dtype_name, what):
    """A warm-up epoch (its losses returned), then DP_EPOCHS epochs with
    every launch count set to 0 just before and read just after, checked
    against per_epoch. Returns (warm-up losses, steps/s, launches)."""
    from pufferlib_tpu_torch.ops.cuda import KERNELS
    ppo, data = make_trainer(torch, dtype_name=dtype_name, mesh=mesh,
        **kwargs)
    ppo.step(data)
    first = check_losses(data, what)
    torch.cuda.synchronize()
    for k in KERNELS:
        k.reset_counts()
    start = time.perf_counter()
    for _ in range(DP_EPOCHS):
        ppo.step(data)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    launches = {fn: n for k in KERNELS for fn, n in k.fn_launches.items()}
    want = dict.fromkeys(launches, 0)
    for fn, n in per_epoch.items():
        want[fn] = n * DP_EPOCHS
    if launches != want:
        raise AssertionError(f'{what}: launches {launches}, expected {want}')
    check_losses(data, what)
    lanes = data.carry['done'].shape[0]
    sps = DP_EPOCHS * data.config.batch_size / elapsed
    del data
    return first, sps, {k: v for k, v in launches.items() if v}, lanes


def _dp_rank(legs, dtype_names):
    """One of the two ranks that share the card: each leg of `legs` in
    each dtype, as _dp_leg. Runs in a spawned process."""
    import torch
    from pufferlib_tpu_torch.ops.cuda import KERNELS
    from pufferlib_tpu_torch.ops.cuda._build import build_all
    from pufferlib_tpu_torch.parallel import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_all(KERNELS)  # the parent's libraries: loaded, not rebuilt
    mesh = make_mesh(2)
    out = []
    for i in legs:
        name, kwargs, per_epoch = DP_LEGS[i]
        for dtype_name in dtype_names:
            out.append((i, dtype_name) + _dp_leg(torch, mesh, kwargs,
                per_epoch, dtype_name, f'rank {mesh.get_rank()}: {name} '
                f'{dtype_name}'))
    return out


def run_dp_phase(torch, card):
    """Phase 18, data parallel on the card. (a) NCCL at world size 1
    (make_mesh(1), joined in this process through a file store): each leg
    of DP_LEGS in bf16 and f32, 8192 lanes x 64, its warm-up epoch's
    losses held to the same trainer built with no mesh and the same seed
    (DP_TOL), then DP_EPOCHS counted and timed epochs: GAE once an epoch,
    the MLP head 81 times, enc5 16 times each way; the no-mesh trainer is
    counted and timed the same way first. (b) Two ranks on this
    one card over gloo (NCCL refuses two ranks on a device; gloo runs only
    all_reduce and broadcast on CUDA tensors, all the trainer calls: the
    gather path is a zero-padded all-reduce), spawned, each stepping 4096
    of the lanes through DP2_LEGS: each rank's warm-up losses held to
    (a)'s, its own launches counted as in (a). Returns (a)'s and one
    rank's launches by leg."""
    import tempfile
    import torch.distributed as dist
    from pufferlib_tpu_torch.parallel import init_distributed, make_mesh
    from pufferlib_tpu_torch.parallel.multihost import spawn
    dtypes = ('bfloat16', 'float32')
    one, launches_one = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        init_distributed('file://' + os.path.join(tmp, 'rendezvous'), 1, 0,
            device='cuda')
        try:
            mesh = make_mesh(1)
            for i, (name, kwargs, per_epoch) in enumerate(DP_LEGS):
                for dtype_name in dtypes:
                    what = f'dp world 1 (NCCL): {name} {dtype_name}'
                    want, base, _, _ = _dp_leg(torch, None, kwargs,
                        per_epoch, dtype_name, what + ', no mesh')
                    first, sps, launches, lanes = _dp_leg(torch, mesh,
                        kwargs, per_epoch, dtype_name, what)
                    err = _dp_compare(first, want, dtype_name, what)
                    one[i, dtype_name] = first
                    launches_one[i, dtype_name] = launches
                    log(f'{what}: {lanes} lanes, {sps:.1f} steps/s over '
                        f'{DP_EPOCHS} epochs after a warm-up epoch (no '
                        f'mesh: {base:.1f}) on {card}; launches '
                        f'{json.dumps(launches)}; warm-up losses within '
                        f'{err:.3g} of no mesh')
        finally:
            dist.destroy_process_group()
    ranks = spawn(_dp_rank, 2, args=(DP2_LEGS, dtypes), device='cuda',
        backend='gloo', timeout=600)
    for r, legs in enumerate(ranks):
        for i, dtype_name, first, sps, launches, lanes in legs:
            what = f'dp 2 ranks on one card (gloo), rank {r}: ' \
                f'{DP_LEGS[i][0]} {dtype_name}'
            err = _dp_compare(first, one[i, dtype_name], dtype_name, what)
            log(f'{what}: {lanes} lanes, {sps:.1f} steps/s of the whole '
                f'batch over {DP_EPOCHS} epochs after a warm-up epoch, the '
                f'card shared by both ranks, on {card}; launches '
                f'{json.dumps(launches)}; warm-up losses within {err:.3g} '
                'of world size 1')
    log('dp: tensor parallelism (a model axis) and the scaling lines need '
        'two or more cards; on this one card they were not run, and are '
        'held on the CPU only (gloo ranks: tests/test_torch_parallel.py, '
        'tests/test_torch_multihost.py)')
    return launches_one, {(i, d): launches for i, d, _, _, launches, _
        in ranks[0]}


def load_tool(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(name,
        os.path.join(REPO, 'tools', f'{name}.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


LAB_VARIANTS = ('fused', 'fused-fwd', 'xp', 'cat', 'enc', 'enc5', 'enc2',
    'enc3', 'enc4', 'enc6', 'tm')


def run_validation_path(torch):
    """The LSTM kernel-validation path through its two entry points, with
    every launch count set to 0 just before and read just after:
    tools/validate_lstm_torch.main() (lstm_scan_fused and lstm_scan
    forward + backward at T=16, B=8192, H=128, bf16, then 40 epochs of the
    1024-lane recurrent trainer through the enc5 kernels, which must reach
    score 0.9) and tools/kernel_lab_torch.main over every variant, which
    is the path that launches the archived kernels. Returns the launches
    by C function."""
    from pufferlib_tpu_torch.ops.cuda import KERNELS
    validate = load_tool('validate_lstm_torch')
    lab = load_tool('kernel_lab_torch')
    for k in KERNELS:
        k.reset_counts()
    start = time.perf_counter()
    result = validate.main()
    lab_ms = lab.main(LAB_VARIANTS)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    launches = {fn: n for k in KERNELS for fn, n in k.fn_launches.items()}
    # the proof: 40 epochs x 4 update epochs x 4 time-slab minibatches
    want = {'gae_forward': 40, 'lstm_enc_forward': 640,
        'lstm_enc_backward': 640}
    wrong = {fn: launches[fn] for fn, n in want.items() if launches[fn] < n}
    idle = [fn for fn in ('lstm_scan_forward', 'lstm_scan_backward',
        'lstm_fused_forward', 'lstm_fused_backward', 'lstm_enc_step_backward',
        'lstm_cat_forward', 'lstm_cat_backward', 'lstm_enc2_forward',
        'lstm_enc2_backward', 'lstm_enc3_backward', 'lstm_enc4_backward',
        'lstm_enc6_backward', 'lstm_tm_step_forward', 'lstm_tm_step_backward')
        if launches[fn] == 0]
    if wrong or idle:
        raise AssertionError(f'validation path: launches {launches}; too few '
            f'of {wrong}, none of {idle}')
    learning = result['learning']
    if not (learning['score'] > 0.9 and learning['steps'] == 40 * 65536):
        raise AssertionError(f'validation path: {learning}')
    log(f'validation path: score {learning["score"]:.4f} after '
        f'{learning["steps"]} steps in {learning["seconds"]:.1f} s; timings '
        f'{json.dumps(result["timings"])}; lab '
        f'{json.dumps({" ".join(k): v for k, v in lab_ms.items()})}; '
        f'{elapsed:.1f} s in all on {result["card"]}; launches '
        f'{json.dumps({k: v for k, v in launches.items() if v})}')
    return launches


def check_card_against_cpu(torch, np):
    """One trainer update (GAE kernel, with and without the MLP head
    kernel) on the card, held against the same on the CPU from the same
    weights and batch. f32; params to 1e-4 (sums in other orders through
    Adam)."""
    T, N, mb = 16, 256, 1024
    rng = np.random.RandomState(1)
    batch = dict(
        obs=rng.choice([-1.0, 0.0, 1.0], size=(T, N, 49),
            p=[0.05, 0.9, 0.05]).astype(np.float32),
        action=rng.randint(0, 8, (T, N)),
        logprob=(np.log(1 / 8) + rng.randn(T, N) * 0.05).astype(np.float32),
        value=(rng.randn(T, N) * 0.3).astype(np.float32),
        reward=rng.uniform(-1, 1, (T, N)).astype(np.float32),
        done=(rng.rand(T, N) < 0.3).astype(np.float32),
        last_value=(rng.randn(N) * 0.3).astype(np.float32),
    )
    for use_kernel in (False, True):
        results = []
        for device in ('cpu', 'cuda'):
            ppo, data = make_trainer(torch, num_envs=N, horizon=T,
                hidden=32, dtype_name='float32', use_kernel=use_kernel,
                minibatch_size=mb, device=device)
            stats = data.update_fn({k: torch.from_numpy(v).to(device)
                for k, v in batch.items()}, 3e-3)
            results.append((
                {k: v.detach().cpu() for k, v in
                    data.policy.state_dict().items()},
                {k: v.item() for k, v in stats.items()}))
        (cpu_params, cpu_stats), (gpu_params, gpu_stats) = results
        err = max((cpu_params[k] - gpu_params[k]).abs().max().item()
            for k in cpu_params)
        stat_err = max(abs(cpu_stats[k] - gpu_stats[k]) for k in cpu_stats)
        if not err <= 1e-4:
            raise AssertionError(f'update on the card vs CPU '
                f'(use_kernel={use_kernel}): params differ by {err}')
        log(f'update card vs CPU, f32, use_kernel={use_kernel}: params max '
            f'abs diff {err:.3g} (tol 1e-4), stats max abs diff '
            f'{stat_err:.3g}')



def check_lstm_card_against_cpu(torch, np):
    """One recurrent update (time slabs, T = 16 per minibatch, N = 256,
    f32) through the enc5 and the cat kernels at hidden 32 and through
    enc5's streamed design at hidden 256 on the card, and through their
    plain versions on the CPU, from the same weights and batch. Params
    within 1e-4, as the MLP update: the same f32 math with sums in other
    orders, through Adam."""
    T, N, mb, h = 32, 256, 4096, 16
    rng = np.random.RandomState(2)
    batch = dict(
        obs=rng.choice([-1.0, 0.0, 1.0], size=(T, N, 49),
            p=[0.05, 0.9, 0.05]).astype(np.float32),
        action=rng.randint(0, 8, (T, N)),
        logprob=(np.log(1 / 8) + rng.randn(T, N) * 0.05).astype(np.float32),
        value=(rng.randn(T, N) * 0.3).astype(np.float32),
        reward=rng.uniform(-1, 1, (T, N)).astype(np.float32),
        done=(rng.rand(T, N) < 0.3).astype(np.float32),
        last_value=(rng.randn(N) * 0.3).astype(np.float32),
    )
    lstm0 = {32: (rng.randn(2, T // h, 1, N, 32) * 0.5).astype(np.float32)}
    lstm0[256] = (rng.randn(2, T // h, 1, N, 256) * 0.5).astype(np.float32)
    from pufferlib_tpu_torch.ops.cuda import KERNELS
    for kernel, hidden, fn in (('enc5', 32, 'lstm_enc'),
            ('cat', 32, 'lstm_cat'), ('enc5', 256, 'lstm_enc_stream')):
        results = []
        for device in ('cpu', 'cuda'):
            ppo, data = make_trainer(torch, num_envs=N, horizon=T,
                hidden=hidden, dtype_name='float32', minibatch_size=mb,
                device=device, lstm_kernel=kernel, lstm_use_kernel=True)
            b = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
            b['lstm0'] = tuple(torch.from_numpy(s).to(device)
                for s in lstm0[hidden])
            for k in KERNELS:
                k.reset_counts()
            stats = data.update_fn(b, 3e-3)
            results.append((
                {k: v.detach().cpu() for k, v in
                    data.policy.state_dict().items()},
                {k: v.item() for k, v in stats.items()}))
        launched = {name: n for k in KERNELS
            for name, n in k.fn_launches.items() if n}
        if not launched.get(f'{fn}_forward') or not launched.get(
                f'{fn}_backward'):
            raise AssertionError(f'recurrent update kernel={kernel} hidden '
                f'{hidden}: {fn} not launched ({launched})')
        (cpu_params, cpu_stats), (gpu_params, gpu_stats) = results
        err = max((cpu_params[k] - gpu_params[k]).abs().max().item()
            for k in cpu_params)
        stat_err = max(abs(cpu_stats[k] - gpu_stats[k]) for k in cpu_stats)
        if not err <= 1e-4:
            raise AssertionError(f'recurrent update on the card vs CPU '
                f'(kernel={kernel}, hidden {hidden}): params differ by {err}')
        log(f'recurrent update card vs CPU, f32, kernel={kernel}, hidden '
            f'{hidden} ({fn}): params max abs diff {err:.3g} (tol 1e-4), '
            f'stats max abs diff {stat_err:.3g}')


# phase 19: the transformer family and self-play. The wrapper at the bench
# line's width; its stepwise calls against one segment within XF_TOL
# (rtol, atol): in f32 1e-5 (the same f32 math, cuBLAS choosing other
# algorithms for B and T * B rows); in bf16 the window within one bf16
# ulp (2^-7 relative: an encoder row summed in another order may round the
# other way), logits and values within 0.05 absolute + 2% (such an ulp
# carried through the attention, the FFN and the head)
XF_WIDTH = dict(hidden=128, window=16, B=8192)
XF_TOL = {'float32': dict(window=(1e-5, 1e-5), out=(1e-5, 1e-5)),
    'bfloat16': dict(window=(2.0 ** -7, 0.0), out=(0.02, 0.05))}
# tests/test_transformer.py:105-153's memory learning test (mem_length 2,
# mem_delay 0; bptt 4, lr 0.01, ent_coef 0.01, f32)
XF_PROOF = dict(lanes=128, hidden=64, window=8, epochs=60, goal=0.9)
XF_OBS = (7, 7)


def make_transformer_module(torch, hidden, window, dtype, device, seed=0):
    """TransformerWrapper(Default) on squared's observation shape with
    five actions, 4 heads, its recency bias drawn from a normal (the init's
    zeros would hide it), on `device`."""
    from pufferlib_tpu_torch import spaces
    from pufferlib_tpu_torch.models import Default, TransformerWrapper
    module = TransformerWrapper(Default(obs_shape=XF_OBS,
        action_space=spaces.Discrete(5), hidden_size=hidden, dtype=dtype,
        generator=torch.Generator().manual_seed(seed)), obs_shape=XF_OBS,
        input_size=hidden, hidden_size=hidden, window=window, num_heads=4,
        dtype=dtype, generator=torch.Generator().manual_seed(seed + 1))
    with torch.no_grad():
        module.rel_bias.normal_(generator=torch.Generator().manual_seed(
            seed + 2))
    return module.to(device)


def _within(got, want, rtol, atol):
    """(max abs difference, every element within atol + rtol * |want|)."""
    diff = (got.float() - want.float()).abs()
    return diff.max().item(), bool((diff <= atol + rtol
        * want.float().abs()).all())


def check_transformer_steps(torch, dtype_name, device='cuda', hidden=128,
        window=16, B=8192):
    """T stepwise calls against one T-step segment from a random window,
    T = 16 (the bench's bptt; batch-major) and 20 (past the window;
    time-major): logits, values and the final window within XF_TOL; the
    window comes back in f32, the state's dtype."""
    dtype = getattr(torch, dtype_name)
    module = make_transformer_module(torch, hidden, window, dtype, device)
    gen = torch.Generator(device=device).manual_seed(5)
    tol = XF_TOL[dtype_name]
    errs = {}
    for T, time_major in ((16, False), (20, True)):
        obs = torch.randn((T, B) + XF_OBS, generator=gen, device=device)
        state = (torch.randn((window, B, hidden), generator=gen,
            device=device), torch.zeros((1, B, hidden), device=device))
        with torch.no_grad():
            st, logits, values = state, [], []
            for t in range(T):
                lg, vl, st = module(obs[t], st)
                logits.append(lg)
                values.append(vl)
            x = obs if time_major else obs.transpose(0, 1)
            lg, vl, seg = module(x, state, time_major=time_major)
        lead = (T, B) if time_major else (B, T)
        lg, vl = lg.reshape(lead + (-1,)), vl.reshape(lead + (-1,))
        if not time_major:
            lg, vl = lg.transpose(0, 1), vl.transpose(0, 1)
        if st[0].dtype != torch.float32 or seg[0].dtype != torch.float32:
            raise AssertionError(f'transformer {dtype_name}: the window '
                f'came back in {st[0].dtype} / {seg[0].dtype}, not f32')
        for name, a, b, key in (('logits', torch.stack(logits), lg, 'out'),
                ('values', torch.stack(values), vl, 'out'),
                ('window', st[0], seg[0], 'window')):
            err, ok = _within(a, b, *tol[key])
            errs[f'T={T} {name}'] = err
            if not ok:
                raise AssertionError(f'transformer {dtype_name} steps vs '
                    f'segment, T = {T}: {name} differ by {err} (rtol, atol '
                    f'{tol[key]})')
    log(f'transformer steps vs segment, {dtype_name}, B {B}, hidden '
        f'{hidden}, window {window}, 4 heads (T 16 batch-major, 20 '
        f'time-major): max abs differences {json.dumps(errs)} within '
        f'(rtol, atol) {json.dumps(tol)}')


def check_transformer_card_against_cpu(torch):
    """The same weights on the CPU and the card, f32, B 64, hidden 32,
    window 8: a 20-step time-major segment from a random window and one
    step after it; logits, values and window within 1e-5 (sums in other
    orders)."""
    import copy
    B, T, hidden, window = 64, 20, 32, 8
    cpu = make_transformer_module(torch, hidden, window, torch.float32,
        'cpu', seed=3)
    card = copy.deepcopy(cpu).to('cuda')
    gen = torch.Generator().manual_seed(6)
    obs = torch.randn((T + 1, B) + XF_OBS, generator=gen)
    state = (torch.randn((window, B, hidden), generator=gen),
        torch.zeros((1, B, hidden)))
    outs = []
    for module, device in ((cpu, 'cpu'), (card, 'cuda')):
        st = tuple(s.to(device) for s in state)
        with torch.no_grad():
            lg, vl, st = module(obs[:T].to(device), st, time_major=True)
            lg1, vl1, st = module(obs[T].to(device), st)
        outs.append([v.cpu() for v in (lg, vl, lg1, vl1, st[0])])
    err = max(_within(a, b, 0, 0)[0] for a, b in zip(*outs))
    if not err <= 1e-5:
        raise AssertionError(f'transformer card vs CPU: differ by {err}')
    log(f'transformer card vs CPU, f32, B {B}, T {T} + 1, hidden {hidden}, '
        f'window {window}: max abs diff {err:.3g} (tol 1e-5)')


def run_transformer_trainer(torch, card, epochs=2):
    """bench_torch.py's transformer line (8192 lanes x 64, Default +
    TransformerWrapper h128 bf16, window 16, minibatch batch / 4): a
    warm-up epoch, then `epochs` calls of ppo.step with every launch count
    set to 0 just before and read just after (GAE once an epoch, no other
    kernel: the attention is plain torch), then the rollout and the update
    of an epoch each timed and under the profiler (device time, idle
    share, launches). Returns GAE's launches."""
    from pufferlib_tpu_torch.ops.cuda import KERNELS
    torch.cuda.reset_peak_memory_stats()
    num_envs, horizon = 8192, 64
    ppo, data = make_trainer(torch, num_envs=num_envs, horizon=horizon,
        hidden=XF_WIDTH['hidden'], minibatch_size=num_envs * horizon // 4,
        transformer_window=XF_WIDTH['window'])
    ppo.step(data)  # warm-up epoch
    torch.cuda.synchronize()
    for k in KERNELS:
        k.reset_counts()
    start = time.perf_counter()
    for _ in range(epochs):
        ppo.step(data)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    launches = {fn: n for k in KERNELS for fn, n in k.fn_launches.items()}
    want = dict.fromkeys(launches, 0)
    want['gae_forward'] = epochs
    if launches != want:
        raise AssertionError(f'transformer trainer: launches {launches} in '
            f'{epochs} epochs, expected {want}')
    losses = check_losses(data, 'transformer trainer')
    sps = epochs * data.config.batch_size / elapsed
    profile_phase = load_tool('profile_torch_trainer').profile_phase

    def rollout_fn():
        data.carry, batch, _, _ = data.rollout_fn(data.carry)
        return batch
    batch, rollout = profile_phase(torch, rollout_fn)
    _, update = profile_phase(torch,
        lambda: data.update_fn(batch, data.config.learning_rate))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f'transformer trainer 8192 lanes x 64, Default + TransformerWrapper '
        f'h128 bf16 (window 16, 4 heads), minibatch 131072: {sps:.1f} '
        f'steps/s over {epochs} epochs after a warm-up epoch '
        f'({elapsed / epochs * 1e3:.2f} ms/epoch) on {card}; launches an '
        f'epoch: GAE {launches["gae_forward"] // epochs}; losses '
        f'{json.dumps(losses)}; peak memory {peak:.2f} GiB')
    for name, r in (('rollout', rollout), ('update', update)):
        log(f'transformer trainer {name}: wall {r["wall_ms"]:.2f} ms, '
            f'kernels {r["device_ms"]:.2f} ms, idle {r["idle_share"]:.3f}, '
            f'{r["launches"]} launches; top {r["top"]}')
    del data
    return launches['gae_forward']


def run_transformer_proof(torch, card):
    """tests/test_transformer.py's memory learning test on the card: the
    best score must pass XF_PROOF's goal within its epochs (stopping
    there); GAE once an epoch, no other kernel. Returns GAE's launches."""
    import pufferlib_tpu_torch.vector as vector
    from pufferlib_tpu_torch.models import (
        Default, TransformerPolicy, TransformerWrapper)
    from pufferlib_tpu_torch.ocean import env_creator
    from pufferlib_tpu_torch.ops.cuda import KERNELS
    from pufferlib_tpu_torch.training import ppo
    p = XF_PROOF
    lanes, hidden = p['lanes'], p['hidden']
    vecenv = vector.make(env_creator('memory'),
        env_kwargs=dict(mem_length=2, mem_delay=0), num_envs=lanes,
        device='cuda')
    shape = vecenv.single_observation_space.shape
    policy = TransformerPolicy(TransformerWrapper(Default(obs_shape=shape,
        action_space=vecenv.single_action_space, hidden_size=hidden,
        generator=torch.Generator().manual_seed(0)), obs_shape=shape,
        input_size=hidden, hidden_size=hidden, window=p['window'],
        num_heads=4, generator=torch.Generator().manual_seed(1)))
    batch = lanes * 32
    total = batch * p['epochs']
    data = ppo.create(ppo.default_config(env='memory', batch_size=batch,
        minibatch_size=lanes * 8, bptt_horizon=4, total_timesteps=total,
        learning_rate=0.01, ent_coef=0.01, verbose=False,
        data_dir=os.path.join(REPO, 'experiments', 'chip_smoke'),
        checkpoint_interval=10 ** 6, device='cuda'), vecenv, policy)
    for k in KERNELS:
        k.reset_counts()
    start = time.perf_counter()
    best, epochs = 0.0, 0
    while data.global_step < total:
        stats, _ = ppo.evaluate(data)
        ppo.train(data)
        epochs += 1
        best = max(best, stats.get('score', 0.0))
        if best > p['goal']:
            break
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    launches = {fn: n for k in KERNELS for fn, n in k.fn_launches.items()
        if n}
    if launches != {'gae_forward': epochs}:
        raise AssertionError(f'transformer proof: launches {launches} in '
            f'{epochs} epochs')
    if not best > p['goal']:
        raise AssertionError(f'transformer proof: best score {best} after '
            f'{epochs} epochs')
    check_losses(data, 'transformer proof')
    log(f'learning proof memory through TransformerWrapper (mem_length 2, '
        f'{lanes} lanes, h{hidden} f32, window {p["window"]}): best score '
        f'{best:.4f} after {epochs} epochs in {elapsed:.1f} s; launches '
        f'{json.dumps(launches)} on {card}')
    return epochs


def check_policy_pool(torch):
    """PolicyPool on the card: two Default policies whose heads force
    actions 0 and 1 route each agent by the cycle selector; a pool of two
    TransformerPolicy state_dicts (the bench width, 8192 agents) gives
    each agent its own policy's row: actions exact, logprobs, values and
    the routed window and aux within 1e-6 of each policy run alone on the
    same uniforms."""
    from pufferlib_tpu_torch import spaces
    from pufferlib_tpu_torch.models import Default, Policy, TransformerPolicy
    from pufferlib_tpu_torch.policy_pool import PolicyPool
    B = XF_WIDTH['B']
    policy = Policy(Default(obs_shape=(4,), action_space=spaces.Discrete(2),
        hidden_size=8, generator=torch.Generator().manual_seed(0))).cuda()
    forced = []
    for logit0 in (50.0, -50.0):
        state = {k: v.clone() for k, v in policy.state_dict().items()}
        state['module.head.weight'].zero_()
        state['module.head.bias'].copy_(torch.tensor([logit0, -logit0, 0.0]))
        forced.append(state)
    pool = PolicyPool(policy, forced, learner_mask=[True, False],
        num_agents=B)
    gen = torch.Generator(device='cuda').manual_seed(7)
    with torch.no_grad():
        actions = pool.forward(torch.zeros((B, 4), device='cuda'),
            generator=gen)[0]
    if not torch.equal(actions, pool.policy_map):
        raise AssertionError('policy pool: actions do not follow the map')

    hidden, window = XF_WIDTH['hidden'], XF_WIDTH['window']
    members = [TransformerPolicy(make_transformer_module(torch, hidden,
        window, torch.float32, 'cuda', seed=seed)) for seed in (10, 20)]
    pool = PolicyPool(members[0], [m.state_dict() for m in members],
        learner_mask=[True, False], num_agents=B)
    obs = torch.randn((B,) + XF_OBS, generator=gen, device='cuda')
    state = (torch.randn((window, B, hidden), generator=gen, device='cuda'),
        torch.zeros((1, B, hidden), device='cuda'))
    u = [torch.rand((B,), generator=gen, device='cuda') for _ in members]
    with torch.no_grad():
        got = pool.forward(obs, state, u=u)
        alone = [m(obs, state, u=u[i]) for i, m in enumerate(members)]
    pick = pool.policy_map
    err = 0.0
    for i in range(4):
        want = torch.where(pick.reshape((B,) + (1,) * (alone[0][i].dim()
            - 1)) == 0, alone[0][i], alone[1][i])
        if i == 0:
            if not torch.equal(got[0], want):
                raise AssertionError('transformer pool: actions differ')
        else:
            err = max(err, _within(got[i].reshape(want.shape), want, 0,
                0)[0])
    for j in range(2):
        want = torch.where(pick[None, :, None] == 0, alone[0][4][j],
            alone[1][4][j])
        err = max(err, _within(got[4][j], want, 0, 0)[0])
    if not err <= 1e-6:
        raise AssertionError(f'transformer pool: rows differ by {err}')
    log(f'policy pool on the card: forced heads follow the cycle map over '
        f'{B} agents; TransformerPolicy pool (h{hidden}, window {window}) '
        f'against each policy alone: actions equal, max abs diff {err:.3g} '
        f'(tol 1e-6)')


def run_selfplay_example(torch, card):
    """examples/selfplay_torch.py on the card (its main, in this
    process): the store, the pool and the ranker over 16 steps."""
    import importlib.util
    import math
    spec = importlib.util.spec_from_file_location('selfplay_torch',
        os.path.join(REPO, 'examples', 'selfplay_torch.py'))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    result = example.main(['--device', 'cuda', '--store',
        os.path.join(REPO, 'experiments', 'chip_smoke_selfplay')])
    values = list(result['scores'].values()) + list(
        result['ratings'].values())
    if sorted(result['ratings']) != ['learner', 'model_000000'] or not all(
            math.isfinite(v) for v in values):
        raise AssertionError(f'selfplay example: {result}')
    log(f'examples/selfplay_torch.py on {card}: scores '
        f'{json.dumps(result["scores"])}, ratings '
        f'{json.dumps(result["ratings"])}')


def run_transformer_phase(torch, card):
    """Phase 19. Returns (GAE launches in the bench-width trainer's
    counted epochs, GAE launches in the memory proof)."""
    for dtype_name in ('float32', 'bfloat16'):
        check_transformer_steps(torch, dtype_name)
    check_transformer_card_against_cpu(torch)
    gae_launches = run_transformer_trainer(torch, card)
    proof_launches = run_transformer_proof(torch, card)
    check_policy_pool(torch)
    run_selfplay_example(torch, card)
    return gae_launches, proof_launches


# phase 20: the zoo policies that reach an LSTM kernel, and the frameworks
# bridge. NETHACK is config.yaml's nethack section (config.yaml:320-332)
# at its own widths: nethack.Policy h256 in LSTMWrapper(256, 256), f32,
# 128 envs, batch 32768, minibatch 8192, bptt 16, lr 2.5e-4, through
# HostMultiprocessing (8 workers, the card machine's cores, 64 envs a
# recv: two groups in flight) and ppo_host. The update runs cat's streamed
# design at T 16, B 512 (8192 / 16), D = H = 256 in f32; the flat GAE once
# an epoch.
NETHACK = dict(num_envs=128, num_workers=8, env_batch=64, batch_size=32768,
    minibatch_size=8192, bptt=16, lr=2.5e-4, hidden=256)
# the other zoo sections, one counted epoch each (after a warm-up epoch)
# through ppo_host on HostSerial over the fakes of
# environments/test/host_fixtures.py, at each section's batch, minibatch,
# learning rate and widths; the cuts: nmmo 128 agents an env and nmmo3 64
# (the fakes'); pokemon_red 64 envs in one process (the section's 48 do
# not tile its batch of 32768, and its 24 workers are past the machine's
# 8 cores)
ZOO_OTHERS = {
    'nmmo': dict(num_envs=4, agents=128, batch_size=32768,
        minibatch_size=8192, lr=1.5e-4, hidden=256),
    'nmmo3': dict(num_envs=8, agents=64, batch_size=65536,
        minibatch_size=16384, lr=1.5e-4, hidden=256),
    'pokemon_red': dict(num_envs=64, batch_size=32768, minibatch_size=8192,
        lr=2.5e-4, hidden=512),
}
# cat's streamed pair at the shapes of those updates, in f32: (T, B, D, H)
ZOO_CAT_SHAPES = ((16, 512, 256, 256), (16, 1024, 256, 256),
    (16, 512, 512, 512))
# the frameworks check: a reference LSTMWrapper(Default) checkpoint at h128
# on squared (49 features, 8 actions), on an (8192, 16) segment batch
IMPORT_CHECK = dict(B=8192, T=16, hidden=128, features=49, actions=8)


def reference_checkpoint(torch, features, actions, hidden, seed=0):
    """A reference PufferLib LSTMWrapper(Default) state_dict in the
    reference's own key layout (policy.encoder / decoder / value_head,
    recurrent.* of nn.LSTM with its two biases), drawn from a numpy seed;
    float32 CPU tensors."""
    import numpy as np
    rng = np.random.RandomState(seed)

    def draw(*shape, scale):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(
            np.float32))
    H = hidden
    return {
        'policy.encoder.weight': draw(H, features, scale=features ** -0.5),
        'policy.encoder.bias': draw(H, scale=0.1),
        'policy.decoder.weight': draw(actions, H, scale=H ** -0.5),
        'policy.decoder.bias': draw(actions, scale=0.1),
        'policy.value_head.weight': draw(1, H, scale=H ** -0.5),
        'policy.value_head.bias': draw(1, scale=0.1),
        'recurrent.weight_ih_l0': draw(4 * H, H, scale=H ** -0.5),
        'recurrent.weight_hh_l0': draw(4 * H, H, scale=H ** -0.5),
        'recurrent.bias_ih_l0': draw(4 * H, scale=0.1),
        'recurrent.bias_hh_l0': draw(4 * H, scale=0.1),
    }


def reference_modules(torch, state_dict, device):
    """The reference LSTMWrapper(Default)'s math as torch modules loaded
    from its state_dict: nn.Linear encoder + relu, nn.LSTM (batch first),
    nn.Linear decoder and value head. {name: module}."""
    nn = torch.nn
    sd = state_dict
    H, F = sd['policy.encoder.weight'].shape
    mods = dict(encoder=nn.Linear(F, H), lstm=nn.LSTM(H, H, batch_first=True),
        decoder=nn.Linear(H, sd['policy.decoder.weight'].shape[0]),
        value_head=nn.Linear(H, 1))
    with torch.no_grad():
        for name in ('encoder', 'decoder', 'value_head'):
            mods[name].weight.copy_(sd[f'policy.{name}.weight'])
            mods[name].bias.copy_(sd[f'policy.{name}.bias'])
        for k, v in mods['lstm'].named_parameters():
            v.copy_(sd[f'recurrent.{k}'])
    return {k: m.to(device) for k, m in mods.items()}


def reference_math(mods, x, state):
    """The reference policy on x (B, T, features) from state (h, c), each
    (1, B, H): (logits (B * T, actions), value (B * T, 1), (h, c))."""
    B, T = x.shape[:2]
    hidden = mods['encoder'](x.reshape(B * T, -1)).relu()
    outs, (h, c) = mods['lstm'](hidden.reshape(B, T, -1), state)
    flat = outs.reshape(B * T, -1)
    return mods['decoder'](flat), mods['value_head'](flat), (h, c)


def reference_grads(mods):
    """The reference modules' parameter gradients in the reference's key
    layout, bias_hh's zeroed: convert sums the two biases, whose gradients
    are equal, so that the converted gradients are the port's."""
    out = {f'policy.{name}.{k}': v.grad for name in ('encoder', 'decoder',
        'value_head') for k, v in mods[name].named_parameters()}
    for k, v in mods['lstm'].named_parameters():
        out[f'recurrent.{k}'] = v.grad.new_zeros(v.grad.shape) if \
            k.startswith('bias_hh') else v.grad
    return out


def check_reference_import(torch, card, device='cuda', B=None, T=None,
        hidden=None):
    """A seeded reference checkpoint converted by torch_import.convert into
    the port's LSTMWrapper(Default) and held, on (B, T) segments, through
    the port's kernel route (enc5) and its plain route (use_kernel=False),
    to the reference math: logits, values, h, c and every weight gradient
    (through autograd) within IMPORT_TOL of their scale. Returns the
    kernel route's launches by C function."""
    import numpy as np
    from pufferlib_tpu_torch import spaces
    from pufferlib_tpu_torch.frameworks import torch_import
    from pufferlib_tpu_torch.models import Default, LSTMWrapper
    from pufferlib_tpu_torch.ops.cuda import KERNELS
    c = IMPORT_CHECK
    B, T, H = B or c['B'], T or c['T'], hidden or c['hidden']
    F, A = c['features'], c['actions']
    ref_sd = reference_checkpoint(torch, F, A, H)
    mods = reference_modules(torch, ref_sd, device)
    lstm = LSTMWrapper(Default((7, 7), spaces.Discrete(A), hidden_size=H,
        decoder_input_size=H), obs_shape=(7, 7), input_size=H,
        hidden_size=H).to(device)
    lstm.load_state_dict(torch_import.convert(ref_sd))
    rng = np.random.RandomState(7)
    x = torch.as_tensor(rng.randn(B, T, 7, 7).astype(np.float32),
        device=device)
    state = tuple(torch.as_tensor((rng.randn(1, B, H) * 0.5).astype(
        np.float32), device=device) for _ in range(2))
    g_logits = torch.as_tensor(rng.randn(B * T, A).astype(np.float32),
        device=device)
    g_value = torch.as_tensor(rng.randn(B * T, 1).astype(np.float32),
        device=device)

    def loss(logits, value, h, c):
        return (logits * g_logits).sum() + (value * g_value).sum() + \
            h.sum() + c.sum()
    logits, value, (h, c) = reference_math(mods, x.reshape(B, T, F), state)
    loss(logits, value, h, c).backward()
    want = [logits.detach(), value.detach(), h.detach(), c.detach()]
    want_grads = {k: v.to(device) for k, v in torch_import.convert(
        reference_grads(mods)).items()}
    errs, launches = {}, None
    # the card's default route, use_kernel=None; on the CPU (a rehearsal)
    # True runs enc5's plain version
    for route, use_kernel in (('enc5', None if device == 'cuda' else True),
            ('off', False)):
        lstm.use_kernel = use_kernel
        if device == 'cuda' and lstm.route(T, x.device) != route:
            raise AssertionError(f'reference import: route '
                f'{lstm.route(T, x.device)}, expected {route}')
        lstm.zero_grad()
        for k in KERNELS:
            k.reset_counts()
        logits, value, (h, c) = lstm(x, state)
        loss(logits, value, h, c).backward()
        if device == 'cuda':
            torch.cuda.synchronize()
        if route == 'enc5':
            launches = {fn: n for k in KERNELS for fn, n in
                k.fn_launches.items() if n}
            want_launches = {'lstm_enc_forward': 1, 'lstm_enc_backward': 1}
            if device == 'cuda' and launches != want_launches:
                raise AssertionError(f'reference import: launches '
                    f'{launches}, expected {want_launches}')
        got = [logits, value, h, c]
        got_grads = {k: v.grad for k, v in lstm.named_parameters()}
        for name, a, w in list(zip(FORWARD, got, want)) + [(k, got_grads[k], want_grads[k]) for k in
                sorted(want_grads)]:
            err = (a.detach() - w).abs().max().item()
            scale = max(1.0, w.abs().max().item())
            if not (torch.isfinite(a).all() and err <= IMPORT_TOL * scale):
                raise AssertionError(f'reference import, {route} route, '
                    f'{name}: max abs err {err} > {IMPORT_TOL} x {scale:.4g}')
            errs[route, name] = err / scale
    log(f'reference LSTMWrapper(Default) h{H} through torch_import.convert, '
        f'(B {B}, T {T}) f32, against nn.Linear + nn.LSTM + split heads '
        f'on {device}, outputs and gradients: max abs err / max(1, max '
        f'|reference|) enc5 route '
        f'{max(v for (r, _), v in errs.items() if r == "enc5"):.3g}, plain '
        f'route {max(v for (r, _), v in errs.items() if r == "off"):.3g} '
        f'(tol {IMPORT_TOL}); forward alone (logits, value, h, c) '
        f'{max(v for (r, n), v in errs.items() if n in FORWARD):.3g}; enc5 '
        f'launches {json.dumps(launches)} on {card}')
    return launches, ref_sd


# the converted checkpoint against the reference math in f32: the port's
# scans and cuDNN's sum in other orders over 16 steps (and the weight
# gradients over 131072 rows)
IMPORT_TOL = 1e-4
FORWARD = ('logits', 'value', 'h', 'c')


def run_reference_eval(torch, card, ref_sd, steps=3):
    """demo_torch.py --mode eval plays the reference checkpoint (saved in
    the reference's layout) on squared with the LSTM (config.cli's
    default hidden size, 128) for a few steps."""
    import contextlib
    import io
    sys.path.insert(0, REPO)
    import demo_torch
    path = os.path.join(REPO, 'experiments', 'chip_smoke',
        'reference_lstm_h128.pt')
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(ref_sd, path)
    os.environ['PUFFER_EVAL_STEPS'] = str(steps)
    os.environ['PUFFER_EVAL_DELAY'] = '0'
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        demo_torch.main(['--env', 'squared', '--mode', 'eval',
            '--model-path', path, '--use-rnn', 'True'])
    rewards = [line for line in out.getvalue().splitlines()
        if line.startswith('Reward:')]
    if len(rewards) != steps:
        raise AssertionError(f'demo_torch eval of the reference checkpoint:'
            f' {out.getvalue()[-500:]}')
    log(f'demo_torch.py --mode eval --model-path (a reference-layout '
        f'LSTMWrapper(Default) h128 state_dict) on squared: {steps} steps, '
        f'{rewards} on {card}')


def _zoo_lstm(torch, policy, shape, hidden):
    from pufferlib_tpu_torch.models import LSTMWrapper, RecurrentPolicy
    lstm = LSTMWrapper(policy, obs_shape=shape, input_size=hidden,
        hidden_size=hidden, generator=torch.Generator().manual_seed(1))
    route = lstm.route(16, torch.device('cuda'))
    if route != 'cat':
        raise AssertionError(f'zoo: LSTM route {route}, expected cat')
    return RecurrentPolicy(lstm)


def _zoo_config(name, batch_size, minibatch_size, lr):
    from pufferlib_tpu_torch.training import ppo_host
    return ppo_host.default_config(env=name, batch_size=batch_size,
        minibatch_size=minibatch_size, bptt_horizon=16, learning_rate=lr,
        total_timesteps=batch_size * 1000, verbose=False,
        data_dir=os.path.join(REPO, 'experiments', 'chip_smoke'),
        checkpoint_interval=10 ** 6, seed=0)


def _zoo_want(config, launches, epochs):
    """The launches an epoch of a zoo trainer must make: the flat GAE once,
    cat's streamed pair once a minibatch, nothing else."""
    minibatches = config.update_epochs * (config.batch_size
        // config.minibatch_size)
    want = dict.fromkeys(launches, 0)
    want['gae_forward'] = epochs
    want['lstm_cat_stream_forward'] = want['lstm_cat_stream_backward'] = \
        minibatches * epochs
    return want


def run_nethack_trainer(torch, card, epochs=2):
    """NETHACK through HostMultiprocessing and ppo_host: a warm-up epoch,
    then `epochs` counted. Returns (launches by C function, peak memory
    bytes)."""
    from pufferlib_tpu_torch import vector_host
    from pufferlib_tpu_torch.environments.nethack.policy import Policy
    from pufferlib_tpu_torch.environments.test.host_fixtures import (
        make_fake_nethack)
    from pufferlib_tpu_torch.ops.cuda.lstm_common import cat_design
    from pufferlib_tpu_torch.training import ppo_host
    n, H = NETHACK, NETHACK['hidden']
    vec = vector_host.make(make_fake_nethack,
        backend=vector_host.HostMultiprocessing, num_envs=n['num_envs'],
        num_workers=n['num_workers'], batch_size=n['env_batch'])
    shape = vec.single_observation_space.shape
    policy = _zoo_lstm(torch, Policy(shape, vec.single_action_space,
        emulated=vec.emulated, hidden_size=H,
        generator=torch.Generator().manual_seed(0)), shape, H)
    config = _zoo_config('nethack', n['batch_size'], n['minibatch_size'],
        n['lr'])
    torch.cuda.reset_peak_memory_stats()
    data = ppo_host.create(config, vec, policy)
    try:
        elapsed, launches = _host_epochs(torch, ppo_host, data, epochs)
    finally:
        ppo_host.close(data)
    peak = torch.cuda.max_memory_allocated()
    want = _zoo_want(config, launches, epochs)
    if launches != want:
        raise AssertionError(f'nethack: launches {launches}, expected {want}')
    if 'episode_return' not in data.stats:
        raise AssertionError(f'nethack: no episode stats ({data.stats})')
    design = cat_design(H, H, torch.float32)
    _host_line(data, f'nethack host trainer ({n["num_envs"]} fake NLE envs '
        f'in {n["num_workers"]} workers, {n["env_batch"]} a recv; '
        f'nethack.Policy h{H} + LSTM {H} f32 (cat, {design} design), batch '
        f'{n["batch_size"]}, minibatch {n["minibatch_size"]}, bptt '
        f'{n["bptt"]}, lr {n["lr"]}; peak memory {peak / 2 ** 30:.2f} GiB)',
        elapsed, epochs, launches, card)
    return launches, peak


def run_zoo_other(torch, card, name):
    """A ZOO_OTHERS section through HostSerial and ppo_host over its
    fake: a warm-up epoch, then one counted. Returns the launches by C
    function."""
    import functools
    from pufferlib_tpu_torch import vector_host
    from pufferlib_tpu_torch.environments.test import host_fixtures
    from pufferlib_tpu_torch.training import ppo_host
    z = ZOO_OTHERS[name]
    H = z['hidden']
    g = torch.Generator().manual_seed(0)
    if name == 'nmmo':
        from pufferlib_tpu_torch.environments.nmmo.policy import Policy
        creator = functools.partial(host_fixtures.make_fake_nmmo,
            z['agents'])
    elif name == 'nmmo3':
        from pufferlib_tpu_torch.environments.nmmo3.policy import Policy
        creator = functools.partial(host_fixtures.make_fake_nmmo3,
            z['agents'])
    else:
        from pufferlib_tpu_torch.environments.pokemon_red import Policy
        creator = host_fixtures.make_fake_pokemon_red
    vec = vector_host.make(creator, backend=vector_host.HostSerial,
        num_envs=z['num_envs'])
    shape = vec.single_observation_space.shape
    kwargs = dict(generator=g, hidden_size=H)
    if name != 'pokemon_red':
        kwargs['emulated'] = vec.emulated
    policy = _zoo_lstm(torch, Policy(shape, vec.single_action_space,
        **kwargs), shape, H)
    config = _zoo_config(name, z['batch_size'], z['minibatch_size'],
        z['lr'])
    data = ppo_host.create(config, vec, policy)
    try:
        elapsed, launches = _host_epochs(torch, ppo_host, data, 1)
    finally:
        ppo_host.close(data)
    want = _zoo_want(config, launches, 1)
    if launches != want:
        raise AssertionError(f'{name}: launches {launches}, expected {want}')
    agents = f' of {z["agents"]} agents' if 'agents' in z else ''
    _host_line(data, f'{name} host trainer ({z["num_envs"]} fake envs'
        f'{agents}, HostSerial; {name}.Policy h{H} + LSTM '
        f'{H} f32 (cat), batch {z["batch_size"]}, minibatch '
        f'{z["minibatch_size"]}, bptt 16, lr {z["lr"]})', elapsed, 1,
        launches, card)
    return launches


def run_zoo_phase(torch, card, flush, rng):
    """Phase 20. cat's streamed pair against its plain version at the zoo
    updates' shapes (timed beside its bound, the plain version and cuDNN's
    nn.LSTM), then the nethack trainer, one epoch of nmmo, nmmo3 and
    pokemon_red, the reference checkpoint through torch_import (enc5 and
    plain routes against the reference math) and demo_torch's eval of it.
    stable_baselines3 and ray are not installed on the card's machine:
    their bridges are held on the CPU only (tests/test_torch_frameworks.py).
    Returns ({shape: check_lstm's result}, {trainer: launches}, import
    launches, nethack peak memory)."""
    import importlib.util
    for package in ('stable_baselines3', 'ray'):
        log(f'{package}: ' + ('installed, not run here' if
            importlib.util.find_spec(package) else 'not installed; its '
            'bridge is held on the CPU only'))
    runs = {}
    for T, B, D, H in ZOO_CAT_SHAPES:
        runs[T, B, D, H] = check_lstm(torch, flush, rng, 'cat_stream', B,
            'float32', T=T, H=H, D=D, timed=True)
    launches = {}
    launches['nethack'], peak = run_nethack_trainer(torch, card)
    for name in ZOO_OTHERS:
        launches[name] = run_zoo_other(torch, card, name)
    import_launches, ref_sd = check_reference_import(torch, card)
    run_reference_eval(torch, card, ref_sd)
    return runs, launches, import_launches, peak


if __name__ == '__main__':
    sys.exit(main())
