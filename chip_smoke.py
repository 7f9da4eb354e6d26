"""Chip smoke test of pufferlib_tpu_torch on one NVIDIA GPU (sm_90a).

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout, holds each
against its plain PyTorch version at the trainer's shapes, times both
beside the least time the card could take, and drives the port's main
path: the fused PPO trainer on Ocean `squared` with the `Default` MLP at
8192 lanes (GAE kernel), then the same trainer with the fused MLP head
kernel (`Default(use_kernel=True)`). Last, a small trainer update and env
run on the card are held against the same on the CPU.

Prints one line per phase, a `{"kernels": [...]}` JSON line, the card's
name and power limit, and last `{"ok": true, "device": {...}}`. Any
failing phase raises and the script exits non-zero without that line.
It exits non-zero at once when no CUDA device is present. It imports
nothing of JAX.
"""
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM rate, bf16
# tensor-core rate, float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {'bfloat16': 989e12, 'float32': 67e12}

GAE_TOL = 1e-5       # the kernel rounds every op as the plain version does
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


def card_line():
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
        '--format=csv,noheader'], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def timed_ms(torch, fn, flush, reps=20):
    """Mean device ms of fn() over reps launches, each after a write of
    `flush` that evicts the 50 MB L2 (the trainer's batch is not resident
    when GAE runs), with CUDA events around the call alone."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def bound(bytes_moved, flops, dtype_name):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def check_gae(torch, gae, flush, rng, T, E):
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
    if not (torch.isfinite(got).all() and err <= GAE_TOL):
        raise AssertionError(f'GAE ({T}, {E}): max abs err {err} > {GAE_TOL}')
    ms = timed_ms(torch, lambda: gae.compute_gae_cuda(*args), flush)
    plain_ms = timed_ms(torch, lambda: gae.compute_gae(*args), flush, reps=5)
    bytes_moved = (4 * T * E + E) * 4
    flops = 9 * T * E
    bound_ms, bound_by = bound(bytes_moved, flops, 'float32')
    log(f'gae ({T}, {E}) f32: max abs err {err:.3g} (tol {GAE_TOL}); '
        f'kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} '
        f'ms ({bound_by})')
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, shape=f'({T}, {E}) float32')


def check_mlp(torch, mlp, flush, rng, B, dtype_name, F=49, H=128, O=9):
    import numpy as np
    cdt = getattr(torch, dtype_name)
    # dense inputs in the compute dtype (the trainer stores obs in it);
    # denser than squared's grid, so every sum has terms to round
    x = torch.from_numpy(rng.randn(B, F).astype(np.float32)).cuda().to(cdt)
    w1 = torch.from_numpy((rng.randn(F, H) * np.sqrt(2 / F)).astype(
        np.float32)).cuda()
    b1 = torch.from_numpy((rng.randn(H) * 0.1).astype(np.float32)).cuda()
    w2 = torch.from_numpy((rng.randn(H, O) / np.sqrt(H)).astype(
        np.float32)).cuda()
    b2 = torch.from_numpy((rng.randn(O) * 0.1).astype(np.float32)).cuda()
    args = (x, w1, b1, w2, b2, cdt)
    with torch.no_grad():
        got = mlp.mlp_head(*args)
        want = mlp.mlp_head_reference(*args)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    tol = MLP_TOL[dtype_name]
    if not (torch.isfinite(got).all() and err <= tol):
        raise AssertionError(
            f'MLP head B={B} {dtype_name}: max abs err {err} > {tol}')
    with torch.no_grad():
        ms = timed_ms(torch, lambda: mlp.mlp_head(*args), flush)
        plain_ms = timed_ms(torch, lambda: mlp.mlp_head_reference(*args),
            flush)
    bytes_moved = (B * F * x.element_size() + 4 * (F * H + H + H * O + O)
        + 4 * B * O)
    flops = 2 * B * (F * H + H * O)
    bound_ms, bound_by = bound(bytes_moved, flops, dtype_name)
    log(f'mlp_head B={B} {dtype_name}: max abs err {err:.3g} (tol {tol}); '
        f'kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} '
        f'ms ({bound_by})')
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, shape=f'({B}, {F}) {dtype_name}')


# |kernel - plain| <= tol * max(1, max |plain|), per output and gradient.
# f32: the same f32 products summed in another order (measured near 1e-6
# of the scale at the bench shapes). bf16: h, c, the activations and
# dgates round to bf16 inside the recurrence, so a sum that lands on the
# other side of a rounding boundary rounds one ulp (2^-8) the other way
# and carries on; 2e-2 is five ulps of the largest value.
LSTM_TOL = {'float32': 1e-5, 'bfloat16': 2e-2}
LSTM_OUTS = ('outs', 'hT', 'cT', 'cseq')
LSTM_GRADS = {
    'enc5': ('dh0', 'dc0', 'dw_enc', 'db_enc', 'dw_ih', 'dw_hh', 'db'),
    'cat': ('dx', 'dh0', 'dc0', 'dw_ih', 'dw_hh', 'db'),
}


def lstm_case(torch, rng, kind, T, B, dtype_name, F=49, H=128):
    """Inputs at the trainer's shapes: (module, plain forward, plain
    backward, forward args, upstream gradients, cdt). Dense normal
    features and inputs, weights scaled as the trainer's orthogonal
    init."""
    import numpy as np
    from pufferlib_tpu_torch.ops.cuda import lstm_cat, lstm_enc
    cdt = getattr(torch, dtype_name)

    def arr(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(
            np.float32)).cuda()
    state = (arr(B, H, scale=0.5), arr(B, H, scale=0.5))
    weights = (arr(H, 4 * H, scale=H ** -0.5), arr(H, 4 * H, scale=H ** -0.5),
        arr(4 * H, scale=0.1))
    if kind == 'enc5':
        args = (arr(T, B, F).to(cdt), *state, arr(F, H, scale=(2 / F) ** 0.5),
            arr(H, scale=0.1), *weights)
        plain = (lstm_enc, lstm_enc.lstm_enc_reference,
            lstm_enc.lstm_enc_backward_reference)
    else:
        args = (arr(T, B, H, scale=0.5).to(cdt), *state, *weights)
        plain = (lstm_cat, lstm_cat.lstm_cat_reference,
            lstm_cat.lstm_cat_backward_reference)
    grads = (arr(T, B, H).to(cdt), arr(B, H), arr(B, H))
    return (*plain, args, grads, cdt)


def lstm_bounds(kind, args, T, B, H, dtype_name):
    """(forward, backward) bounds from this call's inputs: every input
    read once and every output written once, and the flops of the
    function, at the peak of the input type."""
    x = args[0]
    e = x.element_size()
    F_or_D = x.shape[2]
    weights = sum(t.numel() for t in args[3:]) * 4
    state = 2 * B * H * 4
    seq = T * B * H * e
    if kind == 'enc5':
        F, D = F_or_D, H
        fwd_flops = 2 * T * B * (F * D + (D + H) * 4 * H)
        bwd_flops = 2 * T * B * (2 * F * D + 2 * (D + H) * 4 * H
            + 4 * H * H + 4 * H * D)
        fwd_bytes = x.numel() * e + weights + state + 2 * seq + state
        # in: feats, weights, h0/c0, outs, cseq, g_outs, g_hT/g_cT;
        # out: dh0/dc0 and the weight gradients
        bwd_bytes = (x.numel() * e + weights + state + 3 * seq + state
            + state + weights)
    else:
        D = F_or_D
        fwd_flops = 2 * T * B * (D + H) * 4 * H
        bwd_flops = 3 * fwd_flops
        fwd_bytes = x.numel() * e + weights + state + 2 * seq + state
        # as enc5's, plus dx written
        bwd_bytes = (2 * x.numel() * e + weights + state + 3 * seq + state
            + state + weights)
    return (bound(fwd_bytes, fwd_flops, dtype_name),
        bound(bwd_bytes, bwd_flops, dtype_name))


def check_lstm(torch, flush, rng, kind, B, dtype_name, T=16, H=128,
        timed=False):
    """The LSTM kernel pair `kind` against its plain versions on the same
    inputs: every output and gradient within LSTM_TOL. With timed: the
    kernels', the plain versions' and (cat) cuDNN's times and the
    bounds."""
    mod, fwd_plain, bwd_plain, args, grads, cdt = lstm_case(torch, rng, kind,
        T, B, dtype_name, H=H)
    with torch.no_grad():
        got = mod._launch_forward(*args, cdt)
        want = fwd_plain(*args, cdt)
        bargs = (*args, want[0], want[3], *grads, cdt)
        got_b = mod._launch_backward(*bargs)
        want_b = bwd_plain(*bargs)
    torch.cuda.synchronize()
    tol = LSTM_TOL[dtype_name]
    errs = {}
    for name, a, w in zip(LSTM_OUTS + LSTM_GRADS[kind], got + got_b,
            want + want_b):
        err = (a.float() - w.float()).abs().max().item()
        scale = max(1.0, w.float().abs().max().item())
        if not (torch.isfinite(a).all() and err <= tol * scale):
            raise AssertionError(f'{kind} B={B} {dtype_name} {name}: max abs '
                f'err {err} > {tol} x {scale:.4g}')
        errs[name] = (err, tol * scale)
    log(f'lstm {kind} T={T} B={B} {dtype_name}, max abs err (tol): ' + ', '.join(
        f'{k} {e:.3g} ({t:.3g})' for k, (e, t) in errs.items()))
    result = dict(fwd_err=max(errs[k][0] for k in LSTM_OUTS),
        bwd_err=max(errs[k][0] for k in LSTM_GRADS[kind]),
        shape=f'T={T} B={B} H={H} {dtype_name}')
    if not timed:
        return result
    with torch.no_grad():
        result['fwd_ms'] = timed_ms(torch,
            lambda: mod._launch_forward(*args, cdt), flush)
        result['bwd_ms'] = timed_ms(torch,
            lambda: mod._launch_backward(*bargs), flush)
        result['fwd_plain_ms'] = timed_ms(torch,
            lambda: fwd_plain(*args, cdt), flush, reps=5)
        result['bwd_plain_ms'] = timed_ms(torch,
            lambda: bwd_plain(*bargs), flush, reps=5)
    (result['fwd_bound'], result['fwd_by']), (result['bwd_bound'],
        result['bwd_by']) = lstm_bounds(kind, args, T, B, H, dtype_name)
    result['fwd_lib'] = result['bwd_lib'] = None
    if kind == 'cat':
        result['fwd_lib'], result['bwd_lib'] = cudnn_lstm_ms(torch, flush,
            args, grads[0])
    log(f'lstm {kind} T={T} B={B} {dtype_name}: forward {result["fwd_ms"]:.4f}'
        f' ms (plain {result["fwd_plain_ms"]:.4f}, bound '
        f'{result["fwd_bound"]:.4f} {result["fwd_by"]}, library '
        f'{result["fwd_lib"]}); backward {result["bwd_ms"]:.4f} ms (plain '
        f'{result["bwd_plain_ms"]:.4f}, bound {result["bwd_bound"]:.4f} '
        f'{result["bwd_by"]}, library {result["bwd_lib"]})')
    return result


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
        fwd_ms = timed_ms(torch, lambda: lstm(x, state), flush)
    xg = x.detach().requires_grad_()
    outs, _ = lstm(xg, state)
    inputs = [xg] + list(lstm.parameters())
    bwd_ms = timed_ms(torch, lambda: torch.autograd.grad(outs, inputs,
        g_outs, retain_graph=True), flush)
    return fwd_ms, bwd_ms


def make_trainer(torch, num_envs=8192, horizon=64, hidden=128,
        dtype_name='bfloat16', use_kernel=False, minibatch_size=131072,
        seed=0, device='cuda', lstm_kernel=None, lstm_use_kernel=None):
    """bench.py's `_8k_lanes` configuration (bench.py:33-81), on the port;
    with lstm_kernel ('enc5', 'cat' or 'off') its LSTM line instead
    (bench.py:53-57, 66): RecurrentPolicy(LSTMWrapper(Default)) with
    input and hidden size `hidden`, minibatch batch_size // 4 by the
    caller's choice of minibatch_size."""
    import pufferlib_tpu_torch.vector as vector
    from pufferlib_tpu_torch.models import (
        Default, LSTMWrapper, Policy, RecurrentPolicy)
    from pufferlib_tpu_torch.ocean import env_creator
    from pufferlib_tpu_torch.training import ppo
    dtype = getattr(torch, dtype_name)
    batch_size = num_envs * horizon
    vecenv = vector.make(env_creator('squared'),
        env_kwargs=dict(distance_to_target=3, num_targets=1),
        num_envs=num_envs, device=device)
    obs_shape = vecenv.single_observation_space.shape
    module = Default(obs_shape=obs_shape,
        action_space=vecenv.single_action_space, hidden_size=hidden,
        dtype=dtype, use_kernel=use_kernel,
        generator=torch.Generator().manual_seed(seed))
    if lstm_kernel is None:
        policy = Policy(module)
    else:
        policy = RecurrentPolicy(LSTMWrapper(module, obs_shape=obs_shape,
            input_size=hidden, hidden_size=hidden, dtype=dtype,
            kernel=lstm_kernel, use_kernel=lstm_use_kernel,
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
    )
    return ppo, ppo.create(config, vecenv, policy)


# launches of each LSTM C function per epoch of the 8192-lane trainer: 4
# update epochs x 4 time-slab minibatches, one forward and one backward
# each; the rollout's T == 1 steps run the plain cell
LSTM_PER_EPOCH = 16


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


def check_losses(data, what):
    import math
    losses = dict(data.losses)
    bad = {k: v for k, v in losses.items() if not math.isfinite(v)}
    if bad:
        raise AssertionError(f'{what}: non-finite losses {bad}')
    return losses


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

    # phases 3-4: each kernel against its plain version, then timed
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device='cuda')
    rng = np.random.RandomState(0)
    gae_main = check_gae(torch, gae, flush, rng, 64, 8192)
    gae_ragged = check_gae(torch, gae, flush, rng, 64, 1000)
    mlp_runs = {(B, d): check_mlp(torch, mlp, flush, rng, B, d)
        for B in (8192, 131072) for d in ('bfloat16', 'float32')}
    lstm_runs = {(kind, B, d): check_lstm(torch, flush, rng, kind, B, d,
            timed=(B, d) == (8192, 'bfloat16'))
        for kind in ('enc5', 'cat') for B in (8192, 1000)
        for d in ('bfloat16', 'float32')}
    del flush

    # phase 5: the main path, GAE kernel once per epoch
    ppo, data = make_trainer(torch)
    ppo.step(data)  # warm-up epoch
    torch.cuda.synchronize()
    epochs = 4
    for k in KERNELS:
        k.launches = 0
    start = time.perf_counter()
    for _ in range(epochs):
        ppo.step(data)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    gae_launches, mlp_plain_launches = gae.KERNEL.launches, \
        mlp.KERNEL.launches
    if gae_launches != epochs or mlp_plain_launches != 0:
        raise AssertionError(f'trainer: {gae_launches} GAE launches for '
            f'{epochs} epochs, {mlp_plain_launches} MLP launches')
    losses = check_losses(data, 'trainer')
    sps = epochs * data.config.batch_size / elapsed
    log(f'trainer 8192 lanes x 64, Default h128 bf16: {sps:.1f} steps/s '
        f'over {epochs} epochs ({elapsed / epochs * 1e3:.2f} ms/epoch) on '
        f'{card}; losses {json.dumps(losses)}; stats '
        f'{json.dumps(data.stats)}')
    # where the epoch goes: the rollout and the update, each synchronised
    for _ in range(2):
        ppo.evaluate(data)
        ppo.train(data)
    timers = data._timers
    log(f'trainer split, 2 epochs: rollout {timers["evaluate"].prev * 1e3:.2f}'
        f' ms, update {timers["train"].prev * 1e3:.2f} ms (last epoch); '
        f'peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    del data

    # phase 6: the opt-in fused MLP head on the same trainer
    ppo, data = make_trainer(torch, use_kernel=True)
    for k in KERNELS:
        k.launches = 0
    start = time.perf_counter()
    ppo.step_many(data, 2)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    mlp_launches, gae_launches_k = mlp.KERNEL.launches, gae.KERNEL.launches
    if mlp_launches <= 0 or gae_launches_k != 2:
        raise AssertionError(f'use_kernel trainer: {mlp_launches} MLP '
            f'launches, {gae_launches_k} GAE launches in 2 epochs')
    losses = check_losses(data, 'use_kernel trainer')
    log(f'trainer use_kernel=True: {mlp_launches} MLP head launches in 2 '
        f'epochs, {2 * data.config.batch_size / elapsed:.1f} steps/s '
        f'(first 2 epochs, no warm-up); losses {json.dumps(losses)}')
    del data

    # phase 7: this slice's main path, the LSTM trainer through the enc5
    # kernels, then the synchronised rollout/update split of an epoch
    torch.cuda.reset_peak_memory_stats()
    ppo, data, enc5_launches = run_lstm_trainer(torch, card, 'enc5',
        epochs=3, warmup=True)
    for _ in range(2):
        ppo.evaluate(data)
        ppo.train(data)
    timers = data._timers
    log(f'LSTM trainer split, 2 epochs: rollout '
        f'{timers["evaluate"].prev * 1e3:.2f} ms, update '
        f'{timers["train"].prev * 1e3:.2f} ms (last epoch); peak memory '
        f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    del data

    # phase 8: the same trainer through the cat kernels
    _, data, cat_launches = run_lstm_trainer(torch, card, 'cat', epochs=2,
        warmup=False)
    del data

    # phase 9: the card against the CPU, at a small size in f32
    check_card_against_cpu(torch, np)
    check_lstm_card_against_cpu(torch, np)

    kernels = [
        dict(name='gae', route='cuda',
            source='pufferlib_tpu_torch/csrc/gae.cu',
            replaces='pufferlib_tpu/ops/pallas/gae.py:42',
            launches=gae_launches,
            max_abs_err=max(gae_main['err'], gae_ragged['err']),
            ms=gae_main['ms'], plain_ms=gae_main['plain_ms'],
            bound_ms=gae_main['bound_ms'], bound_by=gae_main['bound_by'],
            library_ms=None, shape=gae_main['shape']),
        dict(name='mlp_head', route='cuda',
            source='pufferlib_tpu_torch/csrc/mlp_head.cu',
            replaces='pufferlib_tpu/ops/pallas/mlp.py:80',
            launches=mlp_launches,
            max_abs_err=max(r['err'] for r in mlp_runs.values()),
            ms=mlp_runs[131072, 'bfloat16']['ms'],
            plain_ms=mlp_runs[131072, 'bfloat16']['plain_ms'],
            bound_ms=mlp_runs[131072, 'bfloat16']['bound_ms'],
            bound_by=mlp_runs[131072, 'bfloat16']['bound_by'],
            library_ms=None, shape=mlp_runs[131072, 'bfloat16']['shape']),
    ]
    lstm_rows = (
        ('lstm_enc5_forward', 'enc5', 'fwd', 'lstm_enc.cu',
            'lstm_enc.py:170', enc5_launches['lstm_enc_forward']),
        ('lstm_enc5_backward', 'enc5', 'bwd', 'lstm_enc.cu',
            'lstm_enc5.py:147', enc5_launches['lstm_enc_backward']),
        ('lstm_cat_forward', 'cat', 'fwd', 'lstm_cat.cu', 'lstm_cat.py:131',
            cat_launches['lstm_cat_forward']),
        ('lstm_cat_backward', 'cat', 'bwd', 'lstm_cat.cu', 'lstm_cat.py:185',
            cat_launches['lstm_cat_backward']),
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
    print(json.dumps({'kernels': kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
        'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


def check_card_against_cpu(torch, np):
    """One trainer update (GAE kernel, with and without the MLP head
    kernel) and 12 env steps on the card, held against the same on the
    CPU from the same weights, batch, actions and reset draws. f32;
    params to 1e-4 (sums in other orders through Adam), env exactly."""
    import pufferlib_tpu_torch.vector as vector
    from pufferlib_tpu_torch.ocean import env_creator
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

    kwargs = dict(distance_to_target=3, num_targets=1)
    envs = [vector.make(env_creator('squared'), env_kwargs=kwargs,
        num_envs=N, device=d) for d in ('cpu', 'cuda')]
    draws = torch.from_numpy(rng.randint(0, 24, (13, N)))
    outs = [[env.reset(reset_draws=draws[0].to(env.device))[0].cpu()]
        for env in envs]
    for t in range(12):
        actions = torch.from_numpy(rng.randint(0, 8, N))
        for env, out in zip(envs, outs):
            step = env.step(actions.to(env.device),
                reset_draws=draws[t + 1].to(env.device))
            out.extend(x.cpu() for x in step[:4])
            out.extend(v.cpu() for v in step[4].values())
    for a, b in zip(*outs):
        if not torch.equal(a, b):
            raise AssertionError('Squared on the card differs from the CPU')
    log(f'env card vs CPU: 12 autoreset steps x {N} lanes, exactly equal')


def check_lstm_card_against_cpu(torch, np):
    """One recurrent update (time slabs, T = 16 per minibatch, N = 256,
    hidden 32, f32) through the enc5 and the cat kernels on the card and
    through their plain versions on the CPU, from the same weights and
    batch. Params within 1e-4, as the MLP update: the same f32 math with
    sums in other orders, through Adam."""
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
    lstm0 = (rng.randn(2, T // h, 1, N, 32) * 0.5).astype(np.float32)
    for kernel in ('enc5', 'cat'):
        results = []
        for device in ('cpu', 'cuda'):
            ppo, data = make_trainer(torch, num_envs=N, horizon=T, hidden=32,
                dtype_name='float32', minibatch_size=mb, device=device,
                lstm_kernel=kernel, lstm_use_kernel=True)
            b = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
            b['lstm0'] = tuple(torch.from_numpy(s).to(device) for s in lstm0)
            stats = data.update_fn(b, 3e-3)
            results.append((
                {k: v.detach().cpu() for k, v in
                    data.policy.state_dict().items()},
                {k: v.item() for k, v in stats.items()}))
        (cpu_params, cpu_stats), (gpu_params, gpu_stats) = results
        err = max((cpu_params[k] - gpu_params[k]).abs().max().item()
            for k in cpu_params)
        stat_err = max(abs(cpu_stats[k] - gpu_stats[k]) for k in cpu_stats)
        if not err <= 1e-4:
            raise AssertionError(f'recurrent update on the card vs CPU '
                f'(kernel={kernel}): params differ by {err}')
        log(f'recurrent update card vs CPU, f32, kernel={kernel}: params max '
            f'abs diff {err:.3g} (tol 1e-4), stats max abs diff '
            f'{stat_err:.3g}')


if __name__ == '__main__':
    sys.exit(main())
