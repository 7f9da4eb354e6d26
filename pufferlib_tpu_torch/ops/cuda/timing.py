"""Timing of work on one NVIDIA GPU, for the scripts that measure the
port's kernels (chip_smoke.py, tools/validate_lstm_torch.py,
tools/kernel_lab_torch.py). Every number they print stands beside
card_line(): the card's name and its power limit, which may be set below
the part's maximum and then slows the card under load.
"""
import subprocess

# profiling windows profiled_ms takes at most before it gives up on a
# window that lost CUPTI records
PROFILE_WINDOWS = 3


def card_line():
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
        '--format=csv,noheader'], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def l2_flush_buffer(device='cuda'):
    """256 MB whose rewrite evicts the 50 MB L2 (see timed_ms)."""
    import torch
    return torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=device)


def issue_ms(fn, flush, reps=20):
    """Mean host ms that fn() takes to return, over reps calls, each
    started on an idle card after a write of `flush`: the time the host
    needs to issue the call's launches (they run asynchronously), which
    is a floor under timed_ms's reading wherever it exceeds the card's
    own time."""
    import time
    import torch
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        torch.cuda.synchronize()
        start = time.perf_counter()
        fn()
        total += time.perf_counter() - start
    torch.cuda.synchronize()
    return total / reps * 1e3


def timed_ms(fn, flush, reps=20):
    """Mean device ms of fn() over reps calls, each after a write of
    `flush` that evicts the L2 (a trainer's batch is not resident when a
    kernel starts), with CUDA events around the call alone."""
    import torch
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


def profiled_ms(fn, flush, name, reps=20, per_call=1):
    """Mean device ms a call of the kernels whose name holds `name`, over
    reps calls of fn(), each after a write of `flush` that evicts the L2,
    as torch.profiler (CUPTI) reports their durations: the kernels alone,
    without the launch and host gaps that timed_ms's events may take in
    for a kernel of a few microseconds. Every call must show exactly
    per_call such kernels (their durations are summed). A window that
    lost records (CUPTI may drop the first kernels of a process's first
    profiling session) is printed and profiled again, at most
    PROFILE_WINDOWS windows in all; too many kernels raise at once."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for window in range(1, PROFILE_WINDOWS + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and name in e.name]
        if len(kernels) >= reps * per_call:
            break
        print(f'profiled_ms: window {window} of {PROFILE_WINDOWS} recorded '
            f'{len(kernels)} kernels named {name!r} in {reps} calls',
            flush=True)
    if len(kernels) != reps * per_call:
        raise RuntimeError(f'profiled_ms: {len(kernels)} kernels named '
            f'{name!r} in {reps} calls of {per_call}')
    return sum(e.device_time_total for e in kernels) / reps / 1e3
