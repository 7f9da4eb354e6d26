"""Where an epoch of the PyTorch port's trainer goes, on one NVIDIA GPU.

    python3 tools/profile_torch_trainer.py [--use-kernel] [--lstm]

Builds chip_smoke.py's main-path trainer (Ocean squared, Default MLP
h128 bf16, 8192 lanes x 64 steps, minibatch 131072; with --lstm the
LSTM line, RecurrentPolicy(LSTMWrapper(Default)) h128 bf16 through the
enc5 kernels, time-slab minibatches of 131072), runs one warm-up
epoch, then runs the rollout and the update of an epoch twice each:
once timed on the host clock, once under torch.profiler. For each phase
it prints the wall time, the summed device time of its kernels, the
device's idle share (1 - kernel time / wall time), the number of kernel
launches, and the kernels that take the most device time. Last line: one
JSON object with those numbers and the card's name and power limit.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def profile_phase(torch, fn):
    """fn() once timed on the host clock (synchronised, no profiler: the
    profiler's own overhead inflates wall time), then once under
    torch.profiler for its kernels' device time and launch count."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    start = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - start) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
            ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    # device-side user annotations (e.g. Optimizer.step#Adam.step) span
    # kernels that are also listed on their own: count kernels only
    kernels = [e for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(e, 'is_user_annotation', False)
        and '#' not in e.name]
    device_ms = sum(e.device_time_total for e in kernels) / 1e3
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return out, dict(wall_ms=wall_ms, device_ms=device_ms,
        idle_share=1 - device_ms / wall_ms, launches=len(kernels),
        top=[(name[:60], round(ms, 4)) for name, ms in top])


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--use-kernel', action='store_true',
        help='Default(use_kernel=True): the fused MLP head kernel')
    parser.add_argument('--lstm', action='store_true',
        help='the recurrent trainer (LSTMWrapper, enc5 kernels)')
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('needs a CUDA device', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from chip_smoke import card_line, make_trainer
    from pufferlib_tpu_torch.ops.cuda import KERNELS
    from pufferlib_tpu_torch.ops.cuda._build import build_all
    build_all(KERNELS)
    card = card_line()

    ppo, data = make_trainer(torch, use_kernel=args.use_kernel,
        lstm_kernel='enc5' if args.lstm else None)
    ppo.step(data)  # warm-up: buffers, cuBLAS handles, kernel libraries

    def rollout_fn():
        data.carry, batch, _, _ = data.rollout_fn(data.carry)
        return batch

    batch, rollout = profile_phase(torch, rollout_fn)
    _, update = profile_phase(torch,
        lambda: data.update_fn(batch, data.config.learning_rate))
    result = dict(card=card, use_kernel=args.use_kernel, lstm=args.lstm,
        batch_size=data.config.batch_size, rollout=rollout, update=update)
    for phase in ('rollout', 'update'):
        r = result[phase]
        print(f'{phase}: wall {r["wall_ms"]:.2f} ms, kernels '
            f'{r["device_ms"]:.2f} ms, idle {r["idle_share"]:.3f}, '
            f'{r["launches"]} launches; top {r["top"]}', flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
