"""Where an epoch of the PyTorch port's trainer goes, on one NVIDIA GPU.

    python3 tools/profile_torch_trainer.py [--use-kernel] [--lstm [enc5|cat]]
        [--hidden N]
    python3 tools/profile_torch_trainer.py --ocean NAME [--use-kernel]
    python3 tools/profile_torch_trainer.py --atari

With --atari, chip_smoke.py's Atari host trainer (the fake ALE in the
host envpool, ppo_host with cpu_offload, Convolutional + LSTM 512 f32):
after a warm-up epoch, an evaluate and a train timed on the host clock,
then another pair under torch.profiler; beside the device numbers it
prints the host operators that take the most CPU time.

Builds chip_smoke.py's main-path trainer (Ocean squared, Default MLP
h128 bf16, 8192 lanes x 64 steps, minibatch 131072; with --lstm the
LSTM line, RecurrentPolicy(LSTMWrapper(Default)) h128 bf16 through the
enc5 kernels, or with --lstm cat through the cat kernels, time-slab
minibatches of 131072; --hidden sets the hidden size (and the LSTM's
input width): 256 or 200 take LSTMWrapper's default route to enc5's
streamed design, as chip_smoke.py's phase 9 does; with --ocean the trainer of chip_smoke.py's Ocean
phase on that env at its config.yaml section), runs one warm-up
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


def timed_ms(torch, fn):
    """fn() on the host clock, synchronised, no profiler (the profiler's
    own overhead inflates wall time)."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - start) * 1e3


def profile_phase(torch, fn, wall_ms=None):
    """fn() once timed on the host clock (unless wall_ms is given), then
    once under torch.profiler for its kernels' device time and launch
    count, and the host operators with the most CPU time."""
    from torch.profiler import ProfilerActivity, profile
    if wall_ms is None:
        wall_ms = timed_ms(torch, fn)
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
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return out, dict(wall_ms=wall_ms, device_ms=device_ms,
        idle_share=1 - device_ms / wall_ms, launches=len(kernels),
        top=[(name[:60], round(ms, 4)) for name, ms in top],
        host_top=[(e.key[:60], round(e.self_cpu_time_total / 1e3, 2),
            e.count) for e in host[:8]])


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--use-kernel', action='store_true',
        help='Default(use_kernel=True): the fused MLP head kernel')
    parser.add_argument('--lstm', nargs='?', const='enc5',
        choices=('enc5', 'cat'),
        help='the recurrent trainer (LSTMWrapper) through these kernels')
    parser.add_argument('--ocean', metavar='NAME',
        help='an Ocean env at its config.yaml section (chip_smoke.py '
        'OCEAN_CONFIGS) instead of the 8192-lane squared line')
    parser.add_argument('--atari', action='store_true',
        help="chip_smoke.py's Atari host trainer")
    parser.add_argument('--hidden', type=int, default=128,
        help='the hidden size of the squared line (default 128)')
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('needs a CUDA device', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    # the conv policies' f32 convolutions in full f32, as chip_smoke.py
    torch.backends.cudnn.allow_tf32 = False
    from chip_smoke import (
        OCEAN_CONFIGS, OCEAN_RECURRENT, card_line, make_ocean_trainer,
        make_trainer)
    from pufferlib_tpu_torch.ops.cuda import KERNELS
    from pufferlib_tpu_torch.ops.cuda._build import build_all
    build_all(KERNELS)
    card = card_line()

    if args.atari:
        return profile_atari(torch, card)
    if args.ocean:
        ppo, data = make_ocean_trainer(torch, args.ocean,
            *OCEAN_CONFIGS[args.ocean], use_kernel=args.use_kernel,
            recurrent=args.ocean in OCEAN_RECURRENT)
    else:
        ppo, data = make_trainer(torch, use_kernel=args.use_kernel,
            lstm_kernel=args.lstm, hidden=args.hidden)
    ppo.step(data)  # warm-up: buffers, cuBLAS handles, kernel libraries

    def rollout_fn():
        data.carry, batch, _, _ = data.rollout_fn(data.carry)
        return batch

    batch, rollout = profile_phase(torch, rollout_fn)
    _, update = profile_phase(torch,
        lambda: data.update_fn(batch, data.config.learning_rate))
    result = dict(card=card, env=args.ocean or 'squared',
        use_kernel=args.use_kernel, lstm=args.lstm, hidden=args.hidden,
        batch_size=data.config.batch_size, rollout=rollout, update=update)
    report(result, ('rollout', 'update'))
    return 0


def report(result, phases):
    for phase in phases:
        r = result[phase]
        print(f'{phase}: wall {r["wall_ms"]:.2f} ms, kernels '
            f'{r["device_ms"]:.2f} ms, idle {r["idle_share"]:.3f}, '
            f'{r["launches"]} launches; top {r["top"]}; host operators '
            f'(self CPU ms, calls) {r["host_top"]}', flush=True)
    print(json.dumps(result), flush=True)


def profile_atari(torch, card):
    """chip_smoke.py's Atari host trainer: a warm-up epoch, an evaluate
    and a train on the host clock, then one of each under the
    profiler."""
    from chip_smoke import ATARI, make_atari_trainer
    from pufferlib_tpu_torch.training import ppo_host
    data = make_atari_trainer(torch)
    try:
        ppo_host.evaluate(data)
        ppo_host.train(data)
        walls = [timed_ms(torch, lambda: ppo_host.evaluate(data)),
            timed_ms(torch, lambda: ppo_host.train(data))]
        _, evaluate = profile_phase(torch, lambda: ppo_host.evaluate(data),
            walls[0])
        _, train = profile_phase(torch, lambda: ppo_host.train(data),
            walls[1])
    finally:
        ppo_host.close(data)
    report(dict(card=card, env='atari', **ATARI, evaluate=evaluate,
        train=train), ('evaluate', 'train'))
    return 0


if __name__ == '__main__':
    sys.exit(main())
