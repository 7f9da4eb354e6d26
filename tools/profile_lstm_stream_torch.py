"""Where a call of the streamed LSTM design's C functions goes, on one
NVIDIA GPU.

    python3 tools/profile_lstm_stream_torch.py [--kind cat|enc5]
        [--shape T,B,D,H[,F]] [--dtype float32|bfloat16] [--plain]

Runs one forward and one backward call of cat's (or enc5's) streamed pair
(csrc/lstm_cat_stream.cu) at the shape given (default: the Atari
update's T 16, B 256, D = H = 512; F 49 for enc5), on chip_smoke.py's
inputs, a few times under torch.profiler, and prints for each call the
device time of every kernel it launched (mean over the calls, in launch
order), their sum, the call's time by CUDA events with a cold L2, and the
kernels the library counted; with --plain also the plain version's time
(lstm_cat_reference / lstm_enc_reference and their backwards, the
functions the kernels are held to) by the same events, mean of 5. Last
line: one JSON object with those numbers and the card's name and power
limit.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def kernel_times(torch, fn, calls):
    """[(kernel name, mean device ms)] of fn()'s kernels, in launch order,
    over `calls` profiled calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA),
        key=lambda e: e.time_range.start)
    if not events or len(events) % calls:
        return [(f'{len(events)} kernels recorded in {calls} calls', 0.0)]
    per = len(events) // calls
    return [(events[i].name[:90], sum(events[c * per + i].device_time_total
        for c in range(calls)) / calls / 1e3) for i in range(per)]


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--kind', choices=('cat', 'enc5'), default='cat')
    parser.add_argument('--shape', default='16,256,512,512')
    parser.add_argument('--dtype', choices=('float32', 'bfloat16'),
        default='float32')
    parser.add_argument('--calls', type=int, default=5)
    parser.add_argument('--plain', action='store_true',
        help="also time the plain version's call")
    args = parser.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print('profile_lstm_stream_torch: needs an NVIDIA GPU',
            file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from chip_smoke import (
        card_line, kernels_per_call, l2_flush_buffer, lstm_case, lstm_kinds,
        timed_ms)
    T, B, D, H, *rest = (int(v) for v in args.shape.split(','))
    F = rest[0] if rest else 49
    kind = f'{args.kind}_stream'
    fwd, bwd, fwd_plain, bwd_plain = lstm_kinds()[kind][:4]
    case, grads, cdt = lstm_case(torch, np.random.RandomState(0), kind, T, B,
        args.dtype, F=F, H=H, D=D)
    with torch.no_grad():
        outs, _, _, cseq = fwd(*case, cdt)
        calls = {'forward': lambda: fwd(*case, cdt),
            'backward': lambda: bwd(*case, outs, cseq, *grads, cdt)}
        plain = {'forward': lambda: fwd_plain(*case, cdt),
            'backward': lambda: bwd_plain(*case, outs, cseq, *grads, cdt)}
        flush = l2_flush_buffer()
        result = dict(card=card_line(), kind=kind, T=T, B=B, D=D, H=H,
            F=F if args.kind == 'enc5' else None, dtype=args.dtype)
        for name, fn in calls.items():
            kernels = kernel_times(torch, fn, args.calls)
            result[name] = dict(event_ms=timed_ms(fn, flush),
                kernels_counted=kernels_per_call(fn),
                profiled_sum_ms=sum(ms for _, ms in kernels),
                kernels=kernels)
            if args.plain:
                result[name]['plain_ms'] = timed_ms(plain[name], flush,
                    reps=5)
            print(f'{name}: events {result[name]["event_ms"]:.4f} ms, '
                f'{result[name]["kernels_counted"]} kernels, profiled sum '
                f'{result[name]["profiled_sum_ms"]:.4f} ms' + (
                f', plain {result[name]["plain_ms"]:.4f} ms' if args.plain
                else ''), flush=True)
            for kname, ms in kernels:
                print(f'    {ms:9.4f} ms  {kname}', flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
