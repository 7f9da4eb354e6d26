"""Where the time of the bf16 MLP head kernel goes, by ablation, on one
NVIDIA GPU.

    python3 tools/ablate_mlp_head_torch.py [--baseline DIR ...] [--only NAME ...]

The machines the port is measured on run no stall profiler, so this tool
builds pufferlib_tpu_torch/csrc/mlp_head.cu as it is and in variants,
each a copy of the source with one edit, built by nvcc into a library of
its own (under pufferlib_tpu_torch/_build/ablate_mlp/), and times each at
the trainer's two shapes (B = 8192 and 131072, F = 49, H = 128, O = 9,
bf16, cold L2):

- no-compute: the tiles' two products and their epilogues do not run;
- no-relayout: the staged x spans are not laid into padded rows;
- no-load: no x span is copied (the ring keeps what it holds);
- no-staging: the weights are not staged (shared memory keeps what it
  holds);
- no-store: the output rows are not stored;
- per-sm-1, per-sm-2: at most 1 or 2 blocks an SM instead of 4;
- stages-2, stages-4: a ring of 2 or 4 x spans instead of 3;
- mt-2: warps of two m-tiles (32 rows) instead of one, which share each
  B fragment (128-row tiles);
- warps-2-mt-2: blocks of 2 warps of two m-tiles each (64-row tiles).

With --baseline, also the mlp_head.cu of each directory named (earlier
versions of the kernel with the same C interface), as baseline-<dir>.

The variants run in turns, forward and back. Each run reads the kernel's
device time with torch.profiler (ops/cuda/timing.profiled_ms) and the
time between CUDA events around the call (timed_ms). An ablated variant
computes wrong numbers by design: only its times mean anything. The last
line is one JSON object: the mean ms of each variant at each shape, and
the card's name and power limit.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SOURCE = 'mlp_head.cu'
# variant -> edits of mlp_head.cu as (old, new) pairs
ABLATIONS = {
    'no-compute': (('for (int o0 = 0; o0 < g.Op; o0 += OC) {',
        'for (int o0 = 0; o0 < g.Op && B < 0; o0 += OC) {'),),
    'no-relayout': (('for (int i = tid; i < TR * groups; i += NT) {',
        'for (int i = tid; i < TR * groups && B < 0; i += NT) {'),),
    'no-load': (('cp_async16(dst + 16 * c, reinterpret_cast<const void*>(n ? '
        'src : a), n);', 'if (B < 0) cp_async16(dst + 16 * c, '
        'reinterpret_cast<const void*>(n ? src : a), n);'),),
    'no-staging': (('        stage_weights(m1, m2,', '        if (B < 0) stage_weights(m1, m2,'),),
    'no-store': (('for (int i = lane; i < wrows * O; i += 32) dst[i] = src[i];',
        'for (int i = lane; i < wrows * O && B < 0; i += 32) dst[i] = '
        'src[i];'),),
    'per-sm-1': (('MAX_PER_SM = 4;', 'MAX_PER_SM = 1;'),),
    'per-sm-2': (('MAX_PER_SM = 4;', 'MAX_PER_SM = 2;'),),
    'stages-2': (('{4, 1, 3, true},', '{4, 1, 2, true},'),),
    'stages-4': (('{4, 1, 3, true},', '{4, 1, 4, true},'),),
    'mt-2': (('{4, 1, 3, true},', '{4, 2, 3, true},'),),
    'warps-2-mt-2': (('{4, 1, 3, true},', '{2, 2, 3, true},'),),
}
SHAPES = (8192, 131072)


def start_build(name, csrc, edits, build_dir):
    """Copy csrc's mlp_head.cu with the edits applied, start nvcc on it;
    returns (process, library path)."""
    from pufferlib_tpu_torch.ops.cuda import _build
    with open(os.path.join(csrc, SOURCE)) as f:
        text = f.read()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f'{name}: {old!r} is not in {SOURCE}')
        text = text.replace(old, new)
    src = os.path.join(build_dir, f'{name}.cu')
    with open(src, 'w') as f:
        f.write(text)
    lib = os.path.join(build_dir, f'libmlp_head-{name}.so')
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, '-o', lib, src]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True), lib


def load(lib_path, kernel):
    """The library with the argument types of kernel's functions."""
    lib = ctypes.CDLL(lib_path)
    for fn, argtypes in kernel.functions.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--baseline', nargs='*', default=(),
        help='directories with another mlp_head.cu')
    parser.add_argument('--only', nargs='*', default=None,
        help=f'variants among {sorted(ABLATIONS)} (default: all)')
    args = parser.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit('ablate_mlp_head_torch needs a CUDA device')
    import chip_smoke
    from pufferlib_tpu_torch.ops.cuda import _build, mlp
    from pufferlib_tpu_torch.ops.cuda.timing import (
        card_line, l2_flush_buffer, profiled_ms, timed_ms)
    card = card_line()
    build_dir = os.path.join(_build.BUILD_DIR, 'ablate_mlp')
    os.makedirs(build_dir, exist_ok=True)
    names = args.only if args.only is not None else list(ABLATIONS)
    specs = {'as-is': (_build.CSRC_DIR, ())}
    specs.update({n: (_build.CSRC_DIR, ABLATIONS[n]) for n in names})
    for path in args.baseline:
        specs['baseline-' + os.path.basename(os.path.normpath(path))] = (
            os.path.abspath(path), ())
    start = time.perf_counter()
    pending = {n: start_build(n, csrc, edits, build_dir)
        for n, (csrc, edits) in specs.items()}
    libs = {}
    for name, (proc, lib) in pending.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed on variant {name}:\n{out}')
        libs[name] = load(lib, mlp.KERNEL)
    print(f'built {len(libs)} variants in {time.perf_counter() - start:.1f} s',
        flush=True)

    flush = l2_flush_buffer()
    cases = {B: (*chip_smoke.mlp_case(torch, np.random.RandomState(B), B,
        49, 128, 9, torch.bfloat16), torch.bfloat16) for B in SHAPES}
    order = list(specs) + list(reversed(specs))
    runs = {n: [] for n in specs}
    with torch.no_grad():
        for name in order:
            mlp.KERNEL._lib = libs[name]
            run = {}
            for B, case in cases.items():
                fn = lambda: mlp.mlp_head(*case)  # noqa: E731
                run[f'B={B} device'] = profiled_ms(fn, flush, 'mlp_head_tc')
                run[f'B={B} events'] = timed_ms(fn, flush)
            print(f'{name}: ' + ', '.join(f'{k} {v:.4f}' for k, v in
                run.items()) + ' ms', flush=True)
            runs[name].append(run)
    mlp.KERNEL._lib = None
    means = {n: {k: sum(r[k] for r in rs) / len(rs) for k in rs[0]}
        for n, rs in runs.items()}
    print(json.dumps({'card': card, 'shape': 'F=49 H=128 O=9 bf16',
        'ms': means}), flush=True)
    return means


if __name__ == '__main__':
    main()
