"""Where the time of an MLP head kernel goes, by ablation, on one NVIDIA
GPU.

    python3 tools/ablate_mlp_head_torch.py [--dtype bfloat16|float32]
        [--baseline DIR ...] [--only NAME ...] [--shape F,H,O]
        [--batch B ...]

The machines the port is measured on run no stall profiler, so this tool
builds pufferlib_tpu_torch/csrc/mlp_head.cu as it is and in variants,
each a copy of the source with one edit, built by nvcc into a library of
its own (under pufferlib_tpu_torch/_build/ablate_mlp/), and times each at
the trainer's shapes (F = 49, H = 128, O = 9; B = 256 and 4096, the CLI
squared run's rollout lanes and minibatch, and 8192 and 131072, the
bench trainer's; cold L2; --shape and --batch for others) in the compute
dtype --dtype (bfloat16 by default: the tensor-core kernel). bfloat16's
variants:

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

float32's (the register-tiled FMA kernel in its resident configuration,
the weights in shared memory and x staged):

- no-products: neither layer's products run (the chunks' epilogues, the
  partials and the stores do);
- no-layer2: layer 2's products do not run;
- no-relayout: the staged x spans are not laid into the k-major tile;
- no-load: no x span is copied (the bf16 kernel's edit: the span copy is
  shared);
- no-staging: W1 and W2 are not staged (shared memory keeps what it
  holds; the biases are);
- per-sm-1: at most 1 block an SM instead of 2;
- tile-128: 128-row tiles (8 x 8 outputs a thread in layer 1, 4 rows a
  lane in layer 2), one block an SM;

and the streamed configuration's (time them at its shapes, e.g. --shape
300,130,9 --batch 1000 131072):

- chunk-16: chunks of 16 values of k instead of 32;
- chunk-stages-3: three chunk stages instead of two.

With --baseline, also the mlp_head.cu of each checkout (or csrc
directory) named (earlier versions of the kernel with the same
mlp_head_forward), as baseline-<dir>.

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
import re
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
        'src : a), n);', 'if (nt < 0) cp_async16(dst + 16 * c, '
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
# the f32 kernel's variants
F32_ABLATIONS = {
    'no-products': (('for (int k = 0; k < K; ++k) {',
        'for (int k = 0; k < K && K < 0; ++k) {'),
        ('if (kb >= g.H) return;', 'if (kb >= g.H || g.H > 0) return;')),
    'no-layer2': (('if (kb >= g.H) return;',
        'if (kb >= g.H || g.H > 0) return;'),),
    'no-relayout': (('for (int i = tid; i < TR * F; i += THREADS) {',
        'for (int i = tid; i < TR * F && B < 0; i += THREADS) {'),),
    'no-load': ABLATIONS['no-load'],
    'no-staging': (('for (int i = tid; i < F * q; i += THREADS) {',
        'for (int i = tid; i < F * q && B < 0; i += THREADS) {'),
        ('for (int i = tid; i < g.Hc * g.Op; i += THREADS) {',
        'for (int i = tid; i < g.Hc * g.Op && B < 0; i += THREADS) {')),
    'per-sm-1': (('constexpr int MAX_PER_SM = 2;',
        'constexpr int MAX_PER_SM = 1;'),),
    'tile-128': (('constexpr int TR = 64; ', 'constexpr int TR = 128;'),
        ('constexpr int MAX_PER_SM = 2;', 'constexpr int MAX_PER_SM = 1;')),
    'chunk-16': (('constexpr int KC = 32; ', 'constexpr int KC = 16; '),),
    'chunk-stages-3': (('constexpr int KS = 2; ', 'constexpr int KS = 3; '),),
}
BATCHES = (256, 4096, 8192, 131072)


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


def usage(build_log, kernel_name):
    """'entry: registers, spills' of each instance of kernel_name that
    ptxas -v reports in build_log (the entry's mangled template arguments
    name it)."""
    out, entry, spill = [], None, ''
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry, spill = m.group(1), ''
        elif 'spill stores' in line:
            spill = line.strip()
        elif entry and kernel_name in entry and 'registers' in line:
            args = entry[entry.index(kernel_name) + len(kernel_name):]
            regs = re.search(r'Used (\d+) registers', line).group(1)
            out.append(f'{args[:args.index("EEv") + 3]}: {regs} registers, '
                f'{spill}')
            entry = None
    return out


def load(lib_path, kernel):
    """The library with the argument types of kernel's functions (those it
    has: an older version may lack the newer configuration queries)."""
    lib = ctypes.CDLL(lib_path)
    for fn, argtypes in kernel.functions.items():
        if not hasattr(lib, fn):
            continue
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--baseline', nargs='*', default=(),
        help='checkouts (or csrc directories) with another mlp_head.cu')
    parser.add_argument('--dtype', default='bfloat16',
        choices=('bfloat16', 'float32'), help='the compute dtype')
    parser.add_argument('--only', nargs='*', default=None,
        help=f'variants among {sorted(ABLATIONS)} (bfloat16) or '
        f'{sorted(F32_ABLATIONS)} (float32) (default: all)')
    parser.add_argument('--shape', default='49,128,9',
        help='F,H,O of the head (default: the trainer\'s)')
    parser.add_argument('--batch', nargs='+', type=int, default=BATCHES,
        help=f'rows B (default: {" ".join(map(str, BATCHES))})')
    args = parser.parse_args(argv)
    F, H, O = (int(n) for n in args.shape.split(','))
    ablations = ABLATIONS if args.dtype == 'bfloat16' else F32_ABLATIONS
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
    names = args.only if args.only is not None else list(ablations)
    specs = {'as-is': (_build.CSRC_DIR, ())}
    specs.update({n: (_build.CSRC_DIR, ablations[n]) for n in names})
    for path in args.baseline:
        # a csrc directory, or the root of a checkout
        csrc = path if os.path.exists(os.path.join(path, SOURCE)) else \
            os.path.join(path, 'pufferlib_tpu_torch', 'csrc')
        specs['baseline-' + os.path.basename(os.path.normpath(path))] = (
            os.path.abspath(csrc), ())
    start = time.perf_counter()
    pending = {n: start_build(n, csrc, edits, build_dir)
        for n, (csrc, edits) in specs.items()}
    libs = {}
    for name, (proc, lib) in pending.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed on variant {name}:\n{out}')
        libs[name] = load(lib, mlp.KERNEL)
        print(f'{name}: ' + ' | '.join(usage(out, 'mlp_head_tc_kernel'
            if args.dtype == 'bfloat16' else 'mlp_head_f32_kernel')),
            flush=True)
    print(f'built {len(libs)} variants in {time.perf_counter() - start:.1f} s',
        flush=True)

    flush = l2_flush_buffer()
    cdt = getattr(torch, args.dtype)
    cases = {B: (*chip_smoke.mlp_case(torch, np.random.RandomState(B), B,
        F, H, O, cdt), cdt) for B in args.batch}
    # the kernel's name: the bf16 kernel's, or (f32) any MLP head kernel,
    # a baseline's too
    kernel_name = 'mlp_head_tc' if cdt == torch.bfloat16 else 'mlp_head'

    order = list(specs) + list(reversed(specs))
    runs = {n: [] for n in specs}
    with torch.no_grad():
        for name in order:
            mlp.KERNEL._lib = libs[name]
            run = {}
            for B, case in cases.items():
                fn = lambda: mlp.mlp_head(*case)  # noqa: E731
                run[f'B={B} device'] = profiled_ms(fn, flush, kernel_name)
                run[f'B={B} events'] = timed_ms(fn, flush)
            print(f'{name}: ' + ', '.join(f'{k} {v:.4f}' for k, v in
                run.items()) + ' ms', flush=True)
            runs[name].append(run)
    mlp.KERNEL._lib = None
    means = {n: {k: sum(r[k] for r in rs) / len(rs) for k in rs[0]}
        for n, rs in runs.items()}
    print(json.dumps({'card': card,
        'shape': f'F={F} H={H} O={O} {args.dtype}',
        'ms': means}), flush=True)
    return means


if __name__ == '__main__':
    main()
