"""Where the time of the bf16 tensor-core kernels of lstm_scan_fused,
lstm_scan_cat or enc5 goes, by ablation, on one NVIDIA GPU.

    python3 tools/ablate_lstm_tc_torch.py [--kind fused|cat|enc5]
        [--baseline CSRC_DIR] [--only NAME ...]

The machines the port is measured on run no stall profiler, so this tool
removes one part of the recurrent loops of csrc/lstm_tc.cuh at a time and
times what is left. It builds the kind's source
(pufferlib_tpu_torch/csrc/lstm_scan.cu for fused, the default,
lstm_cat.cu for cat, lstm_enc.cu for enc5) as it is and in these
variants, each a copy of the sources with one edit, built by nvcc into a
library of its own (under pufferlib_tpu_torch/_build/):

- no-slab: the loops read no XW / P values (zeros in their place; in
  the backward the activations of those zeros then fold to constants);
- no-mma: the loops run no recurrent product (h @ W_hh, dg @ W_hh^T);
- exact-math: the forward loop's cell math through expf, tanhf and IEEE
  division instead of the special function unit (the backward's already
  is);
- gemm-no-store: the GEMMs (pre-passes, dx) store nothing (their
  products still run);
- gemm-no-load: the GEMMs load no A tiles (they multiply what shared
  memory holds and store it), except enc5's encoder, whose feats rows
  load through their own path;
- gemm-stages-4: a ring of 4 A chunks instead of 2;
- gemm-no-barrier: the GEMMs' per-chunk barrier removed (racing loads:
  the numbers are wrong, the time shows what the barrier costs);
- late-slab-load (cat and enc5, whose forward loop is cat's; not an
  ablation but the other order): the forward loop issues the next unit
  group's slab load after the product, as fused's does, instead of
  before it.

With --baseline, also the same source of another csrc/ directory with the
same C interface (an earlier version of these kernels). The variants run
in turns, forward and back, each twice, at T = 16, B = 8192, D = H = 128
(enc5: F = 49), bf16, and each run times the phases of the forward and
the backward (chip_smoke.time_tc_phases: pre-pass, loop, dx, dW + db;
enc5's encoder in both pre-passes, dpre for dx; cold L2). An
ablated variant computes wrong numbers by design: only its times mean
anything. The last line is one JSON object: the mean ms of each phase by
variant, and the card's name and power limit.
"""
import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# variant -> (edits of lstm_tc.cuh as (old, new) pairs, extra nvcc flags)
ABLATIONS = {
    'no-slab': ((
        ('v[mt][g] = __ldg(\n                    reinterpret_cast<const float4*>(slab + '
            '(tile * 4 + g) * 128 + lane * 4));', 'v[mt][g] = make_float4(0.f, 0.f, 0.f, 0.f);'),
        ('it.p[g] = __ldg(reinterpret_cast<const float4*>(pre + (tile * 4 + g) * 128 + '
            'lane * 4));', 'it.p[g] = make_float4(0.f, 0.f, 0.f, 0.f);')), ()),
    'no-mma': ((
        ('gates_mma<H>(acc, hc, w_s, mt0, u0, lane);',
            'memset(acc, 0, sizeof acc);'),
        ('dh_mma<H>(dh, d_s, w_s, mt0, ug0, lane);', '')), ()),
    'exact-math': ((
        ('return __fdividef(1.f, 1.f + __expf(-x));',
            'return 1.f / (1.f + expf(-x));'),
        ('return 2.f * sig_tc(2.f * x) - 1.f;', 'return tanhf(x);')), ()),
    'gemm-no-store': ((
        ('if (nb < N) epi(m0 + wm + i * 16, nb, lane, M, acc1[i][j], acc2[i][j]);',
            'if (nb < N && acc1[i][j][0] == 1234.5f) '
            'epi(m0 + wm + i * 16, nb, lane, M, acc1[i][j], acc2[i][j]);'),), ()),
    'gemm-no-load': ((
        ('cp_async16_zfill(as + r * QA + c, ok ? a.row(m0 + r) + k0 + c : a.row(0), ok);',
            ''),), ()),
    'gemm-stages-4': ((('QSTAGES = 2;', 'QSTAGES = 4;'),), ()),
    'gemm-no-barrier': ((
        ('            // every thread is past the chunk before: its stage may be loaded again\n'
            '            __syncthreads();', ''),), ()),
    'late-slab-load': ((
        ('                load_next();\n                gates_mma<H>(acc, hc, w_s, mt0, u0, lane);\n',
            '                gates_mma<H>(acc, hc, w_s, mt0, u0, lane);\n                load_next();\n'),),
        ()),
}
# variants that change only some kinds' code
ONLY_FOR = {'late-slab-load': ('cat', 'enc5')}
SOURCES = {'fused': 'lstm_scan.cu', 'cat': 'lstm_cat.cu',
    'enc5': 'lstm_enc.cu'}


def start_build(name, csrc, edits, flags, build_dir, source):
    """Copy csrc, apply the edits to lstm_tc.cuh, start nvcc on source;
    returns (process, library path)."""
    from pufferlib_tpu_torch.ops.cuda import _build
    src = os.path.join(build_dir, name)
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(csrc, src)
    if edits:
        path = os.path.join(src, 'lstm_tc.cuh')
        with open(path) as f:
            text = f.read()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f'{name}: {old!r} is not in lstm_tc.cuh')
            text = text.replace(old, new)
        with open(path, 'w') as f:
            f.write(text)
    lib = os.path.join(build_dir, f'lib{source[:-3]}-{name}.so')
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, '-o', lib,
        os.path.join(src, source)]
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
    parser.add_argument('--kind', choices=sorted(SOURCES), default='fused')
    parser.add_argument('--baseline', help='another csrc/ directory')
    parser.add_argument('--only', nargs='*', default=None,
        help=f'variants among {sorted(ABLATIONS)} (default: all)')
    args = parser.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit('ablate_lstm_tc_torch needs a CUDA device')
    import chip_smoke
    from pufferlib_tpu_torch.ops.cuda import (
        _build, lstm_cat, lstm_enc, lstm_scan)
    kernel = {'fused': lstm_scan, 'cat': lstm_cat,
        'enc5': lstm_enc}[args.kind].KERNEL
    source = SOURCES[args.kind]
    from pufferlib_tpu_torch.ops.cuda.timing import card_line, l2_flush_buffer
    card = card_line()
    csrc = os.path.join(REPO, 'pufferlib_tpu_torch', 'csrc')
    build_dir = os.path.join(_build.BUILD_DIR, 'ablate')
    os.makedirs(build_dir, exist_ok=True)
    names = args.only if args.only is not None else [n for n in ABLATIONS
        if args.kind in ONLY_FOR.get(n, (args.kind,))]
    specs = {'as-is': (csrc, (), ())}
    specs.update({n: (csrc, *ABLATIONS[n]) for n in names})
    if args.baseline:
        specs['baseline'] = (os.path.abspath(args.baseline), (), ())
    start = time.perf_counter()
    pending = {n: start_build(n, *spec, build_dir, source)
        for n, spec in specs.items()}
    libs = {}
    for name, (proc, lib) in pending.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed on variant {name}:\n{out}')
        libs[name] = load(lib, kernel)
    print(f'built {len(libs)} variants in {time.perf_counter() - start:.1f} s',
        flush=True)

    flush = l2_flush_buffer()
    order = list(specs) + list(reversed(specs))
    runs = {n: [] for n in specs}
    for name in order:
        kernel._lib = libs[name]
        print(f'{name}:', flush=True)
        runs[name].append(chip_smoke.time_tc_phases(torch, flush,
            np.random.RandomState(0), args.kind))
    kernel._lib = None
    means = {n: {k: sum(r[k] for r in rs) / len(rs) for k in rs[0]}
        for n, rs in runs.items()}
    print(json.dumps({'card': card, 'kind': args.kind,
        'shape': 'T=16 B=8192 D=H=128' + (' F=49' if args.kind == 'enc5'
            else '') + ' bf16',
        'phases_ms': means}), flush=True)
    return means


if __name__ == '__main__':
    main()
