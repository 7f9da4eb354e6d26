"""Where the time of the bf16 tensor-core kernels of lstm_scan,
lstm_scan_fused, lstm_scan_cat or enc5 goes, by ablation, on one NVIDIA
GPU.

    python3 tools/ablate_lstm_tc_torch.py [--kind fused|cat|enc5|scan]
        [--baseline CSRC_DIR] [--only NAME ...]

The machines the port is measured on run no stall profiler, so this tool
removes one part of the recurrent loops of csrc/lstm_tc.cuh at a time and
times what is left. It builds the kind's source
(pufferlib_tpu_torch/csrc/lstm_scan.cu for fused, the default, and scan,
lstm_cat.cu for cat, lstm_enc.cu for enc5) as it is and in these
variants, each a copy of the sources with one edit, built by nvcc into a
library of its own (under pufferlib_tpu_torch/_build/):

- no-slab: the loops read no XW / P values, and scan's loops no x_proj
  (zeros in their place; in the backward the activations of those zeros
  then fold to constants);
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
  before it;
- xp-reorder-slab (scan; not an ablation but the other design of its
  forward): a pass writes x_proj into an f32 slab in the loops' fragment
  order (slab_index, in scratch from the stream's memory pool, kept
  between calls), and fused's forward loop reads that, instead of the
  loop reading x_proj in its natural order;
- splitk-no-ring (every kind; the split-K before its redesign): the
  weight gradients' split-K on the register-staged 64 x 64 kernel
  (gemm_tn_splitk_mma) for every source, at the same split count.

With --baseline, also the same source of another csrc/ directory with the
same C interface (an earlier version of these kernels). The variants run
in turns, forward and back, each twice, at T = 16, B = 8192, D = H = 128
(enc5: F = 49), bf16, and each run times the phases of the forward and
the backward (chip_smoke.time_tc_phases: pre-pass, loop, dx, dW + db;
enc5's encoder in both pre-passes, dpre for dx; scan's forward loop
alone and its backward loop and dW; cold L2). An
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

# the other design of scan's forward: x_proj reordered into fused's f32
# slab by a pass of its own, then fused's loop
XP_REORDER_KERNEL = """template <int H, typename S>
__global__ void xp_reorder(const S* __restrict__ xp, float* __restrict__ slab, int T, int B,
                           int rtiles) {
    const long long n = (long long)T * B * 4 * H;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += (long long)gridDim.x * blockDim.x) {
        const long long m = i / (4 * H);
        const int c = (int)(i % (4 * H)), t = (int)(m / B), r = (int)(m % B);
        slab[slab_index(t, r, c / H, c % H, rtiles, H / 8)] = ld(xp, (size_t)i);
    }
}

"""
XP_LOOP_LAUNCH = """    auto kernel = forward_loop<H, XP, S>;
    if ((err = prepare(kernel, Geo<H>::FWD_SMEM)) != cudaSuccess) return err;
    kernel<<<(B + BR - 1) / BR, NTC, Geo<H>::FWD_SMEM, stream>>>(xp, nullptr, h0, c0, w16, outs,
                                                                 cseq, hT, cT, T, B);
    return cudaGetLastError();"""
XP_SLAB_LAUNCH = """    const int nblk = (B + BR - 1) / BR;
    // the slab from the stream's pool, which keeps what it frees, so that
    // only the first call pays for the allocation
    int dev = 0;
    cudaMemPool_t pool;
    unsigned long long keep = ~0ull;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetDefaultMemPool(&pool, dev)) != cudaSuccess ||
        (err = cudaMemPoolSetAttribute(pool, cudaMemPoolAttrReleaseThreshold, &keep)) !=
            cudaSuccess)
        return err;
    float* slab = nullptr;
    if ((err = cudaMallocAsync(reinterpret_cast<void**>(&slab),
                               sizeof(float) * (size_t)T * nblk * BR * 4 * H, stream)) !=
        cudaSuccess)
        return err;
    xp_reorder<H, S><<<132 * 16, 256, 0, stream>>>(xp, slab, T, B, 4 * nblk);
    auto kernel = forward_loop<H, FUSED>;
    if ((err = prepare(kernel, Geo<H>::FWD_SMEM)) != cudaSuccess) return err;
    kernel<<<nblk, NTC, Geo<H>::FWD_SMEM, stream>>>(slab, nullptr, h0, c0, w16, outs, cseq, hT,
                                                    cT, T, B);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    return cudaFreeAsync(slab, stream);"""

# variant -> (edits of lstm_tc.cuh as (old, new) pairs, or of another file
# of csrc/ as (file, old, new), extra nvcc flags)
ABLATIONS = {
    'no-slab': ((
        ('v[mt][g] = __ldg(\n                    reinterpret_cast<const float4*>(slab + '
            '(tile * 4 + g) * 128 + lane * 4));', 'v[mt][g] = make_float4(0.f, 0.f, 0.f, 0.f);'),
        ('it.p[g] = __ldg(reinterpret_cast<const float4*>(pre + (tile * 4 + g) * 128 + '
            'lane * 4));', 'it.p[g] = make_float4(0.f, 0.f, 0.f, 0.f);'),
        ('if (r < nrows) v[mt][g][half] = XpPair<S>::load(p + g * H);', '')), ()),
    'no-mma': ((
        ('gates_mma<H>(acc, hc, w_s, mt0, u0, lane);',
            'memset(acc, 0, sizeof acc);'),
        ('gates_mma<H>(acc, h_s, w_s, mt0, (ug0 + ug) * 8, lane);', ''),
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
    'xp-reorder-slab': ((
        ("// Mode XP (lstm_scan): x_proj", XP_REORDER_KERNEL + "// Mode XP (lstm_scan): x_proj"),
        (XP_LOOP_LAUNCH, XP_SLAB_LAUNCH)), ()),
    'splitk-no-ring': ((
        ('lstm_common.cuh',
            'if (M % 8 == 0 && N % 8 == 0 && ring_serves(a) && ring_serves(bm)) {',
            'if (false) {'),), ()),
}
# variants that change only some kinds' code
ONLY_FOR = {'late-slab-load': ('cat', 'enc5'), 'xp-reorder-slab': ('scan',)}
SOURCES = {'fused': 'lstm_scan.cu', 'cat': 'lstm_cat.cu',
    'enc5': 'lstm_enc.cu', 'scan': 'lstm_scan.cu'}


def start_build(name, csrc, edits, flags, build_dir, source):
    """Copy csrc, apply the edits (to lstm_tc.cuh unless an edit names
    its file), start nvcc on source; returns (process, library path)."""
    from pufferlib_tpu_torch.ops.cuda import _build
    src = os.path.join(build_dir, name)
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(csrc, src)
    for edit in edits:
        fname, old, new = edit if len(edit) == 3 else ('lstm_tc.cuh', *edit)
        path = os.path.join(src, fname)
        with open(path) as f:
            text = f.read()
        if old not in text:
            raise RuntimeError(f'{name}: {old!r} is not in {fname}')
        with open(path, 'w') as f:
            f.write(text.replace(old, new))
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
    kernel = {'fused': lstm_scan, 'cat': lstm_cat, 'enc5': lstm_enc,
        'scan': lstm_scan}[args.kind].KERNEL
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
