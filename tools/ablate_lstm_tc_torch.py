"""Where the time of the bf16 tensor-core kernels of lstm_scan,
lstm_scan_fused, lstm_scan_cat, enc5 or the archived enc2, enc3, enc4 and
enc6 backwards goes, by ablation, on one NVIDIA GPU.

    python3 tools/ablate_lstm_tc_torch.py
        [--kind fused|cat|enc5|scan|enc2|enc3|enc4|enc6]
        [--baseline CSRC_DIR] [--only NAME ...]

The machines the port is measured on run no stall profiler, so this tool
removes one part of the recurrent loops of csrc/lstm_tc.cuh at a time and
times what is left. It builds the kind's source
(pufferlib_tpu_torch/csrc/lstm_scan.cu for fused, the default, and scan,
lstm_cat.cu for cat, lstm_enc.cu for enc5, lstm_archive.cu for the
archived kinds) as it is and in these variants, each a copy of the sources with one
edit, built by nvcc into a library of its own (under
pufferlib_tpu_torch/_build/):

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
  (gemm_tn_splitk_mma) for every source, at the same split count;
- enc2-xp (enc2; not an ablation but the other design of its backward):
  instead of the P pre-pass (its epilogue bf16(s1 + b) + s2) and the
  reverse loop of enc4, a GEMM writes the projection xp = bf16(x @ W_ih
  + b) as a bf16 (T, B, 4H) slab, and mode XP's reverse loop reads it,
  recomputes xp_t + h_prev @ W_hh each step and sums db from the rounded
  dgates (per step, into a table in shared memory);
- one-chain (every kind but scan, whose reverse loop is another; not an
  ablation but the schedule that the archived enc6 set out to beat, its
  TPU kernel's enc5): the reverse loop's two barriers a step, each over
  one half of the block (half_sync), become block-wide __syncthreads, so
  that the block's 64 rows step as one chain instead of two independent
  halves of 32 whose products and cell math may overlap. Both halves
  pass the same number of barriers a step, so nothing waits forever; the
  numbers are the same bit for bit, only the schedule differs.

With --baseline, also the same source of another csrc/ directory with the
same C interface (an earlier version of these kernels). The variants run
in turns, forward and back, each twice, at T = 16, B = 8192, D = H = 128
(enc5 and the archived kinds: F = 49), bf16, and each run times the
phases of the forward and the backward (chip_smoke.time_tc_phases:
pre-pass, loop, dx, dW + db; enc5's encoder in both pre-passes, dpre for
dx; scan's forward loop alone and its backward loop and dW; the archived
kinds' backward alone, enc2-xp's projection in place of the pre-pass;
cold L2), and the reverse loop's kernel alone in one whole backward call
as torch.profiler reports its device time ('backward loop kernel': a
phase is the difference of two means, and reads up to 0.1 ms apart run
to run where the kernel alone does not). An
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

# the other design of enc2's backward, which the H100 measured no faster
# than the P pre-pass (PERF.md): no P pre-pass, but the
# projection xp = bf16(x @ W_ih + b) as a GEMM into a (T, B, 4H) bf16 slab
# (in the P slab's memory, which holds it), and mode XP's reverse loop on
# it, which recomputes xp_t + h_prev @ W_hh each step and sums db from the
# rounded dgates: each step's sum over a warp's rows into the warp's row of
# a table in shared memory (held in registers, sixteen more values a
# thread at H = 128 spill from a loop already at its 128 registers)
XP_DB_LOOP = (
    ("""    static_assert(XP_BWD_SMEM <= (size_t)MAX_SMEM,
                  "W_hh, the dgates tile and the h_prev tile must fit");""",
     """    static constexpr size_t XP_DB_SMEM = XP_BWD_SMEM + sizeof(float) * 2 * WPU * G;
    static_assert(XP_DB_SMEM <= (size_t)MAX_SMEM, "db must fit");"""),
    ("""template <int H, typename S>
__global__ void __launch_bounds__(NTC, 1) xp_backward_loop(""",
     """template <int H, typename S, bool DB = false>
__global__ void __launch_bounds__(NTC, 1) xp_backward_loop("""),
    ("""        float* __restrict__ dgf, int T, int B) {""",
     """        float* __restrict__ dgf, float* __restrict__ db_part, int T, int B) {"""),
    ("""    stage_h_prev<H>(h_s, h16, outs, T - 1, B, row0, nrows, 0, BR, 0, NTC);
    cp_async_commit();
    float dh[UPW][MT][4], dc[UPW][MT][4];""",
     """    stage_h_prev<H>(h_s, h16, outs, T - 1, B, row0, nrows, 0, BR, 0, NTC);
    cp_async_commit();
    float* db_s = reinterpret_cast<float*>(h_s + BR * GE::HS);
    float* db_w = db_s + (side * GE::WPU + wl % GE::WPU) * G;
    if constexpr (DB)
        for (int i = threadIdx.x; i < 2 * GE::WPU * G; i += NTC) db_s[i] = 0.f;
    float dh[UPW][MT][4], dc[UPW][MT][4];"""),
    ("""            gates_mma<H>(acc, h_s, w_s, mt0, (ug0 + ug) * 8, lane);""",
     """            float dbs[4][2] = {};
            gates_mma<H>(acc, h_s, w_s, mt0, (ug0 + ug) * 8, lane);"""),
    ("""                        if (ok && dgf) st2(dgf + (base + r) * G + g * H + j, d[0][g], d[1][g]);
""",
     """                        if (ok && dgf) st2(dgf + (base + r) * G + g * H + j, d[0][g], d[1][g]);
                        if (DB && ok) {
                            dbs[g][0] += to_cdt<bf16>(d[0][g]);
                            dbs[g][1] += to_cdt<bf16>(d[1][g]);
                        }
"""),
    ("""                }
        }
        // the half's dgates are in d_s""",
     """                }
            if constexpr (DB) {
#pragma unroll
                for (int g = 0; g < 4; ++g)
#pragma unroll
                    for (int q = 0; q < 2; ++q) {
                        float v = dbs[g][q];
                        v += __shfl_xor_sync(0xffffffffu, v, 4);
                        v += __shfl_xor_sync(0xffffffffu, v, 8);
                        v += __shfl_xor_sync(0xffffffffu, v, 16);
                        if (gid == 0) db_w[g * H + j + q] += v;
                    }
            }
        }
        // the half's dgates are in d_s"""),
    ("""                st2(dc0 + i, dc[ug][mt][2 * half], dc[ug][mt][2 * half + 1]);
            }
}

// The GEMMs over all T*B rows""",
     """                st2(dc0 + i, dc[ug][mt][2 * half], dc[ug][mt][2 * half + 1]);
            }
    if constexpr (DB) {
        __syncthreads();
        for (int n = threadIdx.x; n < G; n += NTC) {
            float s = 0.f;
            for (int q = 0; q < 2 * GE::WPU; ++q) s += db_s[q * G + n];
            db_part[(size_t)blockIdx.x * G + n] = s;
        }
    }
}

// The GEMMs over all T*B rows"""),
    ("""        F32 ? reinterpret_cast<float*>(dxp) : nullptr, T, B);""",
     """        F32 ? reinterpret_cast<float*>(dxp) : nullptr, nullptr, T, B);"""),
    ("""// relu that keeps a NaN""",
     """// bf16(s1 + b) into a row-major (M, N) array: the projection slab xp
struct ProjOut {
    bf16* out;
    const float* b;
    int N;
    __device__ __forceinline__ void operator()(long long mb, int nb, int lane, long long M,
                                               const float (&s1)[4], const float (&)[4]) const {
        const int n = nb + lane % 4 * 2;
        const float b0 = __ldg(b + n), b1 = __ldg(b + n + 1);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const long long m = mb + lane / 4 + 8 * half;
            if (m < M) st2(out + m * N + n, s1[2 * half] + b0, s1[2 * half + 1] + b1);
        }
    }
};

// relu that keeps a NaN"""),
    ("""    const GatesOut<SUM> slab{pre, b, B, H, 4 * nblk};
    if ((err = rows_gemm(xs, wi, D, h_prev, wh, H, slab, M, G, stream)) != cudaSuccess ||
        phases < 2)
        return err;
    auto kernel = backward_loop<H, rounded_acts(MODE), rounded_db(MODE)>;
    if ((err = prepare(kernel, Geo<H>::BWD_SMEM)) != cudaSuccess) return err;
    kernel<<<nblk, NTC, Geo<H>::BWD_SMEM, stream>>>(pre, c0, w16 + (size_t)D * G, cseq, g_outs,
                                                    g_hT, g_cT, dh0, dc0, dg, db_part, T, B);""",
     """    if constexpr (MODE == ENC2) {
        bf16* xp = reinterpret_cast<bf16*>(pre);
        const BRows wn{w16, G};
        if ((err = rows_gemm(xs, wn, D, xs, wn, 0, ProjOut{xp, b, G}, M, G, stream)) !=
                cudaSuccess ||
            phases < 2)
            return err;
        auto kernel = xp_backward_loop<H, bf16, true>;
        if ((err = prepare(kernel, Geo<H>::XP_DB_SMEM)) != cudaSuccess) return err;
        kernel<<<nblk, NTC, Geo<H>::XP_DB_SMEM, stream>>>(xp, h16, c0, w16 + (size_t)D * G, outs,
                                                          cseq, g_outs, g_hT, g_cT, dh0, dc0, dg,
                                                          nullptr, db_part, T, B);
    } else {
        const GatesOut<SUM> slab{pre, b, B, H, 4 * nblk};
        if ((err = rows_gemm(xs, wi, D, h_prev, wh, H, slab, M, G, stream)) != cudaSuccess ||
            phases < 2)
            return err;
        auto kernel = backward_loop<H, rounded_acts(MODE), rounded_db(MODE)>;
        if ((err = prepare(kernel, Geo<H>::BWD_SMEM)) != cudaSuccess) return err;
        kernel<<<nblk, NTC, Geo<H>::BWD_SMEM, stream>>>(pre, c0, w16 + (size_t)D * G, cseq,
                                                        g_outs, g_hT, g_cT, dh0, dc0, dg, db_part,
                                                        T, B);
    }"""),
)

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
    'enc2-xp': (XP_DB_LOOP, ()),
    'one-chain': ((
        ('        half_sync(side);\n        dh_mma<H>(dh, d_s, w_s, mt0, ug0, lane);\n'
            '        half_sync(side);',
            '        __syncthreads();\n        dh_mma<H>(dh, d_s, w_s, mt0, ug0, lane);\n'
            '        __syncthreads();'),), ()),
}
# variants that change only some kinds' code
ARCHIVED = ('enc2', 'enc3', 'enc4', 'enc6')
ONLY_FOR = {'late-slab-load': ('cat', 'enc5'), 'xp-reorder-slab': ('scan',),
    'enc2-xp': ('enc2',), 'one-chain': ('fused', 'cat', 'enc5') + ARCHIVED}
SOURCES = {'fused': 'lstm_scan.cu', 'cat': 'lstm_cat.cu',
    'enc5': 'lstm_enc.cu', 'scan': 'lstm_scan.cu',
    **{kind: 'lstm_archive.cu' for kind in ARCHIVED}}


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


def loop_kernel_ms(torch, np, flush, kind, T=16, B=8192):
    """Device ms of the reverse loop's kernel (every kind's backward runs
    one whose name holds 'backward_loop') in a whole bf16 backward call
    of kind at the main shape, by torch.profiler, cold L2."""
    import chip_smoke
    from pufferlib_tpu_torch.ops.cuda.timing import profiled_ms
    launch_fwd, launch_bwd = chip_smoke.lstm_kinds()[kind][:2]
    args, grads, cdt = chip_smoke.lstm_case(torch, np.random.RandomState(0),
        kind, T, B, 'bfloat16')
    with torch.no_grad():
        outs, _, _, cseq = launch_fwd(*args, cdt)
        return profiled_ms(lambda: launch_bwd(*args, outs, cseq, *grads,
            cdt), flush, 'backward_loop')


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
        _build, archive, lstm_cat, lstm_enc, lstm_scan)
    kernel = {'fused': lstm_scan, 'cat': lstm_cat, 'enc5': lstm_enc,
        'scan': lstm_scan, **{kind: archive for kind in ARCHIVED}}[
        args.kind].KERNEL
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
        phases = chip_smoke.time_tc_phases(torch, flush,
            np.random.RandomState(0), args.kind)
        phases['backward loop kernel'] = loop_kernel_ms(torch, np, flush,
            args.kind)
        print(f'  backward loop kernel {phases["backward loop kernel"]:.4f} '
            'ms (profiler)', flush=True)
        runs[name].append(phases)
    kernel._lib = None
    means = {n: {k: sum(r[k] for r in rs) / len(rs) for k in rs[0]}
        for n, rs in runs.items()}
    print(json.dumps({'card': card, 'kind': args.kind,
        'shape': 'T=16 B=8192 D=H=128' + (' F=49' if args.kind in
            ('enc5',) + ARCHIVED else '') + ' bf16',
        'phases_ms': means}), flush=True)
    return means


if __name__ == '__main__':
    main()
