// Device code shared by the LSTM kernels csrc/lstm_cat.cu, csrc/lstm_enc.cu,
// csrc/lstm_scan.cu and csrc/lstm_archive.cu, for Hopper (sm_90a). See
// those files for which TPU kernel each replaces and what bounds it.
//
// One design serves them all; a Mode (below) says which function a cell
// kernel computes per step:
//
// * cell_forward: one block per BT = 32 batch rows walks t = 0..T-1. Per
//   step it builds the operand [x_t | h] (rounded to the compute dtype)
//   in shared memory, computes gates = [x_t | h] @ [W_ih; W_hh] + b with
//   f32 accumulation, and updates c and h in registers. [W_ih; W_hh] is
//   (D+H, 4H) = 256 KiB in f32 at H = 128, more than a block's 227 KiB of
//   shared memory, so it is streamed from L2 (where it stays resident:
//   every block reads the same weights) in chunks of KC rows, each
//   rounded to the compute dtype as it is staged. With ENC the step first
//   computes x_t = relu(feats_t @ W_enc + b_enc) from a W_enc held in
//   shared memory, so no encoded sequence ever reaches device memory.
//   The modes XP and FUSED keep two f32 sums apart, as their TPU kernels
//   do: the recurrent h @ W_hh, and the term it is added to (x_proj_t
//   read from device memory, or x_t @ W_ih + b computed first).
// * cell_backward: the same blocks walk t = T-1..0. Per step they
//   recompute the gates from [x_t | h_prev] (h_prev read back from the
//   stored outs), carry the dh/dc chain in registers, round dgates to the
//   compute dtype, and compute [dx | dh_prev] = dgates @ [W_ih; W_hh]^T,
//   again streaming the weights in chunks. dgates go to a (T*B, 4H) slab
//   in the compute dtype; db (and, with ENC, db_enc) are summed per block.
//   Its pieces (gate_sums, dgates_chain, cols_gemm, store_bias_partials)
//   also serve the archived schedules of csrc/lstm_archive.cu. Both cell
//   kernels walk a range of steps, so that a launch per timestep (the
//   time-major variant) is the same kernel over one step.
// * gemm_tn_splitk + reduce_partials: the weight gradients
//   dW = [x | h_prev]^T dgates (and dW_enc = feats^T dpre) are
//   contractions over K = T*B rows. The TPU kernels add them into one
//   output block across a sequential grid; Hopper blocks run at once, so
//   each block here writes the partial sum of its K-split, and a second
//   pass adds the partials in split order. No atomics: the result is the
//   same from run to run.
//
// Threads: NT = 256 per block. Thread t owns hidden unit j = t % H and
// rows r0 .. r0+RPT-1 (r0 = (t / H) * RPT) of the block's BT rows, for
// all four gates of those (row, unit) pairs, so the cell update needs no
// exchange between threads. A warp shares its rows (broadcast reads of
// the operand) and reads consecutive weight columns (no bank conflicts).
// H must divide NT: H in {32, 64, 128}; the input width D equals H.
//
// The recurrent kernels run plain f32 FMA; the weight-gradient
// contractions run on bf16 tensor cores in bf16 mode and on FMA in f32.
// Products of bf16-rounded operands are exact in f32 either way, so in
// bf16 mode the kernels differ from the plain PyTorch versions only in
// the order of f32 sums.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace lstm {

constexpr int NT = 256;      // threads per block
constexpr int BT = 32;       // batch rows per block (ROWS_PER_BLOCK in python)
constexpr int KC = 16;       // weight rows (or columns) staged per chunk
constexpr int MAX_SMEM = 227 * 1024;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const bf16* p, size_t i) {
    return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(bf16* p, size_t i, float v) {
    p[i] = __float2bfloat16_rn(v);
}

// v rounded to the compute dtype E, carried in f32
template <typename E>
__device__ __forceinline__ float to_cdt(float v) {
    if constexpr (std::is_same<E, bf16>::value)
        return __bfloat162float(__float2bfloat16_rn(v));
    return v;
}

__device__ __forceinline__ float sigm(float x) { return 1.f / (1.f + expf(-x)); }

// The function a cell kernel computes per step, after its TPU kernel
enum Mode {
    CAT,    // gates = [x_t | h] @ [W_ih; W_hh] + b: one sum over K = D + H
    ENC,    // CAT behind the fused encoder; backward with f32 activations
            // and db from the unrounded dgates (lstm_enc._bwd_kernel)
    ENC5,   // backward only: ENC with the activations rounded to the compute
            // dtype and db from the rounded dgates (lstm_enc5._bwd_kernel)
    XP,     // gates = x_proj_t + h @ W_hh: the projection is an operand, in
            // its own dtype S (lstm._fwd_kernel, _bwd_kernel)
    FUSED,  // gates = (x_t @ W_ih + b) + h @ W_hh: two f32 sums, then added
            // (lstm._fwd_fused_kernel, _bwd_fused_kernel)
    // The archived variants (csrc/lstm_archive.cu), all behind the encoder:
    ENC2,   // FUSED whose first sum passes through the compute dtype before
            // the recurrent one is added; backward with f32 activations and
            // db from the rounded dgates (archive/lstm_enc2)
    ENC3,   // backward only: activations rounded, db from the unrounded
            // dgates (archive/lstm_enc3._bwd_kernel)
    ENC4,   // backward only: f32 activations, db from the rounded dgates
            // (archive/lstm_enc4._bwd_kernel)
    ENC6,   // backward only: ENC5's function on two half tiles per block
            // (archive/lstm_enc6._bwd_kernel)
};
__host__ __device__ constexpr bool has_encoder(int mode) {
    return mode == ENC || mode == ENC5 || mode >= ENC2;
}
__host__ __device__ constexpr bool two_sums(int mode) {
    return mode == XP || mode == FUSED || mode == ENC2;
}
// the gate activations pass through the compute dtype (a stored slab on the TPU)
__host__ __device__ constexpr bool rounded_acts(int mode) {
    return mode == ENC5 || mode == ENC3 || mode == ENC6;
}
// db sums the dgates rounded to the compute dtype, not the f32 ones
__host__ __device__ constexpr bool rounded_db(int mode) {
    return mode == ENC5 || mode == ENC2 || mode == ENC4 || mode == ENC6;
}

template <int H>
struct Tile {
    static_assert(NT % H == 0, "H must divide the block");
    static constexpr int D = H, K = D + H, G = 4 * H;
    static constexpr int RG = NT / H;      // row groups
    static constexpr int RPT = BT / RG;    // rows per thread
    static_assert(RPT % 4 == 0, "rows per thread must be a multiple of 4");
};

__device__ __forceinline__ float4 to_cdt4(float4 v, bool bf16_cdt) {
    if (bf16_cdt) {
        v.x = to_cdt<bf16>(v.x);
        v.y = to_cdt<bf16>(v.y);
        v.z = to_cdt<bf16>(v.z);
        v.w = to_cdt<bf16>(v.w);
    }
    return v;
}

// A weight chunk passes through registers on its way to shared memory,
// which lets a thread fetch its share of chunk c + 1 from L2 before it
// works on chunk c, so that the load latency hides behind the FMAs.
//
// Row chunk: rows k0 .. k0+KC of [W_ih; W_hh] (K, G), a thread's share as
// LOADS float4s; stored as w_s[kk * G + n].
template <int H>
struct RowChunk {
    static constexpr int G4 = Tile<H>::G / 4;
    static constexpr int LOADS = KC * G4 / NT;
    static_assert(KC * G4 % NT == 0, "row chunk must tile the block");
};

template <int H>
__device__ __forceinline__ void fetch_rows(float4 (&r)[RowChunk<H>::LOADS],
                                           const float* w_ih, const float* w_hh, int k0) {
    constexpr int D = Tile<H>::D, G = Tile<H>::G, G4 = RowChunk<H>::G4;
#pragma unroll
    for (int q = 0; q < RowChunk<H>::LOADS; ++q) {
        const int idx = threadIdx.x + q * NT, kk = idx / G4, n4 = idx - kk * G4;
        const int k = k0 + kk;
        const float* row = k < D ? w_ih + (size_t)k * G : w_hh + (size_t)(k - D) * G;
        r[q] = reinterpret_cast<const float4*>(row)[n4];
    }
}

template <int H, typename E>
__device__ __forceinline__ void put_rows(float* w_s, const float4 (&r)[RowChunk<H>::LOADS]) {
    constexpr int G = Tile<H>::G, G4 = RowChunk<H>::G4;
#pragma unroll
    for (int q = 0; q < RowChunk<H>::LOADS; ++q) {
        const int idx = threadIdx.x + q * NT, kk = idx / G4, n4 = idx - kk * G4;
        reinterpret_cast<float4*>(w_s + kk * G)[n4] =
            to_cdt4(r[q], std::is_same<E, bf16>::value);
    }
}

// Column chunk: columns k0 .. k0+KC of rows N0 .. N1 of [W_ih; W_hh]
// (K, G), read as float4s along the row; stored transposed as
// w_s[kk * KS + n], with the row stride padded to KS = K + 1 against bank
// conflicts. A range that leaves out W_ih (N0 = D) or W_hh (N1 = D) stages
// the other's rows at the same places.
template <int H, int N0, int N1>
struct ColChunk {
    static constexpr int KS = Tile<H>::K + 1;
    static constexpr int TOTAL = KC / 4 * (N1 - N0);  // float4s per chunk
    static constexpr int LOADS = (TOTAL + NT - 1) / NT;
    static constexpr bool FULL = TOTAL % NT == 0;
};

template <int H, int N0, int N1>
__device__ __forceinline__ void fetch_cols(float4 (&r)[ColChunk<H, N0, N1>::LOADS],
                                           const float* w_ih, const float* w_hh, int k0) {
    using CC = ColChunk<H, N0, N1>;
    constexpr int D = Tile<H>::D, G = Tile<H>::G;
#pragma unroll
    for (int q = 0; q < CC::LOADS; ++q) {
        const int idx = threadIdx.x + q * NT;
        if (!CC::FULL && idx >= CC::TOTAL) break;
        const int n = N0 + idx / (KC / 4), k4 = idx % (KC / 4);
        const float* row = n < D ? w_ih + (size_t)n * G : w_hh + (size_t)(n - D) * G;
        r[q] = reinterpret_cast<const float4*>(row + k0)[k4];
    }
}

template <int H, typename E, int N0, int N1>
__device__ __forceinline__ void put_cols(float* w_s,
                                         const float4 (&r)[ColChunk<H, N0, N1>::LOADS]) {
    using CC = ColChunk<H, N0, N1>;
    constexpr int KS = CC::KS;
#pragma unroll
    for (int q = 0; q < CC::LOADS; ++q) {
        const int idx = threadIdx.x + q * NT;
        if (!CC::FULL && idx >= CC::TOTAL) break;
        const int n = N0 + idx / (KC / 4), k4 = idx % (KC / 4);
        const float4 v = to_cdt4(r[q], std::is_same<E, bf16>::value);
        w_s[(4 * k4) * KS + n] = v.x;
        w_s[(4 * k4 + 1) * KS + n] = v.y;
        w_s[(4 * k4 + 2) * KS + n] = v.z;
        w_s[(4 * k4 + 3) * KS + n] = v.w;
    }
}

// acc[g][i] = sum_k op_s[k][r0 + i] * W[k][g*H + j] over KBEG <= k < KEND,
// rows of [W_ih; W_hh] (all K of them for the combined operand; D..K for
// the recurrent half alone, 0..D for the input half), with the weights
// streamed through w_s. op_s is (K, BT), already rounded. Every thread of
// the block must call it; it ends with a barrier, after which op_s and
// w_s may be written again. PREFETCH keeps the next chunk in flight
// during this one: it pays where the block already runs one per SM (the
// backward, 180 registers), and costs the forward its second block per
// SM (126 registers without it).
template <int H, typename E, bool PREFETCH, int KBEG = 0, int KEND = Tile<H>::K>
__device__ __forceinline__ void gates_gemm(float (&acc)[4][Tile<H>::RPT],
                                           const float* op_s, float* w_s,
                                           const float* w_ih, const float* w_hh,
                                           int r0, int j) {
    constexpr int G = Tile<H>::G, RPT = Tile<H>::RPT;
    static_assert((KEND - KBEG) % KC == 0, "the range must be whole chunks");
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[g][i] = 0.f;
    float4 next[RowChunk<H>::LOADS];
    if (PREFETCH) fetch_rows<H>(next, w_ih, w_hh, KBEG);
    for (int k0 = KBEG; k0 < KEND; k0 += KC) {
        if (!PREFETCH) fetch_rows<H>(next, w_ih, w_hh, k0);
        put_rows<H, E>(w_s, next);
        __syncthreads();
        if (PREFETCH && k0 + KC < KEND) fetch_rows<H>(next, w_ih, w_hh, k0 + KC);
#pragma unroll 4
        for (int kk = 0; kk < KC; ++kk) {
            const float* wr = w_s + kk * G;
            const float w[4] = {wr[j], wr[H + j], wr[2 * H + j], wr[3 * H + j]};
            const float4* xv = reinterpret_cast<const float4*>(op_s + (k0 + kk) * BT + r0);
#pragma unroll
            for (int q = 0; q < RPT / 4; ++q) {
                const float4 v = xv[q];
#pragma unroll
                for (int g = 0; g < 4; ++g) {
                    acc[g][4 * q] = fmaf(v.x, w[g], acc[g][4 * q]);
                    acc[g][4 * q + 1] = fmaf(v.y, w[g], acc[g][4 * q + 1]);
                    acc[g][4 * q + 2] = fmaf(v.z, w[g], acc[g][4 * q + 2]);
                    acc[g][4 * q + 3] = fmaf(v.w, w[g], acc[g][4 * q + 3]);
                }
            }
        }
        __syncthreads();
    }
}

// x[i] = cdt(relu(feats_t[r0 + i] @ W_enc[:, j] + be)) from f_s (F, BT)
// and we_s (F, D), both already rounded
template <int H>
__device__ __forceinline__ void encode_rows(float (&x)[Tile<H>::RPT],
                                            const float* f_s, const float* we_s,
                                            float be, int F, int r0, int j) {
    constexpr int D = Tile<H>::D, RPT = Tile<H>::RPT;
#pragma unroll
    for (int i = 0; i < RPT; ++i) x[i] = 0.f;
    for (int k = 0; k < F; ++k) {
        const float w = we_s[k * D + j];
        const float4* fv = reinterpret_cast<const float4*>(f_s + k * BT + r0);
#pragma unroll
        for (int q = 0; q < RPT / 4; ++q) {
            const float4 v = fv[q];
            x[4 * q] = fmaf(v.x, w, x[4 * q]);
            x[4 * q + 1] = fmaf(v.y, w, x[4 * q + 1]);
            x[4 * q + 2] = fmaf(v.z, w, x[4 * q + 2]);
            x[4 * q + 3] = fmaf(v.w, w, x[4 * q + 3]);
        }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        const float v = x[i] + be;
        x[i] = v < 0.f ? 0.f : v;  // relu that keeps a NaN, as jnp.maximum
    }
}

// op_s[k][r] = cdt(src[(base + r) * width + k]) for the block's rows,
// zero past the batch edge
template <typename E, typename S>
__device__ __forceinline__ void load_rows(float* op_s, const S* src, size_t base,
                                          int width, int nrows) {
    for (int idx = threadIdx.x; idx < BT * width; idx += NT) {
        const int r = idx / width, k = idx - r * width;
        op_s[k * BT + r] = r < nrows ? to_cdt<E>(ld(src, (base + r) * width + k)) : 0.f;
    }
}

// pre[g][i] = x_proj_t[r0 + i][g*H + j] in f32, zero past the batch edge
template <int H, typename S>
__device__ __forceinline__ void load_x_proj(float (&pre)[4][Tile<H>::RPT], const S* xp,
                                            size_t base, int nrows, int r0, int j) {
    constexpr int G = Tile<H>::G, RPT = Tile<H>::RPT;
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int g = 0; g < 4; ++g)
            pre[g][i] = r0 + i < nrows ? ld(xp, (base + r0 + i) * G + g * H + j) : 0.f;
}

// The gate pre-activations of one step, into acc, from the operand
// [x_t | h] in op_s. CAT, ENC, ENC3-6: one sum over K = D + H, plus b.
// FUSED: (x_t @ W_ih + b) + h @ W_hh; ENC2: the same with the first sum
// rounded to the compute dtype. XP: pre (x_proj_t, loaded by the caller)
// + h @ W_hh.
template <int H, typename E, int MODE, bool PREFETCH>
__device__ __forceinline__ void gate_sums(float (&acc)[4][Tile<H>::RPT],
                                          float (&pre)[4][Tile<H>::RPT], const float* op_s,
                                          float* w_s, const float* w_ih, const float* w_hh,
                                          const float (&bias)[4], int r0, int j) {
    constexpr int D = Tile<H>::D, K = Tile<H>::K, RPT = Tile<H>::RPT;
    if constexpr (MODE == FUSED || MODE == ENC2) {
        gates_gemm<H, E, PREFETCH, 0, D>(acc, op_s, w_s, w_ih, w_hh, r0, j);
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
            for (int i = 0; i < RPT; ++i) {
                pre[g][i] = acc[g][i] + bias[g];
                if constexpr (MODE == ENC2) pre[g][i] = to_cdt<E>(pre[g][i]);
            }
    }
    if constexpr (two_sums(MODE)) {
        gates_gemm<H, E, PREFETCH, D, K>(acc, op_s, w_s, w_ih, w_hh, r0, j);
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
            for (int i = 0; i < RPT; ++i) acc[g][i] = pre[g][i] + acc[g][i];
    } else {
        gates_gemm<H, E, PREFETCH>(acc, op_s, w_s, w_ih, w_hh, r0, j);
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
            for (int i = 0; i < RPT; ++i) acc[g][i] += bias[g];
    }
}

// ax[s][i] = sum_k dg_s[k][r0 + i] * W_ih[j][k] and ah[s][i] the same with
// W_hh, for the NH row tiles dg_s = dg_all + s * G * BT (each (G, BT),
// already rounded): [dx | dh_prev] = dgates @ [W_ih; W_hh]^T for rows
// N0 .. N1 of the weights, whose columns are streamed through w_s, each
// staged chunk serving every tile. A range without W_ih leaves ax at zero,
// one without W_hh ah. Every thread of the block must call it; it ends
// with a barrier.
template <int H, typename E, int N0, int N1, int NH>
__device__ __forceinline__ void cols_gemm(float (&ax)[NH][Tile<H>::RPT],
                                          float (&ah)[NH][Tile<H>::RPT],
                                          const float* dg_all, float* w_s,
                                          const float* w_ih, const float* w_hh,
                                          int r0, int j) {
    constexpr int D = Tile<H>::D, G = Tile<H>::G, RPT = Tile<H>::RPT;
    constexpr bool XH = N0 < D, HH = N1 > D;
    using CC = ColChunk<H, N0, N1>;
    constexpr int KS = CC::KS;
#pragma unroll
    for (int s = 0; s < NH; ++s)
#pragma unroll
        for (int i = 0; i < RPT; ++i) ax[s][i] = ah[s][i] = 0.f;
    float4 next[CC::LOADS];
    fetch_cols<H, N0, N1>(next, w_ih, w_hh, 0);
    for (int k0 = 0; k0 < G; k0 += KC) {
        put_cols<H, E, N0, N1>(w_s, next);
        __syncthreads();
        if (k0 + KC < G) fetch_cols<H, N0, N1>(next, w_ih, w_hh, k0 + KC);
#pragma unroll 4
        for (int kk = 0; kk < KC; ++kk) {
            const float wx = XH ? w_s[kk * KS + j] : 0.f;
            const float wh = HH ? w_s[kk * KS + D + j] : 0.f;
#pragma unroll
            for (int s = 0; s < NH; ++s) {
                const float4* dv = reinterpret_cast<const float4*>(
                    dg_all + s * G * BT + (k0 + kk) * BT + r0);
#pragma unroll
                for (int q = 0; q < RPT / 4; ++q) {
                    const float4 v = dv[q];
                    if constexpr (XH) {
                        ax[s][4 * q] = fmaf(v.x, wx, ax[s][4 * q]);
                        ax[s][4 * q + 1] = fmaf(v.y, wx, ax[s][4 * q + 1]);
                        ax[s][4 * q + 2] = fmaf(v.z, wx, ax[s][4 * q + 2]);
                        ax[s][4 * q + 3] = fmaf(v.w, wx, ax[s][4 * q + 3]);
                    }
                    if constexpr (HH) {
                        ah[s][4 * q] = fmaf(v.x, wh, ah[s][4 * q]);
                        ah[s][4 * q + 1] = fmaf(v.y, wh, ah[s][4 * q + 1]);
                        ah[s][4 * q + 2] = fmaf(v.z, wh, ah[s][4 * q + 2]);
                        ah[s][4 * q + 3] = fmaf(v.w, wh, ah[s][4 * q + 3]);
                    }
                }
            }
        }
        __syncthreads();
    }
}

// One (row, unit) of the reverse step, in the order of operations of the
// TPU kernels' _bwd_kernel: the f32 dgates d (i, f, g, o) from the gate
// activations, dhv = dh + g_outs_t, c_t and c_prev. dc comes in as the
// carried dc and leaves as dc_prev.
__device__ __forceinline__ void dgates_chain(float (&d)[4], float& dc, float dhv, float ai,
                                             float af, float ag, float ao, float ct,
                                             float cp) {
    const float tc = tanhf(ct);
    const float dov = dhv * tc;
    const float dcv = dc + dhv * ao * (1.f - tc * tc);
    const float di = dcv * ag, dgg = dcv * ai, df = dcv * cp;
    d[0] = di * ai * (1.f - ai);
    d[1] = df * af * (1.f - af);
    d[2] = dgg * (1.f - ag * ag);
    d[3] = dov * ao * (1.f - ao);
    dc = dcv * af;
}

// The block's bias gradients: every thread's sums added over the row
// groups in order, into row blockIdx.x of db_part (G wide) and, with
// ENCODER, dbe_part (D wide). red is RG * (G + D) floats of shared memory
// whose last use ended on a barrier.
template <int H, bool ENCODER>
__device__ __forceinline__ void store_bias_partials(float* red, const float (&db_acc)[4],
                                                    float dbe_acc, float* db_part,
                                                    float* dbe_part, int rg, int j) {
    constexpr int D = Tile<H>::D, G = Tile<H>::G, RG = Tile<H>::RG;
    float* red_e = red + RG * G;   // (RG, D)
#pragma unroll
    for (int g = 0; g < 4; ++g) red[rg * G + g * H + j] = db_acc[g];
    if constexpr (ENCODER) red_e[rg * D + j] = dbe_acc;
    __syncthreads();
    for (int n = threadIdx.x; n < G; n += NT) {
        float s = 0.f;
        for (int q = 0; q < RG; ++q) s += red[q * G + n];
        db_part[(size_t)blockIdx.x * G + n] = s;
    }
    if constexpr (ENCODER) {
        for (int n = threadIdx.x; n < D; n += NT) {
            float s = 0.f;
            for (int q = 0; q < RG; ++q) s += red_e[q * D + n];
            dbe_part[(size_t)blockIdx.x * D + n] = s;
        }
    }
}

// xin: CAT and FUSED, x (T, B, D); ENC and ENC2, feats (T, B, F); XP,
// x_proj (T, B, 4H) in its own dtype S (S is E in the other modes). A null
// cseq skips its store: the forward of a call that needs no gradient. The
// block walks steps t_lo .. t_hi-1 of the sequence, from the state h0, c0
// before step t_lo to hT, cT after step t_hi-1: the whole sequence in one
// launch, or one step per launch with the state carried in device memory.
template <int H, typename E, typename S, int MODE>
__global__ void __launch_bounds__(NT) cell_forward(
        const S* __restrict__ xin, const float* __restrict__ h0,
        const float* __restrict__ c0, const float* __restrict__ w_enc,
        const float* __restrict__ b_enc, const float* __restrict__ w_ih,
        const float* __restrict__ w_hh, const float* __restrict__ b,
        E* __restrict__ outs, E* __restrict__ cseq, float* __restrict__ hT,
        float* __restrict__ cT, int t_lo, int t_hi, int B, int F) {
    using TL = Tile<H>;
    constexpr int D = TL::D, K = TL::K, G = TL::G, RPT = TL::RPT;
    constexpr bool ENCODER = has_encoder(MODE);
    extern __shared__ __align__(16) float smem[];
    float* xh_s = smem;               // (K, BT): [x_t | h], rounded
    float* w_s = xh_s + K * BT;       // (KC, G): staged weight rows
    float* we_s = w_s + KC * G;       // encoder: (F, D) W_enc, rounded
    float* f_s = we_s + F * D;        // encoder: (F, BT) feats_t, rounded

    const int j = threadIdx.x % H, r0 = (threadIdx.x / H) * RPT;
    const int row0 = blockIdx.x * BT;
    const int nrows = min(BT, B - row0);
    float bias[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (MODE != XP) {
#pragma unroll
        for (int g = 0; g < 4; ++g) bias[g] = b[g * H + j];
    }
    float be = 0.f;
    if constexpr (ENCODER) {
        be = b_enc[j];
        for (int i = threadIdx.x; i < F * D; i += NT) we_s[i] = to_cdt<E>(w_enc[i]);
    }
    float h[RPT], c[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        const int r = r0 + i;
        const size_t idx = (size_t)(row0 + r) * H + j;
        h[i] = r < nrows ? h0[idx] : 0.f;
        c[i] = r < nrows ? c0[idx] : 0.f;
        xh_s[(D + j) * BT + r] = to_cdt<E>(h[i]);
    }

    for (int t = t_lo; t < t_hi; ++t) {
        const size_t base = (size_t)t * B + row0;
        float acc[4][RPT], pre[4][RPT];
        if constexpr (ENCODER) {
            load_rows<E>(f_s, xin, base, F, nrows);
            __syncthreads();
            float x[RPT];
            encode_rows<H>(x, f_s, we_s, be, F, r0, j);
#pragma unroll
            for (int i = 0; i < RPT; ++i) xh_s[j * BT + r0 + i] = to_cdt<E>(x[i]);
        } else if constexpr (MODE == XP) {
            load_x_proj<H>(pre, xin, base, nrows, r0, j);
        } else {
            load_rows<E>(xh_s, xin, base, D, nrows);
        }
        __syncthreads();
        gate_sums<H, E, MODE, false>(acc, pre, xh_s, w_s, w_ih, w_hh, bias, r0, j);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
            const int r = r0 + i;
            const float ig = sigm(acc[0][i]);
            const float fg = sigm(acc[1][i]);
            const float gg = tanhf(acc[2][i]);
            const float og = sigm(acc[3][i]);
            c[i] = fg * c[i] + ig * gg;
            h[i] = og * tanhf(c[i]);
            xh_s[(D + j) * BT + r] = to_cdt<E>(h[i]);
            if (r < nrows) {
                const size_t idx = (base + r) * H + j;
                st(outs, idx, h[i]);
                if (cseq) st(cseq, idx, c[i]);
            }
        }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        const int r = r0 + i;
        if (r < nrows) {
            const size_t idx = (size_t)(row0 + r) * H + j;
            hT[idx] = h[i];
            cT[idx] = c[i];
        }
    }
}

// xin as the forward's. xo: CAT and FUSED, the x gradient (T, B, D); ENC
// and ENC5, the x slab (T, B, D) that the dW_ih contraction reads; XP,
// dx_proj (T, B, 4H), the f32 dgates stored in x_proj's dtype S. dg is the
// slab of dgates rounded to the compute dtype that the weight-gradient
// contractions read; XP passes a null dg where dx_proj serves as that
// slab (S is E, or S is f32 and the contraction rounds as it loads).
// dpre and dbe_part are ENC and ENC5 only; XP has no bias and no db_part.
// The block walks steps t_hi-1 .. t_lo, from the gradients g_hT, g_cT that
// enter step t_hi-1 to dh0, dc0 that leave step t_lo (h0 and c0 stay the
// state before step 0): the whole sequence, or one step per launch.
template <int H, typename E, typename S, int MODE>
__global__ void __launch_bounds__(NT) cell_backward(
        const S* __restrict__ xin, const float* __restrict__ h0,
        const float* __restrict__ c0, const float* __restrict__ w_enc,
        const float* __restrict__ b_enc, const float* __restrict__ w_ih,
        const float* __restrict__ w_hh, const float* __restrict__ b,
        const E* __restrict__ outs, const E* __restrict__ cseq,
        const E* __restrict__ g_outs, const float* __restrict__ g_hT,
        const float* __restrict__ g_cT, float* __restrict__ dh0,
        float* __restrict__ dc0, S* __restrict__ xo, E* __restrict__ dpre,
        E* __restrict__ dg, float* __restrict__ db_part,
        float* __restrict__ dbe_part, int t_lo, int t_hi, int B, int F) {
    using TL = Tile<H>;
    constexpr int D = TL::D, K = TL::K, G = TL::G, RPT = TL::RPT;
    constexpr bool ENCODER = has_encoder(MODE);
    extern __shared__ __align__(16) float smem[];
    float* buf = smem;                // (K, BT) [x_t | h_prev], then (G, BT) dgates
    float* w_s = buf + G * BT;        // (KC, G) weight rows / (KC, KS) columns
    float* we_s = w_s + KC * G;       // encoder: (F, D)
    float* f_s = we_s + F * D;        // encoder: (F, BT)

    const int j = threadIdx.x % H, rg = threadIdx.x / H, r0 = rg * RPT;
    const int row0 = blockIdx.x * BT;
    const int nrows = min(BT, B - row0);
    float bias[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (MODE != XP) {
#pragma unroll
        for (int g = 0; g < 4; ++g) bias[g] = b[g * H + j];
    }
    float be = 0.f;
    if constexpr (ENCODER) {
        be = b_enc[j];
        for (int i = threadIdx.x; i < F * D; i += NT) we_s[i] = to_cdt<E>(w_enc[i]);
    }
    float dh[RPT], dc[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        const int r = r0 + i;
        const size_t idx = (size_t)(row0 + r) * H + j;
        dh[i] = r < nrows ? g_hT[idx] : 0.f;
        dc[i] = r < nrows ? g_cT[idx] : 0.f;
    }
    float db_acc[4] = {0.f, 0.f, 0.f, 0.f};
    float dbe_acc = 0.f;

    for (int t = t_hi - 1; t >= t_lo; --t) {
        const size_t base = (size_t)t * B + row0;
        float x[RPT];
        float acc[4][RPT], pre[4][RPT];
        if constexpr (ENCODER) {
            load_rows<E>(f_s, xin, base, F, nrows);
            __syncthreads();
            encode_rows<H>(x, f_s, we_s, be, F, r0, j);
#pragma unroll
            for (int i = 0; i < RPT; ++i) {
                const int r = r0 + i;
                x[i] = to_cdt<E>(x[i]);
                buf[j * BT + r] = x[i];
                if (r < nrows) st(xo, (base + r) * D + j, x[i]);
            }
        } else if constexpr (MODE == XP) {
            load_x_proj<H>(pre, xin, base, nrows, r0, j);
        } else {
            load_rows<E>(buf, xin, base, D, nrows);
        }
        // h_prev: h0 at t = 0, else the stored outs of t - 1
        if (t == 0)
            load_rows<E>(buf + D * BT, h0, (size_t)row0, H, nrows);
        else
            load_rows<E>(buf + D * BT, outs, base - B, H, nrows);
        __syncthreads();
        // the second accumulator of XP and FUSED takes the registers of
        // the prefetched chunk
        gate_sums<H, E, MODE, !two_sums(MODE)>(acc, pre, buf, w_s, w_ih, w_hh, bias, r0, j);

#pragma unroll
        for (int i = 0; i < RPT; ++i) {
            const int r = r0 + i;
            const bool ok = r < nrows;
            const size_t idx = (base + r) * H + j;
            float ai = sigm(acc[0][i]);
            float af = sigm(acc[1][i]);
            float ag = tanhf(acc[2][i]);
            float ao = sigm(acc[3][i]);
            if constexpr (rounded_acts(MODE)) {
                // the enc5 activation slab is stored in the compute dtype
                ai = to_cdt<E>(ai);
                af = to_cdt<E>(af);
                ag = to_cdt<E>(ag);
                ao = to_cdt<E>(ao);
            }
            const float gout = ok ? ld(g_outs, idx) : 0.f;
            const float ct = ok ? ld(cseq, idx) : 0.f;
            const float cp = !ok ? 0.f
                : t == 0 ? c0[(size_t)(row0 + r) * H + j]
                : ld(cseq, idx - (size_t)B * H);
            float d[4];
            dgates_chain(d, dc[i], dh[i] + gout, ai, af, ag, ao, ct, cp);
#pragma unroll
            for (int g = 0; g < 4; ++g) {
                const float dcg = to_cdt<E>(d[g]);
                buf[(g * H + j) * BT + r] = dcg;
                if (ok) {
                    const size_t at = (base + r) * G + g * H + j;
                    if constexpr (MODE == XP) {
                        st(xo, at, d[g]);
                        if (dg) st(dg, at, dcg);
                    } else {
                        st(dg, at, dcg);
                        // enc5 sums the rounded slab, the others the f32 dgates
                        db_acc[g] += rounded_db(MODE) ? dcg : d[g];
                    }
                }
            }
        }
        __syncthreads();

        // [dx | dh_prev] = dgates @ [W_ih; W_hh]^T (XP: dh_prev alone),
        // streaming columns
        float ax[1][RPT], ah[1][RPT];
        cols_gemm<H, E, MODE == XP ? D : 0, K, 1>(ax, ah, buf, w_s, w_ih, w_hh, r0, j);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
            const int r = r0 + i;
            dh[i] = ah[0][i];
            if (r >= nrows) continue;
            const size_t idx = (base + r) * D + j;
            if constexpr (ENCODER) {
                const float p = to_cdt<E>(x[i] > 0.f ? ax[0][i] : 0.f);
                st(dpre, idx, p);
                dbe_acc += p;
            } else if constexpr (MODE != XP) {
                st(xo, idx, ax[0][i]);
            }
        }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        const int r = r0 + i;
        if (r < nrows) {
            const size_t idx = (size_t)(row0 + r) * H + j;
            dh0[idx] = dh[i];
            dc0[idx] = dc[i];
        }
    }
    if constexpr (MODE != XP) {
        // buf is free: the loop ended on a barrier
        store_bias_partials<H, ENCODER>(buf, db_acc, dbe_acc, db_part, dbe_part, rg, j);
    }
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint4 pack8(float a, float b, float c, float d, float e,
                                       float f, float g, float h) {
    return make_uint4(pack2(a, b), pack2(c, d), pack2(e, f), pack2(g, h));
}

// eight bf16 from a 16-byte aligned address (i a multiple of 8); only
// the tensor-core path, whose operands are bf16, calls it
__device__ __forceinline__ uint4 load8_bf16(const bf16* p, size_t i) {
    return *reinterpret_cast<const uint4*>(p + i);
}
__device__ __forceinline__ uint4 load8_bf16(const float*, size_t) {
    return make_uint4(0, 0, 0, 0);  // never called: f32 runs on FMA
}

// Row k of the operand [x | h_prev] of dW = [x | h_prev]^T dgates: x from
// a (T*B, D) array, h_prev = h0 (rounded) for the first B rows, else the
// stored outs of the previous step, which is outs row k - B.
template <typename E>
struct XHRows {
    const E* x;
    const float* h0;
    const E* outs;
    int B, D, H;
    __device__ __forceinline__ float operator()(size_t k, int m) const {
        if (m < D) return ld(x, k * D + m);
        m -= D;
        if (k < (size_t)B) return to_cdt<E>(h0[k * H + m]);
        return ld(outs, (k - B) * H + m);
    }
    // elements m .. m+7 of row k, as bf16 (m a multiple of 8; D and H
    // are multiples of 8, so the eight never straddle x and h_prev)
    __device__ __forceinline__ uint4 load8(size_t k, int m) const {
        if (m < D) return load8_bf16(x, k * D + m);
        m -= D;
        if (k >= (size_t)B) return load8_bf16(outs, (k - B) * H + m);
        const float* p = h0 + k * H + m;
        return pack8(p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7]);
    }
};

// Row k of a (K, width) array stored in S, as values of the compute
// dtype E (the dgates slab that XP keeps in x_proj's dtype is rounded
// here, as it is loaded)
template <typename E, typename S = E>
struct Rows {
    const S* p;
    int width;
    __device__ __forceinline__ float operator()(size_t k, int m) const {
        return to_cdt<E>(ld(p, k * width + m));
    }
    __device__ __forceinline__ uint4 load8(size_t k, int m) const {
        const size_t i = k * width + m;
        if constexpr (std::is_same<S, bf16>::value) {
            if (m + 8 <= width && i % 8 == 0) return load8_bf16(p, i);
        }
        float v[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) v[q] = m + q < width ? ld(p, i + q) : 0.f;
        return pack8(v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7]);
    }
};

constexpr int GT = 64;  // output tile of gemm_tn_splitk
constexpr int GK = 16;  // its depth per stage

// part[s][m][n] = sum_{k in split s} a(k, m) * bm(k, n); splits on
// blockIdx.z, (M, N) tiles of 64 x 64 on blockIdx.x/y, 4 x 4 per thread
template <class SA, class SB>
__global__ void __launch_bounds__(256) gemm_tn_splitk(SA a, SB bm, float* __restrict__ part,
                                                      int M, int N, long long K,
                                                      long long per_split) {
    __shared__ __align__(16) float as[GK][GT];
    __shared__ __align__(16) float bs[GK][GT];
    const int m0 = blockIdx.x * GT, n0 = blockIdx.y * GT;
    const long long kb = (long long)blockIdx.z * per_split;
    const long long ke = kb + per_split < K ? kb + per_split : K;
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    float acc[4][4] = {};
    for (long long k0 = kb; k0 < ke; k0 += GK) {
#pragma unroll
        for (int q = 0; q < GK * GT / 256; ++q) {
            const int idx = threadIdx.x + q * 256, kk = idx / GT, mm = idx % GT;
            const long long k = k0 + kk;
            as[kk][mm] = (k < ke && m0 + mm < M) ? a((size_t)k, m0 + mm) : 0.f;
            bs[kk][mm] = (k < ke && n0 + mm < N) ? bm((size_t)k, n0 + mm) : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < GK; ++kk) {
            const float4 av = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
            const float4 bv = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
            const float ar[4] = {av.x, av.y, av.z, av.w};
            const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int jj = 0; jj < 4; ++jj) acc[i][jj] = fmaf(ar[i], br[jj], acc[i][jj]);
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
            const int m = m0 + ty * 4 + i, n = n0 + tx * 4 + jj;
            if (m < M && n < N) part[((size_t)blockIdx.z * M + m) * N + n] = acc[i][jj];
        }
}

// The same contraction on bf16 tensor cores, for bf16 operands (exact in
// bf16: the compute dtype's values): mma.sync m16n8k16 with f32
// accumulation. Tiles of TM x TN outputs, TK rows of K per stage, staged
// in shared memory as bf16 with rows padded to TP elements (144 bytes:
// the eight row addresses of an ldmatrix hit eight different 16-byte
// bank groups). Four warps, each a 32 x 32 quarter of the tile: per
// 16-row step two A fragments (16 x 16, ldmatrix.x4.trans of the [k][m]
// tile) and four B fragments (16 x 8, two ldmatrix.x4.trans of [k][n]).
constexpr int TM = 64, TN = 64, TK = 32, TP = 72;

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
    const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <class SA, class SB>
__global__ void __launch_bounds__(128) gemm_tn_splitk_mma(SA a, SB bm, float* __restrict__ part,
                                                          int M, int N, long long K,
                                                          long long per_split) {
    __shared__ __align__(16) bf16 as[TK][TP];
    __shared__ __align__(16) bf16 bs[TK][TP];
    const int m0 = blockIdx.x * TM, n0 = blockIdx.y * TN;
    const long long kb = (long long)blockIdx.z * per_split;
    const long long ke = kb + per_split < K ? kb + per_split : K;
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
    float acc[2][4][4] = {};
    // a thread stages VL runs of eight elements of each operand per stage,
    // fetched one stage ahead
    constexpr int VL = TK * TM / 8 / 128;
    uint4 ra[VL], rb[VL];
    const uint4 zero = make_uint4(0, 0, 0, 0);
    auto fetch = [&](long long k0) {
#pragma unroll
        for (int q = 0; q < VL; ++q) {
            const int idx = threadIdx.x + q * 128, kk = idx / (TM / 8), m8 = idx % (TM / 8) * 8;
            const long long k = k0 + kk;
            ra[q] = k < ke && m0 + m8 < M ? a.load8((size_t)k, m0 + m8) : zero;
            rb[q] = k < ke && n0 + m8 < N ? bm.load8((size_t)k, n0 + m8) : zero;
        }
    };
    fetch(kb);
    for (long long k0 = kb; k0 < ke; k0 += TK) {
#pragma unroll
        for (int q = 0; q < VL; ++q) {
            const int idx = threadIdx.x + q * 128, kk = idx / (TM / 8), m8 = idx % (TM / 8) * 8;
            *reinterpret_cast<uint4*>(&as[kk][m8]) = ra[q];
            *reinterpret_cast<uint4*>(&bs[kk][m8]) = rb[q];
        }
        __syncthreads();
        if (k0 + TK < ke) fetch(k0 + TK);
#pragma unroll
        for (int ks = 0; ks < TK; ks += 16) {
            uint32_t af[2][4], bfr[2][4];
#pragma unroll
            for (int i = 0; i < 2; ++i)
                ldsm_x4_trans(af[i], &as[ks + lane % 8 + (lane / 16) * 8]
                                        [wm + i * 16 + (lane / 8) % 2 * 8]);
#pragma unroll
            for (int jb = 0; jb < 2; ++jb)
                ldsm_x4_trans(bfr[jb], &bs[ks + lane % 8 + (lane / 8) % 2 * 8]
                                          [wn + jb * 16 + (lane / 16) * 8]);
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    mma_bf16(acc[i][j], af[i], bfr[j / 2][(j % 2) * 2],
                             bfr[j / 2][(j % 2) * 2 + 1]);
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int m = m0 + wm + i * 16 + lane / 4 + (c / 2) * 8;
                const int n = n0 + wn + j * 8 + (lane % 4) * 2 + c % 2;
                if (m < M && n < N) part[((size_t)blockIdx.z * M + m) * N + n] = acc[i][j][c];
            }
}

// out[i] = sum_{s < S} part[s][i], added in order s = 0 .. S-1
__global__ void reduce_partials(const float* __restrict__ part, float* __restrict__ out,
                                int S, long long n) {
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += (long long)gridDim.x * blockDim.x) {
        float s = 0.f;
        for (int p = 0; p < S; ++p) s += part[(size_t)p * n + i];
        out[i] = s;
    }
}

inline size_t forward_smem(int H, int F, bool enc) {
    return sizeof(float) * ((size_t)2 * H * BT + (size_t)KC * 4 * H +
                            (enc ? (size_t)F * H + (size_t)F * BT : 0));
}

// the (KC, 2H + 1) column chunk fits in the (KC, 4H) row chunk's place
inline size_t backward_smem(int H, int F, bool enc) {
    return sizeof(float) * ((size_t)4 * H * BT + (size_t)KC * 4 * H +
                            (enc ? (size_t)F * H + (size_t)F * BT : 0));
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
    if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
}

// Steps t_lo .. t_hi-1 of the forward: h0, c0 the state before step t_lo,
// hT, cT the state after step t_hi-1
template <int H, typename E, typename S, int MODE>
cudaError_t run_forward_steps(const void* xin, const float* h0, const float* c0,
                              const float* w_enc, const float* b_enc, const float* w_ih,
                              const float* w_hh, const float* b, void* outs, void* cseq,
                              float* hT, float* cT, int t_lo, int t_hi, int B, int F,
                              cudaStream_t stream) {
    auto kernel = cell_forward<H, E, S, MODE>;
    const size_t smem = forward_smem(H, F, has_encoder(MODE));
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<(B + BT - 1) / BT, NT, smem, stream>>>(
        static_cast<const S*>(xin), h0, c0, w_enc, b_enc, w_ih, w_hh, b,
        static_cast<E*>(outs), static_cast<E*>(cseq), hT, cT, t_lo, t_hi, B, F);
    return cudaGetLastError();
}

template <int H, typename E, typename S, int MODE>
cudaError_t run_forward(const void* xin, const float* h0, const float* c0,
                        const float* w_enc, const float* b_enc, const float* w_ih,
                        const float* w_hh, const float* b, void* outs, void* cseq,
                        float* hT, float* cT, int T, int B, int F, cudaStream_t stream) {
    return run_forward_steps<H, E, S, MODE>(xin, h0, c0, w_enc, b_enc, w_ih, w_hh, b, outs,
                                            cseq, hT, cT, 0, T, B, F, stream);
}

inline cudaError_t reduce(const float* part, float* out, int S, long long n,
                          cudaStream_t stream) {
    long long blocks = (n + 255) / 256;
    if (blocks > 1024) blocks = 1024;
    reduce_partials<<<(int)blocks, 256, 0, stream>>>(part, out, S, n);
    return cudaGetLastError();
}

// bf16 operands on the tensor cores, f32 ones on FMA; both on 64 x 64
// output tiles
template <typename E, class SA, class SB>
cudaError_t splitk(SA a, SB bm, float* part, float* out, int M, int N, long long K,
                   int splits, cudaStream_t stream) {
    static_assert(GT == TM && GT == TN, "one tile grid for both");
    const long long per_split = (K + splits - 1) / splits;
    dim3 grid((M + GT - 1) / GT, (N + GT - 1) / GT, splits);
    if constexpr (std::is_same<E, bf16>::value)
        gemm_tn_splitk_mma<SA, SB><<<grid, 128, 0, stream>>>(a, bm, part, M, N, K, per_split);
    else
        gemm_tn_splitk<SA, SB><<<grid, 256, 0, stream>>>(a, bm, part, M, N, K, per_split);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return reduce(part, out, splits, (long long)M * N, stream);
}

// The weight and bias gradients behind the encoder, after a recurrent
// kernel has left the x slab xs, the rounded dgates dg and dpre in device
// memory and its blocks' bias sums in db_part and dbe_part (nblk rows):
// dw = [xs | h_prev]^T dg (D + H, 4H), dw_enc = feats^T dpre, both split-K,
// and db, db_enc as the ordered sums of the partials.
template <int H, typename E>
cudaError_t encoder_weight_grads(const void* feats, const float* h0, const void* outs,
                                 const void* xs, const void* dpre, const void* dg,
                                 float* dw_enc, float* db_enc, float* dw, float* db,
                                 float* dw_part, float* db_part, float* dwe_part,
                                 float* dbe_part, int T, int B, int F, int splits_w,
                                 int splits_e, int nblk, cudaStream_t stream) {
    constexpr int D = H, G = 4 * H;
    const long long K = (long long)T * B;
    XHRows<E> xh{static_cast<const E*>(xs), h0, static_cast<const E*>(outs), B, D, H};
    Rows<E> dgates{static_cast<const E*>(dg), G};
    cudaError_t err = splitk<E>(xh, dgates, dw_part, dw, D + H, G, K, splits_w, stream);
    if (err != cudaSuccess) return err;
    if ((err = reduce(db_part, db, nblk, G, stream)) != cudaSuccess) return err;
    Rows<E> f{static_cast<const E*>(feats), F};
    Rows<E> dp{static_cast<const E*>(dpre), D};
    if ((err = splitk<E>(f, dp, dwe_part, dw_enc, F, D, K, splits_e, stream)) != cudaSuccess)
        return err;
    return reduce(dbe_part, db_enc, nblk, D, stream);
}

// Steps t_hi-1 .. t_lo of the backward (cell_backward) and, once step 0 is
// done, the split-K weight gradients and the ordered sums of every
// partial. dw is [dW_ih; dW_hh] (D + H, 4H); XP: dW_hh (H, 4H) alone, and
// no db. T is the length of the whole sequence.
template <int H, typename E, typename S, int MODE>
cudaError_t run_backward_steps(const void* xin, const float* h0, const float* c0,
                               const float* w_enc, const float* b_enc, const float* w_ih,
                               const float* w_hh, const float* b, const void* outs,
                               const void* cseq, const void* g_outs, const float* g_hT,
                               const float* g_cT, float* dh0, float* dc0, float* dw_enc,
                               float* db_enc, float* dw, float* db, void* xo, void* dpre,
                               void* dg, float* dw_part, float* db_part, float* dwe_part,
                               float* dbe_part, int t_lo, int t_hi, int T, int B, int F,
                               int splits_w, int splits_e, int part_rows,
                               cudaStream_t stream) {
    constexpr int D = H, G = 4 * H;
    constexpr bool ENCODER = has_encoder(MODE);
    const int nblk = (B + BT - 1) / BT;
    if (part_rows != nblk || splits_w < 1 || (ENCODER && splits_e < 1))
        return cudaErrorInvalidValue;
    if (t_lo < 0 || t_lo >= t_hi || t_hi > T) return cudaErrorInvalidValue;
    // an f32 contraction cannot read its dgates from a bf16 dx_proj
    if (MODE == XP && !std::is_same<S, E>::value && std::is_same<S, bf16>::value && !dg)
        return cudaErrorInvalidValue;
    auto kernel = cell_backward<H, E, S, MODE>;
    const size_t smem = backward_smem(H, F, ENCODER);
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<nblk, NT, smem, stream>>>(
        static_cast<const S*>(xin), h0, c0, w_enc, b_enc, w_ih, w_hh, b,
        static_cast<const E*>(outs), static_cast<const E*>(cseq),
        static_cast<const E*>(g_outs), g_hT, g_cT, dh0, dc0, static_cast<S*>(xo),
        static_cast<E*>(dpre), static_cast<E*>(dg), db_part, dbe_part, t_lo, t_hi, B, F);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if (t_lo > 0) return cudaSuccess;

    const long long K = (long long)T * B;
    if constexpr (MODE == XP) {
        XHRows<E> h_prev{nullptr, h0, static_cast<const E*>(outs), B, 0, H};
        if (dg) {
            Rows<E> dgates{static_cast<const E*>(dg), G};
            return splitk<E>(h_prev, dgates, dw_part, dw, H, G, K, splits_w, stream);
        }
        Rows<E, S> dgates{static_cast<const S*>(xo), G};
        return splitk<E>(h_prev, dgates, dw_part, dw, H, G, K, splits_w, stream);
    } else if constexpr (ENCODER) {
        return encoder_weight_grads<H, E>(xin, h0, outs, xo, dpre, dg, dw_enc, db_enc, dw,
                                          db, dw_part, db_part, dwe_part, dbe_part, T, B, F,
                                          splits_w, splits_e, nblk, stream);
    } else {
        XHRows<E> xh{static_cast<const E*>(xin), h0, static_cast<const E*>(outs), B, D, H};
        Rows<E> dgates{static_cast<const E*>(dg), G};
        if ((err = splitk<E>(xh, dgates, dw_part, dw, D + H, G, K, splits_w, stream)) !=
            cudaSuccess)
            return err;
        return reduce(db_part, db, nblk, G, stream);
    }
}

// The whole backward in one launch of the recurrent kernel
template <int H, typename E, typename S, int MODE>
cudaError_t run_backward(const void* xin, const float* h0, const float* c0,
                         const float* w_enc, const float* b_enc, const float* w_ih,
                         const float* w_hh, const float* b, const void* outs,
                         const void* cseq, const void* g_outs, const float* g_hT,
                         const float* g_cT, float* dh0, float* dc0, float* dw_enc,
                         float* db_enc, float* dw, float* db, void* xo, void* dpre,
                         void* dg, float* dw_part, float* db_part, float* dwe_part,
                         float* dbe_part, int T, int B, int F, int splits_w,
                         int splits_e, int part_rows, cudaStream_t stream) {
    return run_backward_steps<H, E, S, MODE>(
        xin, h0, c0, w_enc, b_enc, w_ih, w_hh, b, outs, cseq, g_outs, g_hT, g_cT, dh0, dc0,
        dw_enc, db_enc, dw, db, xo, dpre, dg, dw_part, db_part, dwe_part, dbe_part, 0, T, T,
        B, F, splits_w, splits_e, part_rows, stream);
}

// dispatch on the hidden size and the compute dtype
template <template <int, typename> class Fn, typename... Args>
int dispatch(int H, int bf16_cdt, Args... args) {
    if (bf16_cdt) {
        switch (H) {
            case 32: return (int)Fn<32, bf16>::run(args...);
            case 64: return (int)Fn<64, bf16>::run(args...);
            case 128: return (int)Fn<128, bf16>::run(args...);
        }
    } else {
        switch (H) {
            case 32: return (int)Fn<32, float>::run(args...);
            case 64: return (int)Fn<64, float>::run(args...);
            case 128: return (int)Fn<128, float>::run(args...);
        }
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace lstm
