// The four LSTM cells with a resident W_hh, in bf16 on the tensor cores,
// for Hopper (sm_90a): what csrc/lstm_scan.cu's lstm_fused_forward /
// lstm_fused_backward (mode FUSED) and lstm_scan_forward /
// lstm_scan_backward (mode XP), csrc/lstm_cat.cu's lstm_cat_forward /
// lstm_cat_backward (mode CAT) and csrc/lstm_enc.cu's lstm_enc_forward /
// lstm_enc_backward (mode ENC5) and lstm_enc_step_backward (mode ENC, the
// backward of lstm_scan_enc: ENC5's with f32 activations and db from the
// unrounded dgates) run when the compute dtype is bf16, and
// csrc/lstm_archive.cu's four encoder-fused backwards (the archived modes
// ENC2, ENC3, ENC4 and ENC6: ENC5's backward with other roundings, ENC6
// with ENC5's own) and the archived enc2's forward (enc2_forward: the
// encoder, a projection GEMM, mode XP's loop). In f32, the default
// compute dtype, every kernel pair (the enc5, cat, fused and lstm_scan
// pairs, the archived ones) runs csrc/lstm_f32.cuh (FMA SGEMMs around
// loops on thread block clusters): the tensor cores have no exact f32
// product.
//
// Mode XP (lstm.py's lstm_scan: `_lstm_fwd_impl` / `_fwd_kernel` and
// `_noresid`, `_lstm_scan_bwd` / `_bwd_kernel`) is FUSED without the input
// product: gates = x_proj_t + h @ W_hh, the projection an operand (T, B,
// 4H) in bf16 or f32. Its forward has no pre-pass: the loop reads x_proj
// itself in its natural order, a thread's pair of units of one row and
// gate (4 bytes in bf16, 8 in f32) a unit group ahead, as FUSED's reads
// its slab (the other design, a reorder pass into FUSED's slab, is
// tools/ablate_lstm_tc_torch.py's variant xp-reorder-slab, and measured
// slower: PERF.md). Its backward has no pre-pass either: the reverse loop
// (xp_backward_loop) recomputes each step's gates, x_proj_t + h_prev @
// W_hh, from x_proj and a tile of the stored outs in shared memory, by
// the forward's own product, then runs the dh/dc chain and dh_prev as
// backward_loop does, with no db and no dx GEMM: dx_proj is the dgates in
// x_proj's dtype, the rounded slab itself for bf16 x_proj; and dW_hh =
// h_prev^T dg by the split-K. Bound at T = 16, B = 8192, H = 128, bf16
// x_proj: bytes, 0.065 ms forward (134 MB of x_proj read, 67 MB of outs
// and cseq written) and 0.12 ms backward (about 400 MB).
//
// Replaces the TPU kernels of pufferlib_tpu/ops/pallas/lstm.py (FUSED,
// XP), lstm_cat.py (CAT) and lstm_enc5.py (ENC5), phase by phase:
// * forward (FUSED: `_lstm_fused_impl`, `_fwd_fused_kernel`, `_noresid`;
//   CAT: `_impl`, `_fwd_kernel`; ENC5: lstm_enc.py `_impl`, `_fwd_kernel`):
//   0. ENC5 only: the encoder xs = bf16(relu(feats @ W_enc + b_enc)) over
//      all T*B rows (`_encode_block`), as a GEMM into a (T, B, D) bf16
//      buffer; then CAT's forward on xs;
//   1. pre-pass over all T*B rows into an f32 (T, B, 4H) slab: FUSED
//      XW = x @ W_ih + b (the kernel body's first product, lstm.py:321),
//      CAT S = x @ W_ih with no bias;
//   2. recurrent loop: FUSED gates = XW_t + h @ W_hh, two sums added; CAT
//      the accumulators start from S_t, h @ W_hh accumulates onto them,
//      then + b: [x_t | h] @ [W_ih; W_hh] + b, one sum over K = D + H
//      (lstm_cat.py:48-51); the cell update, outs and (unless cseq is
//      null) cseq.
// * backward (FUSED: `_lstm_fused_bwd`, `_bwd_fused_kernel`; CAT: `_bwd`,
//   `_bwd_kernel`; ENC5: lstm_enc5.py `_hoisted_bwd`, `_bwd_kernel`; ENC:
//   lstm_enc.py `_bwd`, `_bwd_kernel`, whose gates are recomputed and
//   whose dW is carried inside its loop, here the P pre-pass and the
//   split-K as ENC5's):
//   0. ENC5 only: xs recomputed by the forward's encoder, bit for bit;
//   1. pre-pass P over all T*B rows (h_prev: h0 rounded, then the stored
//      outs): the gate recompute, which needs no carried state, as an f32
//      slab; FUSED (x @ W_ih + b) + h_prev @ W_hh, CAT, ENC, ENC5, ENC3,
//      ENC4 and ENC6 (x @ W_ih + h_prev @ W_hh) + b, ENC2 bf16(x @ W_ih + b) +
//      h_prev @ W_hh (its projection slab, lstm_enc2.py:103-105, rounded
//      in the epilogue);
//   2. reverse loop: the activations from P_t (ENC5 rounds them to bf16,
//      the TPU kernel's activation slab, lstm_enc5.py:74-76), the dh/dc
//      chain, dgates rounded to bf16 into the dg slab, db, dh_prev =
//      dg_t @ W_hh^T (cat's dxh[:, D:], lstm_cat.py:107-110);
//   3. dx = dg @ W_ih^T (lstm.py:375) over all rows; ENC5 stores in its
//      place dpre = bf16(xs > 0 ? dx : 0), the relu mask (lstm_enc5.py:
//      123-125);
//   4. dW = [x | h_prev]^T dg and db: lstm_common.cuh's split-K
//      contraction (the ring: 128 x 128 tiles, a 4-stage cp.async ring;
//      h_prev's first rows from the rounded h0 the backward keeps) and
//      ordered sums of partials, shared with the other LSTM kernels;
//      ENC5 also dW_enc = feats^T dpre and db_enc, one split-K
//      contraction over [feats | 1] (98-byte rows at F = 49: the
//      register-staged kernel).
// The functions are the TPU kernels': f32 sums on bf16 operands, in each
// mode's order; FUSED, CAT and ENC keep f32 activations and sum db from
// the unrounded dgates, ENC5 and ENC6 round the activations and sum db (and
// db_enc) from the rounded values, ENC4 and ENC2 keep f32 activations and
// sum db from the rounded dgates, ENC3 rounds the activations and sums db
// from the unrounded dgates. The modes differ only in where the bias and
// the input product enter the sum, and in the encoder and the roundings.
// The TPU kernels of ENC4 and ENC2 recompute their gates inside the
// reverse loop from [W_ih; W_hh], 256 KiB in bf16 at D = H = 128, more
// than a block holds: here the pre-pass does, as for ENC5. ENC3's runs
// [dx | dh_prev] = dg @ [W_ih; W_hh]^T in its loop: here dx is the GEMM
// after the loop, as for ENC5. ENC6's two independent half-tile chains
// are the loop's two halves below. ENC2's other design,
// a bf16 projection slab read by mode XP's reverse loop (the recompute in
// the loop, db summed there), measured no faster on the H100 (PERF.md):
// tools/ablate_lstm_tc_torch.py keeps it as variant enc2-xp.
//
// Shapes: H in {32, 64, 128}; the input width D is a run-time argument,
// a multiple of 8 (rows of x move as 16-byte cp.async copies) whose
// weight column still fits a pre-pass block (serves, below): up to 640
// at H = 128, 704 at H = 32 and 64. Only W_hh stays in the loops, so
// nothing else depends on D. ENC5's encoder takes any feature width F
// whose W_enc column a GEMM block holds (serves_features): up to 768.
//
// Bound (T = 16, B = 8192, D = H = 128): the forward moves 35 MB of x,
// outs and cseq at the crossover with its 34 GFLOP of bf16 operations
// (about 0.035 ms); the backward's 103 GFLOP bound it (about 0.10 ms).
// ENC5 adds the encoder's 1.6 GFLOP each way (F = 49) and reads feats
// instead of x.
//
// Design. Only h @ W_hh (forward) and dg_t @ W_hh^T (backward) depend on
// the carried state; every other product moves out of the loop into a
// GEMM over all T*B rows. The loops then need W_hh alone, which is 128
// KiB in bf16 at H = 128 and fits a block:
// * staging: W_hh, rounded to bf16 by a small kernel, is copied into
//   shared memory once per block with cp.async (no register round trip),
//   rows padded by 16 bytes so that ldmatrix is free of bank conflicts.
// * tensor cores: every product is mma.sync m16n8k16 on bf16 with f32
//   accumulation. The forward reads W_hh through ldmatrix.trans as the
//   B operand of h @ W_hh; the backward reads the same copy without
//   .trans as the B operand of dg @ W_hh^T.
// * gate ownership: a block holds 64 batch rows (B = 8192 is 128 blocks,
//   one wave on 132 SMs) as two independent halves of 32 rows, 8 warps
//   each. A warp owns groups of 8 hidden units and the four gate n-tiles
//   of those units (columns g*H + u), so a thread's accumulators hold all
//   four gates of its (row, unit) pairs and the cell update needs no
//   exchange. The backward's dh_prev n-tile of a group lands on the same
//   (row, unit) pairs, so dh and dc stay in registers from step to step.
//   A half's step has one barrier of its own in the forward (h is
//   double-buffered in shared memory) and two in the backward (the shared
//   dgates tile is written, then read by every warp of the half); the
//   halves drift apart, so that one's products overlap the other's cell
//   math. This is the schedule of the archived enc6 (lstm_enc6.py: two
//   independent half-tile chains in one loop body); the block stepping as
//   one chain is tools/ablate_lstm_tc_torch.py's variant one-chain.
// * the slabs: the forward's (XW or S) and P are stored in the loops'
//   fragment order (slab_index), so that a warp reads a gate of a unit
//   group as one contiguous 512-byte run of float4s, and each group's
//   values are loaded a group ahead: in the forward during the previous
//   group's cell update and product, in the backward (the first group of
//   a step) during the product of the step before. An L2 prefetch of the
//   next step's rows measured slower on the H100.
// * cell math: the forward loop takes exp and division from the special
//   function unit (sig_tc, tanh_tc), a few f32 ulp where bf16 rounds at
//   2^-8; the backward, which read no faster with it, keeps expf and tanhf.
// * the GEMMs hold their block's column of the weights in shared memory
//   and stream the row tiles through a cp.async ring; a block walks a
//   column of tiles, so that loads overlap products and epilogues. ENC5's
//   encoder reads feats rows of any width: a row of F = 49 bf16 is 98
//   bytes, so its A tiles load element by element (FeatRows), zeros past
//   F.
// The slabs are this design's main cost: 268 MB each way in f32
// at the bench shapes, written once and read once. A later design would
// keep W_ih resident too, streaming it through a TMA ring beside W_hh, or
// split the gate columns across a 2-CTA cluster so that [W_ih; W_hh]
// fits in the pair's shared memory and x_t @ W_ih runs in the loop.
#pragma once

#include <cstring>

#include "lstm_common.cuh"

namespace lstm {
namespace tc {

constexpr int NW = 16;         // warps per block of the recurrent loops
constexpr int NTC = 32 * NW;   // their threads
constexpr int BR = 64;         // batch rows per block (TC_ROWS_PER_BLOCK in python)
constexpr int HW = NW / 2;     // warps of each half of a block (32 rows)
constexpr int PAD = 8;         // bf16 elements (16 bytes) that pad a shared row
constexpr int FORWARD_PHASES = 2;   // pre-pass, loop
constexpr int BACKWARD_PHASES = 4;  // pre-pass, loop, dx, dW + db
constexpr int XP_FORWARD_PHASES = 1;   // mode XP: the loop
constexpr int XP_BACKWARD_PHASES = 2;  // mode XP: loop, dW

// The loops' geometry for hidden size H. A block's 64 rows are two halves
// of 32 whose recurrences are independent: each half has HW warps and a
// named barrier of its own, so one half's products run while the other
// works its cell math, and twice the warps hide the latency of the
// elementwise work. Within a half, UG groups of 8 units: a warp owns UPW
// of them over MT m-tiles of 16 rows (at H = 32 two warps share a group,
// one m-tile each). Shared rows are padded: WS for W_hh and the dgates
// tile (4H wide), HS for the h tile.
template <int H>
struct Geo {
    static constexpr int G = 4 * H;
    static constexpr int UG = H / 8;
    static constexpr int WPU = UG >= HW ? 1 : HW / UG;
    static constexpr int UPW = UG >= HW ? UG / HW : 1;
    static constexpr int MT = BR / 2 / 16 / WPU;
    static constexpr int WS = G + PAD;
    static constexpr int HS = H + PAD;
    static_assert(UG * WPU == HW * UPW && MT >= 1, "H must be 32, 64 or 128");
    static constexpr size_t W_BYTES = sizeof(bf16) * H * WS;
    static constexpr size_t FWD_SMEM = W_BYTES + sizeof(bf16) * 2 * BR * HS;
    static constexpr size_t BWD_SMEM = W_BYTES + sizeof(bf16) * BR * WS;
    static constexpr size_t XP_BWD_SMEM = BWD_SMEM + sizeof(bf16) * BR * HS;
    static_assert(XP_BWD_SMEM <= (size_t)MAX_SMEM,
                  "W_hh, the dgates tile and the h_prev tile must fit");
};

// the barrier of one half's warps (ids 1 and 2; 0 is __syncthreads)
__device__ __forceinline__ void half_sync(int half) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + half), "r"(HW * 32) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
    const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
    const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(a));
}

// The slabs (the forward's XW or S, and P; f32, 4H columns n = g*H + u
// per row) are stored in the order the loops read them: each step's rows
// padded to 64 * ceil(B / 64), cut into tiles of 16 rows by 8 units, each
// tile holding its four gates one after another as 32 float4s, lane
// gid * 4 + tig holding rows gid and gid + 8 of units 2 tig and 2 tig + 1:
// the values of one mma accumulator fragment. A warp reads (and the
// pre-pass writes) 512 contiguous bytes per gate. rtiles is the number of
// 16-row tiles of a step.
__device__ __forceinline__ size_t slab_index(long long t, int r, int g, int u, int rtiles,
                                             int ugroups) {
    const long long tile = ((t * rtiles + r / 16) * ugroups + u / 8) * 4 + g;
    return (size_t)tile * 128 + ((r % 8) * 4 + (u % 8) / 2) * 4 + (r % 16) / 8 * 2 + u % 2;
}

// The gate activations of the forward loop, through the special function
// unit: __expf and a fast division, within a few f32 ulp (tanh as
// 2 sigmoid(2x) - 1, an absolute error near 1e-7). The loop rounds h and
// c to bf16 (a relative step of 2^-8), far above that. On the H100 this
// made the forward loop 6-26% faster; the backward loop read no faster
// with it, so the backward keeps expf and tanhf (sigm, dgates_chain), as
// the f32 kernels do.
__device__ __forceinline__ float sig_tc(float x) { return __fdividef(1.f, 1.f + __expf(-x)); }
__device__ __forceinline__ float tanh_tc(float x) { return 2.f * sig_tc(2.f * x) - 1.f; }

__device__ __forceinline__ float2 ld2(const bf16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 ld2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void st2(bf16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void st2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// W_hh (H, 4H) in bf16 into w_s, rows padded to WS; the caller waits
template <int H>
__device__ __forceinline__ void stage_w_hh(bf16* w_s, const bf16* __restrict__ w_hh16) {
    constexpr int G = 4 * H, C = G / 8;  // 16-byte chunks per row
    for (int i = threadIdx.x; i < H * C; i += NTC) {
        const int k = i / C, c = i - k * C;
        cp_async16(w_s + k * Geo<H>::WS + c * 8, w_hh16 + (size_t)k * G + c * 8);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// v[mt][g]: the slab's float4 of step t at the accumulator positions of
// unit group ug and gate g: rows (mt0 + mt) * 16 + gid (x, y) and + 8
// (z, w), units 8 ug + 2 tig (x, z) and + 1 (y, w). Predicated loads with
// no instruction that waits on them: they stay in flight until the values
// are read. A float4 whose first row is past the batch edge stays zero;
// one that straddles it holds the slab's padding in z and w, which the
// reader masks. The grid has a block per 64 rows, so a step has 4
// gridDim.x tiles of 16 rows.
template <int H, int MT>
__device__ __forceinline__ void load_gates(float4 (&v)[MT][4], const float* __restrict__ slab,
                                           int t, int ug, int mt0, int nrows, int lane) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
        const int r = (mt0 + mt) * 16 + lane / 4;
        const long long tile =
            (((long long)t * gridDim.x + blockIdx.x) * 4 + mt0 + mt) * (H / 8) + ug;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
            v[mt][g] = make_float4(0.f, 0.f, 0.f, 0.f);
            if (r < nrows)
                v[mt][g] = __ldg(
                    reinterpret_cast<const float4*>(slab + (tile * 4 + g) * 128 + lane * 4));
        }
    }
}

// element e of an accumulator fragment held as a float4
__device__ __forceinline__ float frag(const float4& v, int e) {
    return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

__device__ __forceinline__ uint32_t ldg_u32(const bf16* p) {
    return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ float2 bf16x2(uint32_t v) {
    __nv_bfloat162 b;
    memcpy(&b, &v, sizeof b);
    return __bfloat1622float2(b);
}

// Mode XP's loop reads x_proj, in its natural (T, B, 4H) order and its
// own dtype S, itself: no pre-pass reorders it. A thread's share of an
// accumulator fragment is, per m-tile, gate and row half, the pair of
// units 2 tig, 2 tig + 1 of one row: 4 bytes in bf16, 8 in f32, held raw
// until the value is read, so that the load stays in flight.
template <typename S>
struct XpPair;
template <>
struct XpPair<bf16> {
    using Raw = uint32_t;
    __device__ __forceinline__ static Raw load(const bf16* p) { return ldg_u32(p); }
    __device__ __forceinline__ static float2 get(Raw v) { return bf16x2(v); }
};
template <>
struct XpPair<float> {
    using Raw = float2;
    __device__ __forceinline__ static Raw load(const float* p) {
        return __ldg(reinterpret_cast<const float2*>(p));
    }
    __device__ __forceinline__ static float2 get(Raw v) { return v; }
};

// v[mt][g][half]: x_proj of step t at the accumulator positions of unit
// group ug and gate g: rows (mt0 + mt) * 16 + gid (+ 8 for half 1), units
// 8 ug + 2 tig and + 1; zero past the batch edge
template <int H, int MT, typename S>
__device__ __forceinline__ void load_xp(typename XpPair<S>::Raw (&v)[MT][4][2],
                                        const S* __restrict__ xp, int t, int ug, int mt0, int B,
                                        int row0, int nrows, int lane) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int r = (mt0 + mt) * 16 + lane / 4 + 8 * half;
            const S* p = xp + ((size_t)t * B + row0 + r) * (4 * H) + ug * 8 + lane % 4 * 2;
#pragma unroll
            for (int g = 0; g < 4; ++g) {
                v[mt][g][half] = typename XpPair<S>::Raw{};
                if (r < nrows) v[mt][g][half] = XpPair<S>::load(p + g * H);
            }
        }
}

// The inputs of one item of the reverse step, unit group ug by block
// m-tile mt: P (as load_gates) and the raw bf16 pairs of g_outs, cseq and
// the cseq of the step before (t > 0) at rows mt * 16 + gid (half 0) and
// + 8 (half 1), units 8 ug + 2 tig and + 1; zero past the batch edge.
// Predicated loads that stay in flight until the item is worked.
struct Item {
    float4 p[4];
    uint32_t go[2], ct[2], cp[2];
};

template <int H>
__device__ __forceinline__ void load_item(Item& it, const float* __restrict__ pre,
                                          const bf16* __restrict__ g_outs,
                                          const bf16* __restrict__ cseq, int t, int ug, int mt,
                                          int B, int row0, int nrows, int lane) {
    const int r = mt * 16 + lane / 4;
    const long long tile = (((long long)t * gridDim.x + blockIdx.x) * 4 + mt) * (H / 8) + ug;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
        it.p[g] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < nrows)
            it.p[g] = __ldg(reinterpret_cast<const float4*>(pre + (tile * 4 + g) * 128 + lane * 4));
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int rr = r + 8 * half;
        const size_t i = ((size_t)t * B + row0 + rr) * H + ug * 8 + lane % 4 * 2;
        it.go[half] = it.ct[half] = it.cp[half] = 0u;
        if (rr < nrows) {
            it.go[half] = ldg_u32(g_outs + i);
            it.ct[half] = ldg_u32(cseq + i);
            if (t > 0) it.cp[half] = ldg_u32(cseq + i - (size_t)B * H);
        }
    }
}

// acc[mt][g] += h @ W_hh for the warp's m-tiles and unit group u0, gate
// g's n-tile being columns g*H + u0 .. +8. h: the (BR, HS) tile; W_hh:
// (H, WS) read as [k][n] through ldmatrix.trans, two gates per x4.
template <int H, int MT>
__device__ __forceinline__ void gates_mma(float (&acc)[MT][4][4], const bf16* hc,
                                          const bf16* w_s, int mt0, int u0, int lane) {
    constexpr int WS = Geo<H>::WS, HS = Geo<H>::HS;
#pragma unroll
    for (int ks = 0; ks < H; ks += 16) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
            ldsm_x4(a[mt], hc + ((mt0 + mt) * 16 + lane % 16) * HS + ks + lane / 16 * 8);
#pragma unroll
        for (int gp = 0; gp < 2; ++gp) {
            uint32_t b[4];
            ldsm_x4_trans(b, w_s + (ks + lane % 8 + lane / 8 % 2 * 8) * WS +
                                 (2 * gp + lane / 16) * H + u0);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
                mma_bf16(acc[mt][2 * gp], a[mt], b[0], b[1]);
                mma_bf16(acc[mt][2 * gp + 1], a[mt], b[2], b[3]);
            }
        }
    }
}

// acc[ug][mt] = dg_t @ W_hh^T for the warp's unit groups (one n-tile of 8
// units each) and m-tiles. dg_t: the (BR, WS) tile; W_hh: (H, WS) read as
// [n][k] through ldmatrix without .trans.
template <int H, int UPW, int MT>
__device__ __forceinline__ void dh_mma(float (&acc)[UPW][MT][4], const bf16* d_s,
                                       const bf16* w_s, int mt0, int ug0, int lane) {
    constexpr int G = 4 * H, WS = Geo<H>::WS;
#pragma unroll
    for (int ug = 0; ug < UPW; ++ug)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[ug][mt][e] = 0.f;
#pragma unroll 4
    for (int ks = 0; ks < G; ks += 16) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
            ldsm_x4(a[mt], d_s + ((mt0 + mt) * 16 + lane % 16) * WS + ks + lane / 16 * 8);
#pragma unroll
        for (int ug = 0; ug < UPW; ++ug) {
            uint32_t b[2];
            ldsm_x2(b, w_s + ((ug0 + ug) * 8 + lane % 8) * WS + ks + lane / 8 % 2 * 8);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[ug][mt], a[mt], b[0], b[1]);
        }
    }
}

// The forward loop: xw, the slab of the pre-pass (FUSED: XW, CAT: S) or
// (XP) x_proj itself, (T, B, 4H) in S; b (4H,) f32 (CAT only: FUSED's
// bias is in XW, XP has none), h0/c0 (B, H) f32, W_hh (H, 4H) bf16;
// writes outs, cseq (unless null) (T, B, H) bf16, hT, cT (B, H) f32.
// Thread (warp, lane) holds c for rows row(mt, e / 2) and units
// u0 + 2 tig + e % 2 of its unit groups.
template <int H, int MODE, typename S = float>
__global__ void __launch_bounds__(NTC, 1) forward_loop(
        const S* __restrict__ xw, const float* __restrict__ b,
        const float* __restrict__ h0, const float* __restrict__ c0,
        const bf16* __restrict__ w_hh16, bf16* __restrict__ outs, bf16* __restrict__ cseq,
        float* __restrict__ hT, float* __restrict__ cT, int T, int B) {
    using GE = Geo<H>;
    constexpr int MT = GE::MT, UPW = GE::UPW, HS = GE::HS;
    extern __shared__ __align__(16) unsigned char smem_tc[];
    bf16* w_s = reinterpret_cast<bf16*>(smem_tc);  // (H, WS) W_hh
    bf16* h_s = w_s + H * GE::WS;                  // 2 x (BR, HS) h, rounded
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int gid = lane / 4, tig = lane % 4;
    // side: the half of the block's rows the warp works on
    const int side = warp / HW, wl = warp % HW;
    const int ug0 = wl / GE::WPU * UPW, mt0 = side * (BR / 32) + wl % GE::WPU * MT;
    const int row0 = blockIdx.x * BR, nrows = min(BR, B - row0);

    stage_w_hh<H>(w_s, w_hh16);
    float c[UPW][MT][4];
#pragma unroll
    for (int ug = 0; ug < UPW; ++ug)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int r = (mt0 + mt) * 16 + gid + 8 * half;
                const int j = (ug0 + ug) * 8 + 2 * tig;
                float2 h = make_float2(0.f, 0.f), cc = h;
                if (r < nrows) {
                    h = ld2(h0 + (size_t)(row0 + r) * H + j);
                    cc = ld2(c0 + (size_t)(row0 + r) * H + j);
                }
                c[ug][mt][2 * half] = cc.x;
                c[ug][mt][2 * half + 1] = cc.y;
                st2(h_s + r * HS + j, h.x, h.y);
            }
    // the slab of the first unit group of step 0; every later group's values
    // are loaded one group ahead, during the cell update and the product
    float4 pre[MT][4];
    typename XpPair<S>::Raw xpv[MT][4][2];  // XP: x_proj's pairs
    auto load_slab = [&](int t, int ug) {
        if constexpr (MODE == XP)
            load_xp<H>(xpv, xw, t, ug, mt0, B, row0, nrows, lane);
        else
            load_gates<H>(pre, xw, t, ug, mt0, nrows, lane);
    };
    load_slab(0, ug0);
    cp_async_wait_all();
    __syncthreads();

    for (int t = 0; t < T; ++t) {
        const bf16* hc = h_s + (t % 2) * BR * HS;
        bf16* hn = h_s + (1 - t % 2) * BR * HS;
        const size_t base = (size_t)t * B + row0;
#pragma unroll
        for (int ug = 0; ug < UPW; ++ug) {
            const int u0 = (ug0 + ug) * 8;
            // the slab's value of fragment element e, zero past the batch edge
            auto slab = [&](int mt, int g, int e) {
                const bool ok = (mt0 + mt) * 16 + gid + 8 * (e / 2) < nrows;
                if constexpr (MODE == XP) {
                    const float2 v = XpPair<S>::get(xpv[mt][g][e / 2]);
                    return ok ? (e % 2 ? v.y : v.x) : 0.f;
                } else {
                    return ok ? frag(pre[mt][g], e) : 0.f;
                }
            };
            auto load_next = [&]() {
                if (ug + 1 < UPW)
                    load_slab(t, ug0 + ug + 1);
                else if (t + 1 < T)
                    load_slab(t + 1, ug0);
            };
            float acc[MT][4][4];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int g = 0; g < 4; ++g)
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        acc[mt][g][e] = MODE == CAT ? slab(mt, g, e) : 0.f;
            if constexpr (MODE == CAT) {
                // one sum: h @ W_hh accumulates onto x_t @ W_ih, then + b
                load_next();
                gates_mma<H>(acc, hc, w_s, mt0, u0, lane);
#pragma unroll
                for (int g = 0; g < 4; ++g) {
                    const float bias[2] = {__ldg(b + g * H + u0 + 2 * tig),
                                           __ldg(b + g * H + u0 + 2 * tig + 1)};
#pragma unroll
                    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                        for (int e = 0; e < 4; ++e) acc[mt][g][e] += bias[e % 2];
                }
            } else {
                // FUSED (x_t @ W_ih + b) + h @ W_hh, XP x_proj_t + h @ W_hh:
                // two f32 sums, then added
                gates_mma<H>(acc, hc, w_s, mt0, u0, lane);
#pragma unroll
                for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                    for (int g = 0; g < 4; ++g)
#pragma unroll
                        for (int e = 0; e < 4; ++e) acc[mt][g][e] = slab(mt, g, e) + acc[mt][g][e];
                load_next();
            }
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int r = (mt0 + mt) * 16 + gid + 8 * half;
                    const int j = u0 + 2 * tig;
                    float h[2];
#pragma unroll
                    for (int q = 0; q < 2; ++q) {
                        const int e = 2 * half + q;
                        const float ig = sig_tc(acc[mt][0][e]);
                        const float fg = sig_tc(acc[mt][1][e]);
                        const float gg = tanh_tc(acc[mt][2][e]);
                        const float og = sig_tc(acc[mt][3][e]);
                        float& cc = c[ug][mt][e];
                        cc = fg * cc + ig * gg;
                        h[q] = og * tanh_tc(cc);
                    }
                    st2(hn + r * HS + j, h[0], h[1]);
                    if (r < nrows) {
                        const size_t i = (base + r) * H + j;
                        st2(outs + i, h[0], h[1]);
                        if (cseq) st2(cseq + i, c[ug][mt][2 * half], c[ug][mt][2 * half + 1]);
                        if (t == T - 1) st2(hT + (size_t)(row0 + r) * H + j, h[0], h[1]);
                    }
                }
        }
        half_sync(side);
    }
#pragma unroll
    for (int ug = 0; ug < UPW; ++ug)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int r = (mt0 + mt) * 16 + gid + 8 * half;
                if (r < nrows)
                    st2(cT + (size_t)(row0 + r) * H + (ug0 + ug) * 8 + 2 * tig,
                        c[ug][mt][2 * half], c[ug][mt][2 * half + 1]);
            }
}

// The reverse loop: pre, the P slab of the pre-pass, c0 (B, H)
// f32, W_hh bf16, cseq and g_outs (T, B, H) bf16, g_hT, g_cT (B, H) f32.
// Writes dh0, dc0 (B, H) f32, the rounded dgates dg (T, B, 4H) bf16 and
// the block's db sums into row blockIdx.x of db_part (4H wide). dh and dc
// live at the forward's (row, unit) positions. Two roundings, each a flag
// (lstm_common.cuh rounded_acts, rounded_db): ROUND_ACTS, the activations
// pass through bf16 before the dgates chain, as lstm_enc5._bwd_kernel's
// shared activation/dgates slab does; ROUND_DB, db sums the dgates as
// stored in bf16 rather than the unrounded ones. ENC5 and the archived
// ENC6 take both, the archived ENC4 and ENC2 ROUND_DB alone, the archived
// ENC3 ROUND_ACTS alone, CAT, FUSED and ENC neither.
template <int H, bool ROUND_ACTS, bool ROUND_DB>
__global__ void __launch_bounds__(NTC, 1) backward_loop(
        const float* __restrict__ pre, const float* __restrict__ c0,
        const bf16* __restrict__ w_hh16, const bf16* __restrict__ cseq,
        const bf16* __restrict__ g_outs, const float* __restrict__ g_hT,
        const float* __restrict__ g_cT, float* __restrict__ dh0, float* __restrict__ dc0,
        bf16* __restrict__ dg, float* __restrict__ db_part, int T, int B) {
    using GE = Geo<H>;
    constexpr int G = GE::G, MT = GE::MT, UPW = GE::UPW, WS = GE::WS;
    extern __shared__ __align__(16) unsigned char smem_tc[];
    bf16* w_s = reinterpret_cast<bf16*>(smem_tc);  // (H, WS) W_hh
    bf16* d_s = w_s + H * WS;                      // (BR, WS) dgates of the step, rounded
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int gid = lane / 4, tig = lane % 4;
    // side: the half of the block's rows the warp works on
    const int side = warp / HW, wl = warp % HW;
    const int ug0 = wl / GE::WPU * UPW, mt0 = side * (BR / 32) + wl % GE::WPU * MT;
    const int row0 = blockIdx.x * BR, nrows = min(BR, B - row0);

    stage_w_hh<H>(w_s, w_hh16);
    float dh[UPW][MT][4], dc[UPW][MT][4], db[UPW][4][2];
#pragma unroll
    for (int ug = 0; ug < UPW; ++ug) {
#pragma unroll
        for (int g = 0; g < 4; ++g) db[ug][g][0] = db[ug][g][1] = 0.f;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int r = (mt0 + mt) * 16 + gid + 8 * half;
                const size_t i = (size_t)(row0 + r) * H + (ug0 + ug) * 8 + 2 * tig;
                float2 h = make_float2(0.f, 0.f), cc = h;
                if (r < nrows) {
                    h = ld2(g_hT + i);
                    cc = ld2(g_cT + i);
                }
                dh[ug][mt][2 * half] = h.x;
                dh[ug][mt][2 * half + 1] = h.y;
                dc[ug][mt][2 * half] = cc.x;
                dc[ug][mt][2 * half + 1] = cc.y;
            }
    }
    // A step works NI items (unit group by m-tile); each item's inputs load
    // while the one before it is worked, and the first item of a step
    // while the step after it runs its product. Item k sits in it[k % 2];
    // with NI odd (H = 32) the prefetched first item moves to it[0] after
    // the product.
    constexpr int NI = UPW * MT;
    Item it[2];
    load_item<H>(it[0], pre, g_outs, cseq, T - 1, ug0, mt0, B, row0, nrows, lane);
    cp_async_wait_all();
    __syncthreads();

    for (int t = T - 1; t >= 0; --t) {
        const size_t base = (size_t)t * B + row0;
#pragma unroll
        for (int k = 0; k < NI; ++k) {
            const int ug = k / MT, mt = k % MT;
            if (k + 1 < NI)
                load_item<H>(it[(k + 1) % 2], pre, g_outs, cseq, t, ug0 + (k + 1) / MT,
                             mt0 + (k + 1) % MT, B, row0, nrows, lane);
            else if (t > 0)
                load_item<H>(it[NI % 2], pre, g_outs, cseq, t - 1, ug0, mt0, B, row0, nrows,
                             lane);
            const Item& in = it[k % 2];
            const int j = (ug0 + ug) * 8 + 2 * tig;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int r = (mt0 + mt) * 16 + gid + 8 * half;
                const bool ok = r < nrows;
                const float2 gout = bf16x2(in.go[half]), ct = bf16x2(in.ct[half]);
                // c_prev: the stored cseq of t - 1, c0 at t = 0
                float2 cp = bf16x2(in.cp[half]);
                if (t == 0 && ok) cp = ld2(c0 + (size_t)(row0 + r) * H + j);
                const float gq[2] = {gout.x, gout.y}, cq[2] = {ct.x, ct.y}, pq[2] = {cp.x, cp.y};
                float d[2][4];
#pragma unroll
                for (int q = 0; q < 2; ++q) {
                    const int e = 2 * half + q;
                    float a[4];
#pragma unroll
                    for (int g = 0; g < 4; ++g) a[g] = ok ? frag(in.p[g], e) : 0.f;
                    float act[4] = {sigm(a[0]), sigm(a[1]), tanhf(a[2]), sigm(a[3])};
                    if constexpr (ROUND_ACTS) {
#pragma unroll
                        for (int g = 0; g < 4; ++g) act[g] = to_cdt<bf16>(act[g]);
                    }
                    dgates_chain(d[q], dc[ug][mt][e], dh[ug][mt][e] + gq[q], act[0], act[1],
                                 act[2], act[3], cq[q], pq[q]);
                }
#pragma unroll
                for (int g = 0; g < 4; ++g) {
                    if (ok) {
                        // db sums the dgates: as stored in bf16 (ROUND_DB), else unrounded
                        db[ug][g][0] += ROUND_DB ? to_cdt<bf16>(d[0][g]) : d[0][g];
                        db[ug][g][1] += ROUND_DB ? to_cdt<bf16>(d[1][g]) : d[1][g];
                    }
                    st2(d_s + r * WS + g * H + j, d[0][g], d[1][g]);
                    if (ok) st2(dg + (base + r) * G + g * H + j, d[0][g], d[1][g]);
                }
            }
        }
        half_sync(side);
        dh_mma<H>(dh, d_s, w_s, mt0, ug0, lane);
        half_sync(side);
        if constexpr (NI % 2 == 1) it[0] = it[1];
    }
#pragma unroll
    for (int ug = 0; ug < UPW; ++ug)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int r = (mt0 + mt) * 16 + gid + 8 * half;
                if (r >= nrows) continue;
                const size_t i = (size_t)(row0 + r) * H + (ug0 + ug) * 8 + 2 * tig;
                st2(dh0 + i, dh[ug][mt][2 * half], dh[ug][mt][2 * half + 1]);
                st2(dc0 + i, dc[ug][mt][2 * half], dc[ug][mt][2 * half + 1]);
            }
    // db: each column's sum over a warp's rows (the eight lanes that hold
    // it, a fixed butterfly), then over the 2 WPU warps of both halves that
    // hold the column, in order. Both halves must be past their last
    // product before d_s is reused.
    __syncthreads();
    float* red = reinterpret_cast<float*>(d_s);  // (2 WPU, G)
#pragma unroll
    for (int ug = 0; ug < UPW; ++ug)
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
            for (int q = 0; q < 2; ++q) {
                float v = db[ug][g][q];
                v += __shfl_xor_sync(0xffffffffu, v, 4);
                v += __shfl_xor_sync(0xffffffffu, v, 8);
                v += __shfl_xor_sync(0xffffffffu, v, 16);
                if (gid == 0)
                    red[(side * GE::WPU + wl % GE::WPU) * G + g * H + (ug0 + ug) * 8 + 2 * tig +
                        q] = v;
            }
    __syncthreads();
    for (int n = threadIdx.x; n < G; n += NTC) {
        float s = 0.f;
        for (int q = 0; q < 2 * GE::WPU; ++q) s += red[q * G + n];
        db_part[(size_t)blockIdx.x * G + n] = s;
    }
}

// Rows row0 .. row0 + nrows of h_prev of step t, (BR, HS) bf16, into the
// tile h_s: h0 rounded (h16) at t = 0, else the stored outs of step t - 1;
// zeros past the batch edge. Rows r0 .. r0 + rows, by threads
// first .. first + count; the caller commits and waits.
template <int H>
__device__ __forceinline__ void stage_h_prev(bf16* h_s, const bf16* __restrict__ h16,
                                             const bf16* __restrict__ outs, int t, int B,
                                             int row0, int nrows, int r0, int rows, int first,
                                             int count) {
    constexpr int C = H / 8;  // 16-byte chunks per row
    const bf16* src = t == 0 ? h16 + (size_t)row0 * H : outs + ((size_t)(t - 1) * B + row0) * H;
    for (int i = threadIdx.x - first; i < rows * C; i += count) {
        const int r = r0 + i / C, c = i % C * 8;
        const bool ok = r < nrows;
        cp_async16_zfill(h_s + r * Geo<H>::HS + c, ok ? src + (size_t)r * H + c : src, ok);
    }
}

// Mode XP's reverse loop, with no P slab: each step recomputes its gates,
// x_proj_t + h_prev @ W_hh, as the forward loop computes them (the same
// product on the same bf16 h_prev, which the stored outs are, and x_proj
// added after it), from x_proj in its natural order and a tile of h_prev
// in shared memory; then backward_loop's dh/dc chain and dh_prev =
// dg_t @ W_hh^T. The h_prev tile of the next step (t - 1) loads while the
// half runs its dh_prev product: a half's warps are past their gates
// product once they have written the dgates tile. Writes dh0, dc0, the
// rounded dgates dg and, unless null, the f32 dgates dgf; no db. The loop
// walks steps t1 - 1 down to t0 of the whole (T, B) arrays: g_hT, g_cT
// are the gradients that enter step t1 - 1, dh0, dc0 those that leave
// step t0 (lstm_scan: 0 and T; the archived tm one step a launch).
template <int H, typename S>
__global__ void __launch_bounds__(NTC, 1) xp_backward_loop(
        const S* __restrict__ xp, const bf16* __restrict__ h16, const float* __restrict__ c0,
        const bf16* __restrict__ w_hh16, const bf16* __restrict__ outs,
        const bf16* __restrict__ cseq, const bf16* __restrict__ g_outs,
        const float* __restrict__ g_hT, const float* __restrict__ g_cT,
        float* __restrict__ dh0, float* __restrict__ dc0, bf16* __restrict__ dg,
        float* __restrict__ dgf, int t0, int t1, int B) {
    using GE = Geo<H>;
    constexpr int G = GE::G, MT = GE::MT, UPW = GE::UPW, WS = GE::WS;
    extern __shared__ __align__(16) unsigned char smem_tc[];
    bf16* w_s = reinterpret_cast<bf16*>(smem_tc);  // (H, WS) W_hh
    bf16* d_s = w_s + H * WS;                      // (BR, WS) dgates of the step, rounded
    bf16* h_s = d_s + BR * WS;                     // (BR, HS) h_prev of the step
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int gid = lane / 4, tig = lane % 4;
    const int side = warp / HW, wl = warp % HW;
    const int ug0 = wl / GE::WPU * UPW, mt0 = side * (BR / 32) + wl % GE::WPU * MT;
    const int row0 = blockIdx.x * BR, nrows = min(BR, B - row0);

    stage_w_hh<H>(w_s, w_hh16);
    stage_h_prev<H>(h_s, h16, outs, t1 - 1, B, row0, nrows, 0, BR, 0, NTC);
    cp_async_commit();
    float dh[UPW][MT][4], dc[UPW][MT][4];
#pragma unroll
    for (int ug = 0; ug < UPW; ++ug)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int r = (mt0 + mt) * 16 + gid + 8 * half;
                const size_t i = (size_t)(row0 + r) * H + (ug0 + ug) * 8 + 2 * tig;
                float2 h = make_float2(0.f, 0.f), cc = h;
                if (r < nrows) {
                    h = ld2(g_hT + i);
                    cc = ld2(g_cT + i);
                }
                dh[ug][mt][2 * half] = h.x;
                dh[ug][mt][2 * half + 1] = h.y;
                dc[ug][mt][2 * half] = cc.x;
                dc[ug][mt][2 * half + 1] = cc.y;
            }
    cp_async_wait_all();
    __syncthreads();

    for (int t = t1 - 1; t >= t0; --t) {
        const size_t base = (size_t)t * B + row0;
#pragma unroll
        for (int ug = 0; ug < UPW; ++ug) {
            const int j = (ug0 + ug) * 8 + 2 * tig;
            // this unit group's raw bf16 pairs of g_outs, cseq and the cseq
            // before, and its x_proj, in flight during the gates product;
            // f32 x_proj (twice the registers) loads after the product: in
            // flight during it, the H = 128 loop spilled 244 bytes a thread on
            // the H100, after it 64
            constexpr bool EARLY = std::is_same<S, bf16>::value;
            typename XpPair<S>::Raw xpv[MT][4][2];
            if (EARLY) load_xp<H>(xpv, xp, t, ug0 + ug, mt0, B, row0, nrows, lane);
            uint32_t go[MT][2], ct[MT][2], cp[MT][2];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int r = (mt0 + mt) * 16 + gid + 8 * half;
                    const size_t i = (base + r) * H + j;
                    go[mt][half] = ct[mt][half] = cp[mt][half] = 0u;
                    if (r < nrows) {
                        go[mt][half] = ldg_u32(g_outs + i);
                        ct[mt][half] = ldg_u32(cseq + i);
                        if (t > 0) cp[mt][half] = ldg_u32(cseq + i - (size_t)B * H);
                    }
                }
            float acc[MT][4][4];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int g = 0; g < 4; ++g)
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[mt][g][e] = 0.f;
            gates_mma<H>(acc, h_s, w_s, mt0, (ug0 + ug) * 8, lane);
            if (!EARLY) load_xp<H>(xpv, xp, t, ug0 + ug, mt0, B, row0, nrows, lane);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int r = (mt0 + mt) * 16 + gid + 8 * half;
                    const bool ok = r < nrows;
                    const float2 gout = bf16x2(go[mt][half]), ctv = bf16x2(ct[mt][half]);
                    // c_prev: the stored cseq of t - 1, c0 at t = 0
                    float2 cpv = bf16x2(cp[mt][half]);
                    if (t == 0 && ok) cpv = ld2(c0 + (size_t)(row0 + r) * H + j);
                    const float gq[2] = {gout.x, gout.y}, cq[2] = {ctv.x, ctv.y},
                                pq[2] = {cpv.x, cpv.y};
                    float d[2][4];
#pragma unroll
                    for (int q = 0; q < 2; ++q) {
                        const int e = 2 * half + q;
                        float a[4];
#pragma unroll
                        for (int g = 0; g < 4; ++g) {
                            const float2 x = XpPair<S>::get(xpv[mt][g][half]);
                            a[g] = ok ? (q ? x.y : x.x) + acc[mt][g][e] : 0.f;
                        }
                        dgates_chain(d[q], dc[ug][mt][e], dh[ug][mt][e] + gq[q], sigm(a[0]),
                                     sigm(a[1]), tanhf(a[2]), sigm(a[3]), cq[q], pq[q]);
                    }
#pragma unroll
                    for (int g = 0; g < 4; ++g) {
                        st2(d_s + r * WS + g * H + j, d[0][g], d[1][g]);
                        if (ok) st2(dg + (base + r) * G + g * H + j, d[0][g], d[1][g]);
                        if (ok && dgf) st2(dgf + (base + r) * G + g * H + j, d[0][g], d[1][g]);
                    }
                }
        }
        // the half's dgates are in d_s, and its warps are past their gates
        // product: its rows of h_s take h_prev of step t - 1
        half_sync(side);
        if (t > t0) {
            stage_h_prev<H>(h_s, h16, outs, t - 1, B, row0, nrows, side * (BR / 2), BR / 2,
                            side * HW * 32, HW * 32);
            cp_async_commit();
        }
        dh_mma<H>(dh, d_s, w_s, mt0, ug0, lane);
        cp_async_wait_all();
        half_sync(side);
    }
#pragma unroll
    for (int ug = 0; ug < UPW; ++ug)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int r = (mt0 + mt) * 16 + gid + 8 * half;
                if (r >= nrows) continue;
                const size_t i = (size_t)(row0 + r) * H + (ug0 + ug) * 8 + 2 * tig;
                st2(dh0 + i, dh[ug][mt][2 * half], dh[ug][mt][2 * half + 1]);
                st2(dc0 + i, dc[ug][mt][2 * half], dc[ug][mt][2 * half + 1]);
            }
}

// The GEMMs over all T*B rows: out(m, n) from s1 = sum_k A1(m, k) B1(k, n)
// and, when k2 > 0, s2 = sum_k A2(m, k) B2(k, n), bf16 operands already
// in device memory (an A source's row(r) points to row r, a B source's
// at(r, n) to column n of row r).
// Tiles of QM x QN outputs on eight warps, each a 32 x 32 piece. A block
// owns a column of QN outputs and walks every gridDim.x-th m-tile of it:
// its column of B1 and B2 stays in shared memory ([k][n], read through
// ldmatrix.trans), and the A tiles stream through a ring of QSTAGES
// chunks of QK columns (cp.async, [m][k], ldmatrix), one barrier per
// chunk, so that the next chunk (of the next tile, at a tile's end) loads
// during a chunk's products and the epilogue. On the H100 a ring of 8 was
// slower (its shared memory costs the backward pre-pass a block per SM);
// rings of 2 and 4 read alike, and 2 takes less shared memory.
// Rows are padded against bank conflicts; columns past N, rows past M
// and the rest of a chunk past K (K = 32 is half a chunk) load as zeros.
// The epilogue gets each 16 x 8 accumulator fragment.
constexpr int QM = 64, QN = 128, QK = 64, QTHREADS = 256, QSTAGES = 2;
constexpr int QA = QK + PAD, QB = QN + PAD;

__host__ __device__ inline int chunks(int K) { return (K + QK - 1) / QK; }

// shared bytes of a GEMM whose sums run over k1 and k2 rows of B
inline size_t gemm_smem(int k1, int k2) {
    return sizeof(bf16) *
           ((size_t)(chunks(k1) + chunks(k2)) * QK * QB + (size_t)QSTAGES * QM * QA);
}

// rows of a (rows, ld) bf16 array; at(r, n): column n of row r
struct BRows {
    const bf16* p;
    int ld;
    __device__ __forceinline__ const bf16* row(long long r) const { return p + r * ld; }
    __device__ __forceinline__ const bf16* at(long long r, int n) const { return row(r) + n; }
};

// a weight (rows, 4H) as the B operand of the XW and P GEMMs, its gate
// columns interleaved: column block y of QN holds units 32y .. 32y + 32 of
// all four gates, so that a block's tile is four whole 16-row pieces of
// the slab (slab_index), each one contiguous run
struct GateRows {
    const bf16* p;
    int H;
    __device__ __forceinline__ const bf16* at(long long r, int n) const {
        return p + r * 4 * H + n % QN / 32 * H + n / QN * 32 + n % 32;
    }
};

// h_prev of every step: h0 (rounded) for the first B rows, then the
// stored outs of the previous step
struct HPrev {
    const bf16* h0;
    const bf16* outs;
    int B, H;
    __device__ __forceinline__ const bf16* row(long long r) const {
        return r < B ? h0 + r * H : outs + (r - B) * H;
    }
};

// rows 0 .. K of B's columns n0 .. n0 + QN into bs (whole chunks of QK
// rows, QB wide)
template <class SB>
__device__ __forceinline__ void load_b(bf16* bs, SB bm, int K, int n0, int N) {
    for (int i = threadIdx.x; i < chunks(K) * QK * (QN / 8); i += QTHREADS) {
        const int r = i / (QN / 8), c = i % (QN / 8) * 8;
        const bool ok = n0 + c < N && r < K;
        cp_async16_zfill(bs + r * QB + c, ok ? bm.at(r, n0 + c) : bm.at(0, 0), ok);
    }
}

// columns k0 .. k0 + QK (short of K) of A's rows m0 .. m0 + QM into as
// (QM, QA)
template <class SA>
__device__ __forceinline__ void load_a(bf16* as, SA a, int k0, int K, long long m0, long long M) {
    for (int i = threadIdx.x; i < QM * QK / 8; i += QTHREADS) {
        const int r = i / (QK / 8), c = i % (QK / 8) * 8;
        const bool ok = m0 + r < M && k0 + c < K;
        cp_async16_zfill(as + r * QA + c, ok ? a.row(m0 + r) + k0 + c : a.row(0), ok);
    }
}

// rows of the encoder's input feats, (rows, F) bf16, as the A operand of
// its GEMM: a row of F bf16 starts on 16 bytes only when F is a multiple
// of 8 (F = 49: 98-byte rows), so its elements move through registers,
// zeros past F. They store to shared memory at once; the ring's next
// barrier publishes them as it does the copies of the other A sources.
struct FeatRows {
    const bf16* p;
    int F;
};

__device__ __forceinline__ void load_a(bf16* as, FeatRows a, int k0, int K, long long m0,
                                       long long M) {
    const unsigned short* raw = reinterpret_cast<const unsigned short*>(a.p);
    for (int i = threadIdx.x; i < QM * QK / 8; i += QTHREADS) {
        const int r = i / (QK / 8), c = i % (QK / 8) * 8;
        const bool ok = m0 + r < M && k0 + c < K;
        const long long at = (m0 + r) * a.F + k0 + c;
        uint32_t v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const uint32_t lo = ok && k0 + c + 2 * q < K ? __ldg(raw + at + 2 * q) : 0u;
            const uint32_t hi = ok && k0 + c + 2 * q + 1 < K ? __ldg(raw + at + 2 * q + 1) : 0u;
            v[q] = lo | hi << 16;
        }
        *reinterpret_cast<uint4*>(as + r * QA + c) = make_uint4(v[0], v[1], v[2], v[3]);
    }
}

// acc += the chunk's A (QM, QA) times B rows bs .. bs + QK (QB wide)
__device__ __forceinline__ void chunk_mma(float (&acc)[2][4][4], const bf16* as, const bf16* bs,
                                          int wm, int wn, int lane) {
#pragma unroll
    for (int ks = 0; ks < QK; ks += 16) {
        uint32_t af[2][4], bfr[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
            ldsm_x4(af[i], as + (wm + i * 16 + lane % 16) * QA + ks + lane / 16 * 8);
#pragma unroll
        for (int jb = 0; jb < 2; ++jb)
            ldsm_x4_trans(bfr[jb], bs + (ks + lane % 8 + lane / 8 % 2 * 8) * QB + wn + jb * 16 +
                                       lane / 16 * 8);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
                mma_bf16(acc[i][j], af[i], bfr[j / 2][(j % 2) * 2], bfr[j / 2][(j % 2) * 2 + 1]);
    }
}

template <class SA1, class SB1, class SA2, class SB2, class Epi>
__global__ void __launch_bounds__(QTHREADS, 2) rows_gemm_kernel(SA1 a1, SB1 b1, int k1, SA2 a2,
                                                                SB2 b2, int k2, Epi epi,
                                                                long long M, int N) {
    extern __shared__ __align__(16) unsigned char smem_tc[];
    // chunks c < n1 feed s1 from A1, the rest s2 from A2; chunk c
    // multiplies B rows c*QK .. (B1's chunks, then B2's)
    const int n1 = chunks(k1), nc = n1 + chunks(k2);
    bf16* bs = reinterpret_cast<bf16*>(smem_tc);  // (nc * QK, QB)
    bf16* ring = bs + (size_t)nc * QK * QB;       // QSTAGES x (QM, QA)
    const int n0 = blockIdx.y * QN;
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int wm = warp / 4 * 32, wn = warp % 4 * 32;
    // the block's m-tiles are blockIdx.x, blockIdx.x + gridDim.x, ..; the
    // ring runs over their chunks, tile after tile. Every load commits a
    // group, empty past the end, so that cp_async_wait<QSTAGES - 2> finds
    // the chunk about to be multiplied (and B) complete.
    const long long tiles = (M + QM - 1) / QM;
    const int ntile =
        blockIdx.x < tiles ? (int)((tiles - 1 - blockIdx.x) / gridDim.x + 1) : 0;
    int lt = 0, lc = 0, ls = 0;  // the next load: tile, chunk, stage
    auto load_next = [&]() {
        if (lt < ntile) {
            const long long m0 = (blockIdx.x + (long long)lt * gridDim.x) * QM;
            bf16* as = ring + ls * (QM * QA);
            if (lc < n1)
                load_a(as, a1, lc * QK, k1, m0, M);
            else
                load_a(as, a2, (lc - n1) * QK, k2, m0, M);
            if (++lc == nc) {
                lc = 0;
                ++lt;
            }
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
        if (++ls == QSTAGES) ls = 0;
    };
    load_b(bs, b1, k1, n0, N);
    load_b(bs + (size_t)n1 * QK * QB, b2, k2, n0, N);
    for (int s = 0; s < QSTAGES - 1; ++s) load_next();
    int cs = 0;  // the stage about to be multiplied
    for (int tile = 0; tile < ntile; ++tile) {
        float acc1[2][4][4] = {}, acc2[2][4][4] = {};
        for (int c = 0; c < nc; ++c) {
            cp_async_wait<QSTAGES - 2>();
            // every thread is past the chunk before: its stage may be loaded again
            __syncthreads();
            load_next();
            const bf16* as = ring + cs * (QM * QA);
            if (++cs == QSTAGES) cs = 0;
            if (c < n1)
                chunk_mma(acc1, as, bs + (size_t)c * QK * QB, wm, wn, lane);
            else
                chunk_mma(acc2, as, bs + (size_t)c * QK * QB, wm, wn, lane);
        }
        const long long m0 = (blockIdx.x + (long long)tile * gridDim.x) * QM;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int nb = n0 + wn + j * 8;
                if (nb < N) epi(m0 + wm + i * 16, nb, lane, M, acc1[i][j], acc2[i][j]);
            }
    }
    cp_async_wait<0>();
}

// The fragment of a 16 x 8 output tile at rows mb.., columns nb.. (mb a
// multiple of 16, nb of 8): v[e] at row mb + lane / 4 + 8 (e / 2), column
// nb + 2 (lane % 4) + e % 2, the mma accumulator layout. M < 2^31.

// The gate pre-activations in f32 into a slab (slab_index), from the
// gate-interleaved columns of GateRows: FUSED (s1 + b) + s2, CAT
// (s1 + s2) + b, ENC2 bf16(s1 + b) + s2, with s1 the input's sum and s2
// the recurrent one (zero in the forward's pre-pass). A null b adds none:
// cat's forward slab. When B is a multiple of 16 a fragment's rows lie in
// one step, and it is one float4 of the slab.
template <int MODE>
struct GatesOut {
    float* out;
    const float* b;
    int B, H, rtiles;
    __device__ __forceinline__ void operator()(long long mb, int nb, int lane, long long M,
                                               const float (&s1)[4],
                                               const float (&s2)[4]) const {
        const int g = nb % QN / 32, u = nb / QN * 32 + nb % 32 + lane % 4 * 2;
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float bias = b ? b[g * H + u + e % 2] : 0.f;
            v[e] = MODE == CAT    ? (s1[e] + s2[e]) + bias
                   : MODE == ENC2 ? to_cdt<bf16>(s1[e] + bias) + s2[e]
                                  : (s1[e] + bias) + s2[e];
        }
        const int m = (int)mb + lane / 4;
        if (B % 16 == 0) {
            if (m < M) {
                const int t = m / B;
                *reinterpret_cast<float4*>(out + slab_index(t, m - t * B, g, u, rtiles, H / 8)) =
                    make_float4(v[0], v[1], v[2], v[3]);
            }
            return;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int me = m + 8 * (e / 2), t = me / B;
            if (me < M) out[slab_index(t, me - t * B, g, u + e % 2, rtiles, H / 8)] = v[e];
        }
    }
};

// s1 rounded to bf16 into a row-major (M, N) array: dx
struct Bf16Out {
    bf16* out;
    int N;
    __device__ __forceinline__ void operator()(long long mb, int nb, int lane, long long M,
                                               const float (&s1)[4], const float (&)[4]) const {
        const int n = nb + lane % 4 * 2;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const long long m = mb + lane / 4 + 8 * half;
            if (m < M) st2(out + m * N + n, s1[2 * half], s1[2 * half + 1]);
        }
    }
};

// bf16(s1 + b) into a row-major (M, N) array: the archived ENC2's
// projection xp (lstm_enc2._pre, stored in its compute dtype), in the
// natural (T, B, 4H) order that mode XP's forward loop reads
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

// relu that keeps a NaN, as jnp.maximum(v, 0)
__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

// ENC5's encoder: bf16(relu(s1 + b_enc)) into a row-major (M, D) array,
// the encoded inputs xs (lstm_enc._encode_block, then its bf16 scratch)
struct EncodeOut {
    bf16* out;
    const float* b;
    int D;
    __device__ __forceinline__ void operator()(long long mb, int nb, int lane, long long M,
                                               const float (&s1)[4], const float (&)[4]) const {
        const int n = nb + lane % 4 * 2;
        const float b0 = __ldg(b + n), b1 = __ldg(b + n + 1);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const long long m = mb + lane / 4 + 8 * half;
            if (m < M) st2(out + m * D + n, relu(s1[2 * half] + b0), relu(s1[2 * half + 1] + b1));
        }
    }
};

// ENC5's dx epilogue: dpre = bf16(xs > 0 ? dx : 0), dx = s1 in f32, into
// a row-major (M, D) array; dx itself is never stored
struct DpreOut {
    bf16* out;
    const bf16* x;
    int D;
    __device__ __forceinline__ void operator()(long long mb, int nb, int lane, long long M,
                                               const float (&s1)[4], const float (&)[4]) const {
        const int n = nb + lane % 4 * 2;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const long long m = mb + lane / 4 + 8 * half;
            if (m < M) {
                const float2 xv = ld2(x + m * D + n);
                st2(out + m * D + n, xv.x > 0.f ? s1[2 * half] : 0.f,
                    xv.y > 0.f ? s1[2 * half + 1] : 0.f);
            }
        }
    }
};

// Row k of [feats | 1], (T*B, F + 1), as the A operand of the split-K
// contraction [feats | 1]^T dpre: its rows 0 .. F-1 are dW_enc, row F
// the column sums of dpre, db_enc (bf16 1.0 is exact, so each is an f32
// sum of the rounded dpre, in the contraction's fixed order)
struct FeatOnes {
    const bf16* p;
    int F;
    __device__ __forceinline__ uint4 load8(size_t k, int m) const {
        const unsigned short* raw = reinterpret_cast<const unsigned short*>(p) + k * F;
        uint32_t v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            uint32_t h[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int c = m + 2 * q + e;
                h[e] = c < F ? __ldg(raw + c) : c == F ? 0x3f80u : 0u;
            }
            v[q] = h[0] | h[1] << 16;
        }
        return make_uint4(v[0], v[1], v[2], v[3]);
    }
};

template <class SA1, class SB1, class SA2, class SB2, class Epi>
cudaError_t rows_gemm(SA1 a1, SB1 b1, int k1, SA2 a2, SB2 b2, int k2, Epi epi, long long M,
                      int N, cudaStream_t stream) {
    auto kernel = rows_gemm_kernel<SA1, SB1, SA2, SB2, Epi>;
    const size_t smem = gemm_smem(k1, k2);
    if (M >= (1LL << 31)) return cudaErrorInvalidValue;
    cudaError_t err = prepare(kernel, smem);
    int dev = 0, sms = 0, per_sm = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, QTHREADS, smem);
    if (err != cudaSuccess) return err;
    // as many blocks as fit on the card at once, spread over the columns
    const int ny = (N + QN - 1) / QN;
    const long long tiles = (M + QM - 1) / QM;
    const long long per_column = ((long long)(per_sm > 0 ? per_sm : 1) * sms + ny - 1) / ny;
    const dim3 grid((unsigned)(tiles < per_column ? tiles : per_column), ny);
    kernel<<<grid, QTHREADS, smem, stream>>>(a1, b1, k1, a2, b2, k2, epi, M, N);
    return cudaGetLastError();
}

// The operands of the GEMMs, rounded to bf16: [W_ih; W_hh] (D + H, 4H)
// into w; with wt and h16 also W_ih^T (4H, D) (the B operand of dx =
// dg @ W_ih^T) and h0 (B, H) (h_prev of step 0)
__global__ void round_operands(const float* __restrict__ w_ih, const float* __restrict__ w_hh,
                               const float* __restrict__ h0, bf16* __restrict__ w,
                               bf16* __restrict__ wt, bf16* __restrict__ h16, int D, int H,
                               int B) {
    const int G = 4 * H, n_ih = D * G, n_w = (D + H) * G;
    const long long n = n_w + (h16 ? (long long)B * H : 0);
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += (long long)gridDim.x * blockDim.x) {
        if (i >= n_w) {
            h16[i - n_w] = __float2bfloat16_rn(h0[i - n_w]);
            continue;
        }
        const bf16 v = __float2bfloat16_rn(i < n_ih ? w_ih[i] : w_hh[i - n_ih]);
        w[i] = v;
        if (wt && i < n_ih) wt[(size_t)(i % G) * D + i / G] = v;
    }
}

inline cudaError_t round_into(const float* w_ih, const float* w_hh, const float* h0, bf16* w,
                              bf16* wt, bf16* h16, int D, int H, int B, cudaStream_t stream) {
    round_operands<<<132, 256, 0, stream>>>(w_ih, w_hh, h0, w, wt, h16, D, H, B);
    return cudaGetLastError();
}

__global__ void round_rows(const float* __restrict__ src, bf16* __restrict__ dst, long long n) {
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += (long long)gridDim.x * blockDim.x)
        dst[i] = __float2bfloat16_rn(src[i]);
}

// The input widths the kernels take at hidden size H: rows of x move as
// 16-byte cp.async copies (D % 8 == 0), and the backward pre-pass holds
// its block's column of [W_ih; W_hh] (D + H rows) in shared memory
inline bool serves(int D, int H) {
    return D >= 8 && D % 8 == 0 && gemm_smem(D, H) <= (size_t)MAX_SMEM;
}

// The feature widths ENC5's encoder takes: its GEMM holds the block's
// column of W_enc (F rows) in shared memory
inline bool serves_features(int F) { return F >= 1 && gemm_smem(F, 0) <= (size_t)MAX_SMEM; }

// What mode ENC5 puts in front of the cell, and the encoder's share of
// its backward: feats (T*B, F) bf16; W_enc (F, D), b_enc (D,) f32; xs
// (T*B, D) bf16, the encoded inputs, written by encode (scratch); we16
// (F, D) bf16 scratch. Backward only: dpre (T*B, D) bf16 scratch; dwe
// (F + 1, D) f32, dW_enc then db_enc; dwe_part (splits, F + 1, D) f32.
struct Encoder {
    const bf16* feats = nullptr;
    const float* w_enc = nullptr;
    const float* b_enc = nullptr;
    bf16* xs = nullptr;
    bf16* we16 = nullptr;
    int F = 0;
    bf16* dpre = nullptr;
    float* dwe = nullptr;
    float* dwe_part = nullptr;
    int splits = 0;
};

// The Encoder of a backward from its C function's arguments: feats, W_enc,
// b_enc, the scratch xs and dpre, w16 ((D + H) * 4H + 4H * D + B * H +
// F * D bf16: [W_ih; W_hh], W_ih^T and h0 for backward, then W_enc), dwe
// and dwe_part (splits of them)
inline Encoder backward_encoder(const void* feats, const float* w_enc, const float* b_enc,
                                void* xs, void* dpre, void* w16, float* dwe, float* dwe_part,
                                int splits, int F, int D, int H, int B) {
    Encoder enc;
    enc.feats = static_cast<const bf16*>(feats);
    enc.w_enc = w_enc;
    enc.b_enc = b_enc;
    enc.xs = static_cast<bf16*>(xs);
    enc.we16 = static_cast<bf16*>(w16) + (size_t)(D + H) * 4 * H + (size_t)4 * H * D +
               (size_t)B * H;
    enc.F = F;
    enc.dpre = static_cast<bf16*>(dpre);
    enc.dwe = dwe;
    enc.dwe_part = dwe_part;
    enc.splits = splits;
    return enc;
}

// xs = bf16(relu(feats @ W_enc + b_enc)) over M = T*B rows: one GEMM
// with bf16 operands and an f32 sum, + b_enc, relu, then one rounding
// (lstm_enc._encode_block). The forward and the backward both call this,
// so that the backward's xs, and with it the relu mask, are the
// forward's bit for bit.
inline cudaError_t encode(const Encoder& e, int D, long long M, cudaStream_t stream) {
    round_rows<<<132, 256, 0, stream>>>(e.w_enc, e.we16, (long long)e.F * D);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const FeatRows f{e.feats, e.F};
    const BRows we{e.we16, D};
    return rows_gemm(f, we, e.F, f, we, 0, EncodeOut{e.xs, e.b_enc, D}, M, D, stream);
}

// The forward: x (T, B, D) bf16, weights f32; scratch xw (the slab, T * 64
// ceil(B / 64) * 4H f32, slab_index) and w16 ((D + H) * 4H bf16).
// phases: 1 stops after the pre-pass, 2 runs it all (a partial run serves
// only to time a phase).
template <int H, int MODE>
cudaError_t forward(const bf16* x, const float* h0, const float* c0, const float* w_ih,
                    const float* w_hh, const float* b, bf16* outs, bf16* cseq, float* hT,
                    float* cT, float* xw, bf16* w16, int T, int B, int D, int phases,
                    cudaStream_t stream) {
    constexpr int G = 4 * H;
    if (phases < 1 || phases > FORWARD_PHASES || !serves(D, H)) return cudaErrorInvalidValue;
    if (!aligned16(x)) return cudaErrorMisalignedAddress;
    const long long M = (long long)T * B;
    cudaError_t err = round_into(w_ih, w_hh, h0, w16, nullptr, nullptr, D, H, B, stream);
    if (err != cudaSuccess) return err;
    BRows xs{x, D};
    GateRows wi{w16, H};
    const int nblk = (B + BR - 1) / BR;
    // cat's slab holds x @ W_ih alone: its loop adds b after h @ W_hh
    const GatesOut<MODE> slab{xw, MODE == CAT ? nullptr : b, B, H, 4 * nblk};
    if ((err = rows_gemm(xs, wi, D, xs, wi, 0, slab, M, G, stream)) != cudaSuccess ||
        phases < 2)
        return err;
    auto kernel = forward_loop<H, MODE>;
    if ((err = prepare(kernel, Geo<H>::FWD_SMEM)) != cudaSuccess) return err;
    kernel<<<nblk, NTC, Geo<H>::FWD_SMEM, stream>>>(
        xw, b, h0, c0, w16 + (size_t)D * G, outs, cseq, hT, cT, T, B);
    return cudaGetLastError();
}

// ENC5's forward: the encoder into enc.xs, then CAT's forward on it. Its
// phases: 1, the encoder and the pre-pass; 2, all.
template <int H>
cudaError_t enc5_forward(const Encoder& enc, const float* h0, const float* c0,
                         const float* w_ih, const float* w_hh, const float* b, bf16* outs,
                         bf16* cseq, float* hT, float* cT, float* xw, bf16* w16, int T, int B,
                         int D, int phases, cudaStream_t stream) {
    if (phases < 1 || phases > FORWARD_PHASES || !serves(D, H) || !serves_features(enc.F))
        return cudaErrorInvalidValue;
    const cudaError_t err = encode(enc, D, (long long)T * B, stream);
    if (err != cudaSuccess) return err;
    return forward<H, CAT>(enc.xs, h0, c0, w_ih, w_hh, b, outs, cseq, hT, cT, xw, w16, T, B, D,
                           phases, stream);
}

// The archived ENC2's forward (lstm_enc2.py `_pre`, `_fwd_kernel`): the
// encoder into enc.xs; the projection xp = bf16(xs @ W_ih + b) as a GEMM
// into the scratch xp, (T, B, 4H) bf16 in its natural order (ProjOut, the
// TPU kernel's rounded xp slab); then mode XP's forward loop on xp: gates
// = xp_t + h @ W_hh, the recurrent product its own f32 sum, added after
// it. w16: (D + H) * 4H bf16 scratch, as the forward's. The other design,
// an f32 slab in the loops' fragment order (GatesOut<ENC2>) read by
// FUSED's loop, gives the same values from twice the bytes:
// tools/ablate_lstm_tc_torch.py's variant enc2-fused-slab. Phases: 1, the
// encoder and the projection; 2, all.
template <int H>
cudaError_t enc2_forward(const Encoder& enc, const float* h0, const float* c0,
                         const float* w_ih, const float* w_hh, const float* b, bf16* outs,
                         bf16* cseq, float* hT, float* cT, bf16* xp, bf16* w16, int T, int B,
                         int D, int phases, cudaStream_t stream) {
    constexpr int G = 4 * H;
    if (phases < 1 || phases > FORWARD_PHASES || !serves(D, H) || !serves_features(enc.F))
        return cudaErrorInvalidValue;
    if (!aligned16(enc.xs)) return cudaErrorMisalignedAddress;
    const long long M = (long long)T * B;
    cudaError_t err = round_into(w_ih, w_hh, nullptr, w16, nullptr, nullptr, D, H, B, stream);
    if (err != cudaSuccess || (err = encode(enc, D, M, stream)) != cudaSuccess) return err;
    const BRows xs{enc.xs, D}, wi{w16, G};
    if ((err = rows_gemm(xs, wi, D, xs, wi, 0, ProjOut{xp, b, G}, M, G, stream)) != cudaSuccess ||
        phases < 2)
        return err;
    auto kernel = forward_loop<H, XP, bf16>;
    if ((err = prepare(kernel, Geo<H>::FWD_SMEM)) != cudaSuccess) return err;
    kernel<<<(B + BR - 1) / BR, NTC, Geo<H>::FWD_SMEM, stream>>>(
        xp, nullptr, h0, c0, w16 + (size_t)D * G, outs, cseq, hT, cT, T, B);
    return cudaGetLastError();
}

// The backward: scratch pre (as the forward's xw) f32, w16 ((D + H) * 4H +
// 4H * D + B * H) bf16 (the rounded [W_ih; W_hh], W_ih^T and h0), dg
// (T, B, 4H) bf16, dw_part (splits, D + H, 4H) and db_part (ceil(B / BR),
// 4H) f32. phases: the first 1 .. 4 of pre-pass, loop, dx, dW + db.
// ENC, ENC5 and the archived ENC2, ENC3, ENC4 and ENC6: x is enc.xs, which
// the encoder writes first (the pre-pass phase); dx is not written, dpre in
// its place; the last phase adds dW_enc and db_enc.
template <int H, int MODE>
cudaError_t backward(const bf16* x, const float* h0, const float* c0, const float* w_ih,
                     const float* w_hh, const float* b, const bf16* outs, const bf16* cseq,
                     const bf16* g_outs, const float* g_hT, const float* g_cT, bf16* dx,
                     float* dh0, float* dc0, float* dw, float* db, bf16* dg, float* dw_part,
                     float* db_part, float* pre, bf16* w16, int T, int B, int D, int splits,
                     int part_rows, int phases, cudaStream_t stream,
                     const Encoder& enc = Encoder{}) {
    constexpr int G = 4 * H;
    constexpr bool ENCODER = has_encoder(MODE);
    // where the bias enters the gate sum: ENC's, ENC5's, ENC3's, ENC4's
    // and ENC6's cell is CAT's, ENC2 rounds its projection before adding the
    // recurrent sum
    constexpr int SUM = MODE == ENC2 ? ENC2 : ENCODER ? CAT : MODE;
    const int nblk = (B + BR - 1) / BR;
    if (phases < 1 || phases > BACKWARD_PHASES || part_rows != nblk || splits < 1 ||
        !serves(D, H))
        return cudaErrorInvalidValue;
    if (ENCODER && (x != enc.xs || !serves_features(enc.F) || enc.splits < 1))
        return cudaErrorInvalidValue;
    if (!aligned16(x) || !aligned16(outs)) return cudaErrorMisalignedAddress;
    const long long M = (long long)T * B;
    bf16* w16t = w16 + (size_t)(D + H) * G;  // W_ih^T (G, D)
    bf16* h16 = w16t + (size_t)G * D;        // h0 (B, H)
    cudaError_t err = round_into(w_ih, w_hh, h0, w16, w16t, h16, D, H, B, stream);
    if (err != cudaSuccess) return err;
    if constexpr (ENCODER) {
        if ((err = encode(enc, D, M, stream)) != cudaSuccess) return err;
    }
    BRows xs{x, D};
    GateRows wi{w16, H}, wh{w16 + (size_t)D * G, H};
    HPrev h_prev{h16, outs, B, H};
    const GatesOut<SUM> slab{pre, b, B, H, 4 * nblk};
    if ((err = rows_gemm(xs, wi, D, h_prev, wh, H, slab, M, G, stream)) != cudaSuccess ||
        phases < 2)
        return err;
    auto kernel = backward_loop<H, rounded_acts(MODE), rounded_db(MODE)>;
    if ((err = prepare(kernel, Geo<H>::BWD_SMEM)) != cudaSuccess) return err;
    kernel<<<nblk, NTC, Geo<H>::BWD_SMEM, stream>>>(pre, c0, w16 + (size_t)D * G, cseq, g_outs,
                                                    g_hT, g_cT, dh0, dc0, dg, db_part, T, B);
    if ((err = cudaGetLastError()) != cudaSuccess || phases < 3) return err;
    BRows dgs{dg, G}, wit{w16t, D};
    if constexpr (ENCODER)
        err = rows_gemm(dgs, wit, G, dgs, wit, 0, DpreOut{enc.dpre, x, D}, M, D, stream);
    else
        err = rows_gemm(dgs, wit, G, dgs, wit, 0, Bf16Out{dx, D}, M, D, stream);
    if (err != cudaSuccess || phases < 4) return err;
    const XHRows xh{x, h0, outs, B, D, H, h16};
    const Rows dgates{dg, G};
    if ((err = splitk(xh, dgates, dw_part, dw, D + H, G, M, splits, stream)) != cudaSuccess)
        return err;
    if ((err = reduce(db_part, db, nblk, G, stream)) != cudaSuccess) return err;
    if constexpr (ENCODER)
        err = splitk(FeatOnes{enc.feats, enc.F}, Rows{enc.dpre, D}, enc.dwe_part, enc.dwe,
                     enc.F + 1, D, M, enc.splits, stream);
    return err;
}

// Mode XP (lstm_scan): x_proj (T, B, 4H) in S, natural order; h0, c0
// (B, H), W_hh (H, 4H) f32. The forward: W_hh rounded into the scratch w16
// (H * 4H bf16), then the loop, which reads x_proj itself (no slab, no
// pre-pass); phases: 1, all of it.
template <int H, typename S>
cudaError_t xp_forward(const S* xp, const float* h0, const float* c0, const float* w_hh,
                       bf16* outs, bf16* cseq, float* hT, float* cT, bf16* w16, int T, int B,
                       int phases, cudaStream_t stream) {
    if (phases != XP_FORWARD_PHASES || !w16) return cudaErrorInvalidValue;
    cudaError_t err = round_into(nullptr, w_hh, nullptr, w16, nullptr, nullptr, 0, H, B, stream);
    if (err != cudaSuccess) return err;
    auto kernel = forward_loop<H, XP, S>;
    if ((err = prepare(kernel, Geo<H>::FWD_SMEM)) != cudaSuccess) return err;
    kernel<<<(B + BR - 1) / BR, NTC, Geo<H>::FWD_SMEM, stream>>>(xp, nullptr, h0, c0, w16, outs,
                                                                 cseq, hT, cT, T, B);
    return cudaGetLastError();
}

// Mode XP's backward: W_hh and h0 rounded into w16, then one reverse loop
// (xp_backward_loop) that recomputes each step's gates from x_proj and the
// stored outs, so that no pre-pass and no f32 slab of the gates run (a P
// pre-pass, FUSED's design, measured 0.19 ms slower on an H100 at T 16, B
// 8192, H 128: PERF.md), then dW_hh = h_prev^T dg by the split-K. dx_proj is the f32
// dgates in S: with bf16 x_proj it is the rounded dgates slab itself (the
// loop writes it, the split-K reads it); with f32 x_proj the loop writes
// the f32 dgates to dx_proj and the rounded ones to the scratch dg ((T,
// B, 4H) bf16, else unused). Scratch: w16 (H * 4H + B * H bf16: W_hh and
// h0 rounded), dw_part (splits, H, 4H) f32. phases: the first 1 .. 2 of
// loop, dW.
//
// xp_backward_steps runs steps t1 - 1 down to t0 of the same backward (the
// archived time-major scan: one step a call, the dh/dc carry in the f32
// buffers g_hT, g_cT in and dh0, dc0 out between calls). The call that
// starts the walk (t1 == T) rounds W_hh and h0 into w16, which the later
// calls read; the one that ends it (t0 == 0) runs dW over all T*B rows.
template <int H, typename S>
cudaError_t xp_backward_steps(const S* xp, const float* h0, const float* c0,
                              const float* w_hh, const bf16* outs, const bf16* cseq,
                              const bf16* g_outs, const float* g_hT, const float* g_cT, S* dxp,
                              float* dh0, float* dc0, float* dw, bf16* dg, float* dw_part,
                              bf16* w16, int t0, int t1, int T, int B, int splits, int phases,
                              cudaStream_t stream) {
    constexpr int G = 4 * H;
    constexpr bool F32 = std::is_same<S, float>::value;
    if (phases < 1 || phases > XP_BACKWARD_PHASES || splits < 1 || !w16 || (F32 && !dg) ||
        t0 < 0 || t0 >= t1 || t1 > T)
        return cudaErrorInvalidValue;
    if (!aligned16(outs) || !aligned16(w16)) return cudaErrorMisalignedAddress;
    bf16* h16 = w16 + (size_t)H * G;
    cudaError_t err = cudaSuccess;
    if (t1 == T &&
        (err = round_into(nullptr, w_hh, h0, w16, nullptr, h16, 0, H, B, stream)) != cudaSuccess)
        return err;
    bf16* dgs = F32 ? dg : reinterpret_cast<bf16*>(dxp);
    auto kernel = xp_backward_loop<H, S>;
    if ((err = prepare(kernel, Geo<H>::XP_BWD_SMEM)) != cudaSuccess) return err;
    kernel<<<(B + BR - 1) / BR, NTC, Geo<H>::XP_BWD_SMEM, stream>>>(
        xp, h16, c0, w16, outs, cseq, g_outs, g_hT, g_cT, dh0, dc0, dgs,
        F32 ? reinterpret_cast<float*>(dxp) : nullptr, t0, t1, B);
    if ((err = cudaGetLastError()) != cudaSuccess || phases < 2 || t0 > 0) return err;
    const XHRows hp{nullptr, h0, outs, B, 0, H, h16};
    return splitk(hp, Rows{dgs, G}, dw_part, dw, H, G, (long long)T * B, splits, stream);
}

template <int H, typename S>
cudaError_t xp_backward(const S* xp, const float* h0, const float* c0, const float* w_hh,
                        const bf16* outs, const bf16* cseq, const bf16* g_outs,
                        const float* g_hT, const float* g_cT, S* dxp, float* dh0, float* dc0,
                        float* dw, bf16* dg, float* dw_part, bf16* w16, int T, int B,
                        int splits, int phases, cudaStream_t stream) {
    return xp_backward_steps<H, S>(xp, h0, c0, w_hh, outs, cseq, g_outs, g_hT, g_cT, dxp, dh0,
                                   dc0, dw, dg, dw_part, w16, 0, T, T, B, splits, phases,
                                   stream);
}

// Step t of mode XP's forward alone, for the archived time-major scan:
// forward_loop at one step on row t of x_proj, outs and cseq (T, B, ...),
// from the f32 state h_in, c_in to h_out, c_out (B, H), which the loop
// writes as its hT and cT: the carry between calls is what the loop keeps
// (c in f32, h in f32 rounded to bf16 as it enters the product), so T
// calls give xp_forward's outputs bit for bit. The call at t == 0 rounds
// W_hh into w16 (H * 4H bf16), which the later calls read.
template <int H, typename S>
cudaError_t xp_forward_step(const S* xp, const float* h_in, const float* c_in,
                            const float* w_hh, bf16* outs, bf16* cseq, float* h_out,
                            float* c_out, bf16* w16, int t, int T, int B, cudaStream_t stream) {
    if (!w16 || !cseq || t < 0 || t >= T) return cudaErrorInvalidValue;
    cudaError_t err = cudaSuccess;
    if (t == 0 && (err = round_into(nullptr, w_hh, nullptr, w16, nullptr, nullptr, 0, H, B,
                                    stream)) != cudaSuccess)
        return err;
    auto kernel = forward_loop<H, XP, S>;
    if ((err = prepare(kernel, Geo<H>::FWD_SMEM)) != cudaSuccess) return err;
    const size_t row = (size_t)t * B;
    kernel<<<(B + BR - 1) / BR, NTC, Geo<H>::FWD_SMEM, stream>>>(
        xp + row * 4 * H, nullptr, h_in, c_in, w16, outs + row * H, cseq + row * H, h_out, c_out,
        1, B);
    return cudaGetLastError();
}

// Registers and local (spilled) bytes per thread of n kernels, as
// out[2i], out[2i + 1]
inline cudaError_t attributes(const void* const* fns, int n, int* out) {
    for (int i = 0; i < n; ++i) {
        cudaFuncAttributes a;
        const cudaError_t err = cudaFuncGetAttributes(&a, fns[i]);
        if (err != cudaSuccess) return err;
        out[2 * i] = a.numRegs;
        out[2 * i + 1] = (int)a.localSizeBytes;
    }
    return cudaSuccess;
}

// Those of ENC5's bf16 kernels at hidden size H: the encoder, the forward
// pre-pass, the forward loop, the backward pre-pass, the backward loop,
// dpre
template <int H>
cudaError_t enc5_usage(int* out) {
    const void* fns[] = {
        reinterpret_cast<const void*>(
            rows_gemm_kernel<FeatRows, BRows, FeatRows, BRows, EncodeOut>),
        reinterpret_cast<const void*>(
            rows_gemm_kernel<BRows, GateRows, BRows, GateRows, GatesOut<CAT>>),
        reinterpret_cast<const void*>(forward_loop<H, CAT>),
        reinterpret_cast<const void*>(
            rows_gemm_kernel<BRows, GateRows, HPrev, GateRows, GatesOut<CAT>>),
        reinterpret_cast<const void*>(backward_loop<H, true, true>),
        reinterpret_cast<const void*>(rows_gemm_kernel<BRows, BRows, BRows, BRows, DpreOut>)};
    return attributes(fns, 6, out);
}

// Those of mode XP's kernels at hidden size H: the forward loop with bf16
// and with f32 x_proj, the backward loop likewise, and the ring split-K of
// dW_hh (which every resident bf16 LSTM backward's dW runs)
template <int H>
cudaError_t xp_usage(int* out) {
    const void* fns[] = {
        reinterpret_cast<const void*>(forward_loop<H, XP, bf16>),
        reinterpret_cast<const void*>(forward_loop<H, XP, float>),
        reinterpret_cast<const void*>(xp_backward_loop<H, bf16>),
        reinterpret_cast<const void*>(xp_backward_loop<H, float>),
        reinterpret_cast<const void*>(gemm_tn_splitk_ring<XHRows, Rows>)};
    return attributes(fns, 5, out);
}

// Those of the bf16 path's kernels at hidden size H in mode MODE: FUSED
// and CAT, the forward pre-pass, the forward loop, the backward pre-pass,
// the backward loop, dx (the last two serve both modes); ENC5 enc5_usage's,
// XP xp_usage's
template <int H, int MODE>
cudaError_t usage(int* out) {
    if constexpr (MODE == ENC5) {
        return enc5_usage<H>(out);
    } else if constexpr (MODE == XP) {
        return xp_usage<H>(out);
    } else {
        const void* fns[] = {
            reinterpret_cast<const void*>(
                rows_gemm_kernel<BRows, GateRows, BRows, GateRows, GatesOut<MODE>>),
            reinterpret_cast<const void*>(forward_loop<H, MODE>),
            reinterpret_cast<const void*>(
                rows_gemm_kernel<BRows, GateRows, HPrev, GateRows, GatesOut<MODE>>),
            reinterpret_cast<const void*>(backward_loop<H, false, false>),
            reinterpret_cast<const void*>(
                rows_gemm_kernel<BRows, BRows, BRows, BRows, Bf16Out>)};
        return attributes(fns, 5, out);
    }
}

template <int MODE>
int usage_at(int H, int* out) {
    switch (H) {
        case 32: return (int)usage<32, MODE>(out);
        case 64: return (int)usage<64, MODE>(out);
        case 128: return (int)usage<128, MODE>(out);
    }
    return (int)cudaErrorInvalidValue;
}

// The bf16 bodies of the C functions of both cells (lstm_scan.cu's fused
// pair, lstm_cat.cu's cat pair), for lstm::dispatch: the kernels above.
// Their f32 bodies are lstm_f32.cuh's f32::CellForward / CellBackward.
template <int MODE, int H>
struct CellForward {
    static cudaError_t run(const void* x, const float* h0, const float* c0,
                           const float* w_ih, const float* w_hh, const float* b,
                           void* outs, void* cseq, float* hT, float* cT, float* xw, void* w16,
                           int T, int B, int D, int phases, cudaStream_t stream) {
        return forward<H, MODE>(static_cast<const bf16*>(x), h0, c0, w_ih, w_hh, b,
                                static_cast<bf16*>(outs), static_cast<bf16*>(cseq), hT, cT, xw,
                                static_cast<bf16*>(w16), T, B, D, phases, stream);
    }
};

template <int MODE, int H>
struct CellBackward {
    static cudaError_t run(const void* x, const float* h0, const float* c0,
                           const float* w_ih, const float* w_hh, const float* b,
                           const void* outs, const void* cseq, const void* g_outs,
                           const float* g_hT, const float* g_cT, void* dx, float* dh0,
                           float* dc0, float* dw, float* db, void* dg, float* dw_part,
                           float* db_part, float* pre, void* w16, int T, int B, int D,
                           int splits, int part_rows, int phases, cudaStream_t stream) {
        return backward<H, MODE>(
            static_cast<const bf16*>(x), h0, c0, w_ih, w_hh, b, static_cast<const bf16*>(outs),
            static_cast<const bf16*>(cseq), static_cast<const bf16*>(g_outs), g_hT, g_cT,
            static_cast<bf16*>(dx), dh0, dc0, dw, db, static_cast<bf16*>(dg), dw_part, db_part,
            pre, static_cast<bf16*>(w16), T, B, D, splits, part_rows, phases, stream);
    }
};

}  // namespace tc
}  // namespace lstm
