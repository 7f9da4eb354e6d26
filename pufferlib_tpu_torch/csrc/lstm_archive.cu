// The archived LSTM kernel variants (enc2, enc3, enc4, enc6, tm), for
// Hopper (sm_90a): the schedules that the TPU kernel campaign tried and
// set aside, kept runnable as the record of which hoistings of the LSTM
// backward pay. Off the trainer's path; tools/kernel_lab_torch.py times
// them.
//
// Replaces the TPU kernels of pufferlib_tpu/ops/pallas/archive/:
// * lstm_enc2.lstm_scan_enc2 (lstm_enc2_forward, lstm_enc2_backward):
//   `_impl` / `_fwd_kernel` and `_bwd` / `_bwd_kernel`. The encoder
//   x = relu(feats @ W_enc + b_enc), then gates = cdt(x_t @ W_ih + b) +
//   h @ W_hh: the projection passes through the compute dtype (the TPU
//   kernel's xp slab) before the recurrent sum, its own f32 sum, is added.
//   Backward: gates recomputed the same way, f32 activations, dgates
//   rounded to a slab, only dh_prev = dg @ W_hh^T inside the reverse loop;
//   after it dx = dg @ W_ih^T, the relu mask and dpre, then dW_ih, dW_hh,
//   db from the rounded slab, dW_enc and db_enc.
// * lstm_enc3.lstm_scan_enc3's backward (lstm_enc3_backward): `_bwd` /
//   `_bwd_kernel`. Every step's gates before the reverse loop, their
//   activations stored in the compute dtype; the loop reads them back and
//   runs [dx | dh_prev] = dg @ [W_ih; W_hh]^T; db from the unrounded
//   dgates.
// * lstm_enc4.lstm_scan_enc4's backward (lstm_enc4_backward):
//   lstm_enc5._hoisted_bwd with lstm_enc4._bwd_kernel. Gates recomputed
//   inside the loop as one sum over K = D + H, f32 activations, dh_prev
//   alone in the loop, dx after it, db from the rounded slab.
// * lstm_enc6.lstm_scan_enc6's backward (lstm_enc6_backward):
//   `_hoisted_bwd` with lstm_enc6._bwd_kernel. enc5's function (activations
//   before the loop, rounded; dh_prev in the loop; dx after it) on two
//   independent half tiles per block, each with its own dh/dc chain, in
//   one loop body.
// * lstm_tm.lstm_scan_tm (lstm_tm_step_forward, lstm_tm_step_backward):
//   `_fwd_impl_tm` / `_fwd_kernel_tm` and `_lstm_tm_bwd` / `_bwd_kernel_tm`,
//   the grid with time outermost: one step of the whole batch per launch,
//   gates = x_proj_t + h @ W_hh, h and c (backward: dh and dc) carried in
//   f32 device buffers between launches.
// enc3, enc4 and enc6 share the forward of lstm_enc.cu. Same functions as
// the plain versions of pufferlib_tpu_torch.ops.cuda.archive.
//
// Bound: the functions are those of lstm_enc.cu (enc2, 3, 4, 6: bound by
// bf16 tensor-core operations, about 0.036 ms forward and 0.108 ms backward
// at T = 16, B = 8192, F = 49, D = H = 128) and of lstm_scan.cu's lstm_scan
// (tm: bound by bytes, about 0.065 and 0.12 ms).
//
// Design, by row and compute dtype. The encoder-fused backwards differ in
// two roundings of the reverse loop (lstm_common.cuh rounded_acts,
// rounded_db) and in where the gates are recomputed:
// * bf16 enc2, enc3, enc4 and enc6 backwards: csrc/lstm_tc.cuh's backward
//   in modes ENC2, ENC3, ENC4 and ENC6, mode ENC5's path, every product on
//   the tensor cores: the encoder GEMM; the P pre-pass over all T*B rows,
//   (x @ W_ih + h_prev @ W_hh) + b, for enc2 bf16(x @ W_ih + b) + h_prev
//   @ W_hh (the projection rounded in the epilogue, as its TPU kernel's
//   slab); the reverse loop with W_hh in shared memory and the loop's
//   roundings: enc2 and enc4 f32 activations and db from the rounded
//   dgates, enc3 rounded activations and db from the unrounded dgates,
//   enc6 enc5's own (both rounded: enc6's gradients are enc5's bit for
//   bit); dpre; the split-K of [x | h_prev]^T dg and of [feats | 1]^T
//   dpre. The TPU kernels of enc2 and enc4 recompute the gates inside the
//   loop, enc3's runs [dx | dh_prev] = dg @ [W_ih; W_hh]^T and carries dW
//   there: [W_ih; W_hh] in bf16 fits no block here, so the pre-pass
//   recomputes the gates, dx is a GEMM after the loop and dW the split-K.
//   enc6's two independent half-tile chains are the tensor-core loop's
//   two halves, each with a barrier of its own. All four take the reach
//   of the FMA kernels below (D == H, F <= 128), inside the tensor-core
//   kernels'.
// * everything else: plain f32 FMA from weights streamed out of L2 in
//   chunks, far above the bounds above: the f32 backwards (f32 is the
//   exact test mode), enc2's forward in both dtypes, tm.
//
// FMA design (csrc/lstm_common.cuh): one backward kernel, archive_backward
// (f32 only), whose MODE picks the rounding points and the schedule. The
// TPU kernels'
// VMEM slabs of T * bt rows fit no block's shared memory, so a slab that
// they keep (enc3's and enc6's activations, every variant's dgates) lives
// in device memory, written and read back by the thread that owns the
// element, and the passes before and after the loop are loops over t in
// the same block. enc6 gives a block 64 rows as two tiles of 32: both
// chains' element-wise steps, then one stream of W_hh^T whose every staged
// chunk serves both tiles; a ragged batch may leave the second tile short
// or empty, and its rows are masked. tm is the cell kernels of mode XP
// walking one step per launch: stream order is the only synchronisation a
// timestep needs, since batch tiles do not talk to each other; dW_hh is
// the split-K contraction over the dgates slab once step 0 is done. The
// weight gradients are split-K with partials added in a fixed order, as in
// the other LSTM sources.
#include "lstm_common.cuh"
#include "lstm_tc.cuh"

using namespace lstm;

namespace {

// The schedule of an archived encoder-fused backward
__host__ __device__ constexpr bool gates_before_loop(int mode) {
    return mode == ENC3 || mode == ENC6;
}
__host__ __device__ constexpr bool dx_after_loop(int mode) { return mode != ENC3; }
__host__ __device__ constexpr int row_tiles(int mode) { return mode == ENC6 ? 2 : 1; }

// x_t and the gate activations a (i, f, g, o) of step t for one row tile:
// the encoder from feats_t, x_t rounded into op[0 .. D) and the slab xs,
// h_prev into op[D .. K), the gate sums of MODE, the activations rounded
// where MODE stores them. op is (K, BT) of shared memory. Ends on a
// barrier, after which op and w_s are free.
template <int H, typename E, int MODE>
__device__ __forceinline__ void step_activations(
        float (&a)[4][Tile<H>::RPT], const E* feats, const float* h0, const E* outs, E* xs,
        float* op, float* w_s, const float* we_s, float* f_s, const float* w_ih,
        const float* w_hh, const float (&bias)[4], float be, int t, size_t row0, int nrows,
        int B, int F, int r0, int j) {
    constexpr int D = Tile<H>::D, RPT = Tile<H>::RPT;
    const size_t base = (size_t)t * B + row0;
    load_rows<E>(f_s, feats, base, F, nrows);
    __syncthreads();
    float x[RPT];
    encode_rows<H>(x, f_s, we_s, be, F, r0, j);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        const int r = r0 + i;
        const float v = to_cdt<E>(x[i]);
        op[j * BT + r] = v;
        if (r < nrows) st(xs, (base + r) * D + j, v);
    }
    // h_prev: h0 at t = 0, else the stored outs of t - 1
    if (t == 0)
        load_rows<E>(op + D * BT, h0, row0, H, nrows);
    else
        load_rows<E>(op + D * BT, outs, base - B, H, nrows);
    __syncthreads();
    float pre[4][RPT];
    gate_sums<H, E, MODE, !two_sums(MODE)>(a, pre, op, w_s, w_ih, w_hh, bias, r0, j);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        a[0][i] = sigm(a[0][i]);
        a[1][i] = sigm(a[1][i]);
        a[2][i] = tanhf(a[2][i]);
        a[3][i] = sigm(a[3][i]);
        if constexpr (rounded_acts(MODE)) {
#pragma unroll
            for (int g = 0; g < 4; ++g) a[g][i] = to_cdt<E>(a[g][i]);
        }
    }
}

// dpre = cdt(relu mask of dx) for the thread's rows of one tile, x read
// back from the slab xs; adds dpre into dbe_acc
template <int H, typename E>
__device__ __forceinline__ void store_dpre(const float (&dx)[Tile<H>::RPT], const E* xs,
                                           E* dpre, float& dbe_acc, size_t base, int nrows,
                                           int r0, int j) {
    constexpr int D = Tile<H>::D, RPT = Tile<H>::RPT;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        const int r = r0 + i;
        if (r >= nrows) continue;
        const size_t idx = (base + r) * D + j;
        const float p = to_cdt<E>(ld(xs, idx) > 0.f ? dx[i] : 0.f);
        st(dpre, idx, p);
        dbe_acc += p;
    }
}

// feats (T, B, F), outs, cseq, g_outs (T, B, H) in the compute dtype E;
// the state, its gradients and the weights f32. Slabs in device memory,
// all written here: xs and dpre (T, B, D), dg (T, B, 4H) and, where the
// gates come before the loop, acts (T, B, 4H), in E. A thread reads back
// only the slab elements that it wrote itself, so the slabs need no
// barrier (and carry no __restrict__: they are read after being written).
// A block takes row_tiles(MODE) tiles of BT rows.
template <int H, typename E, int MODE>
__global__ void __launch_bounds__(NT) archive_backward(
        const E* __restrict__ feats, const float* __restrict__ h0,
        const float* __restrict__ c0, const float* __restrict__ w_enc,
        const float* __restrict__ b_enc, const float* __restrict__ w_ih,
        const float* __restrict__ w_hh, const float* __restrict__ b,
        const E* __restrict__ outs, const E* __restrict__ cseq,
        const E* __restrict__ g_outs, const float* __restrict__ g_hT,
        const float* __restrict__ g_cT, float* __restrict__ dh0,
        float* __restrict__ dc0, E* xs, E* dpre, E* dg, E* acts,
        float* __restrict__ db_part, float* __restrict__ dbe_part, int T, int B, int F) {
    using TL = Tile<H>;
    constexpr int D = TL::D, K = TL::K, G = TL::G, RPT = TL::RPT;
    constexpr int NH = row_tiles(MODE);
    constexpr bool PREPASS = gates_before_loop(MODE), DX_AFTER = dx_after_loop(MODE);
    static_assert(PREPASS || NH == 1, "gates recomputed in the loop take one tile");
    extern __shared__ __align__(16) float smem[];
    float* buf = smem;                 // NH tiles of (G, BT): [x_t | h_prev], then dgates
    float* w_s = buf + NH * G * BT;    // (KC, G) weight rows / (KC, KS) columns
    float* we_s = w_s + KC * G;        // (F, D) W_enc, rounded
    float* f_s = we_s + F * D;         // (F, BT) feats_t, rounded

    const int j = threadIdx.x % H, rg = threadIdx.x / H, r0 = rg * RPT;
    const int row0 = blockIdx.x * NH * BT;
    int nrows[NH];
#pragma unroll
    for (int s = 0; s < NH; ++s) nrows[s] = max(0, min(BT, B - row0 - s * BT));
    float bias[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) bias[g] = b[g * H + j];
    const float be = b_enc[j];
    for (int i = threadIdx.x; i < F * D; i += NT) we_s[i] = to_cdt<E>(w_enc[i]);

    if constexpr (PREPASS) {
        // every step's x and gate activations, into the slabs
        for (int t = 0; t < T; ++t) {
#pragma unroll
            for (int s = 0; s < NH; ++s) {
                float a[4][RPT];
                step_activations<H, E, MODE>(a, feats, h0, outs, xs, buf, w_s, we_s, f_s,
                                             w_ih, w_hh, bias, be, t, (size_t)row0 + s * BT,
                                             nrows[s], B, F, r0, j);
                const size_t base = (size_t)t * B + row0 + s * BT;
#pragma unroll
                for (int i = 0; i < RPT; ++i) {
                    if (r0 + i >= nrows[s]) continue;
#pragma unroll
                    for (int g = 0; g < 4; ++g)
                        st(acts, (base + r0 + i) * G + g * H + j, a[g][i]);
                }
            }
        }
    }

    float dh[NH][RPT], dc[NH][RPT];
#pragma unroll
    for (int s = 0; s < NH; ++s)
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
            const int r = r0 + i;
            const size_t idx = (size_t)(row0 + s * BT + r) * H + j;
            dh[s][i] = r < nrows[s] ? g_hT[idx] : 0.f;
            dc[s][i] = r < nrows[s] ? g_cT[idx] : 0.f;
        }
    float db_acc[4] = {0.f, 0.f, 0.f, 0.f};
    float dbe_acc = 0.f;

    for (int t = T - 1; t >= 0; --t) {
        // each tile's element-wise chain, its rounded dgates into the
        // tile's buffer and the slab
#pragma unroll
        for (int s = 0; s < NH; ++s) {
            float* tile = buf + s * G * BT;
            const int trow0 = row0 + s * BT;
            const size_t base = (size_t)t * B + trow0;
            float a[4][RPT];
            if constexpr (PREPASS) {
#pragma unroll
                for (int i = 0; i < RPT; ++i)
#pragma unroll
                    for (int g = 0; g < 4; ++g)
                        a[g][i] = r0 + i < nrows[s]
                            ? ld(acts, (base + r0 + i) * G + g * H + j) : 0.f;
            } else {
                step_activations<H, E, MODE>(a, feats, h0, outs, xs, tile, w_s, we_s, f_s,
                                             w_ih, w_hh, bias, be, t, (size_t)trow0,
                                             nrows[s], B, F, r0, j);
            }
#pragma unroll
            for (int i = 0; i < RPT; ++i) {
                const int r = r0 + i;
                const bool ok = r < nrows[s];
                const size_t idx = (base + r) * H + j;
                const float gout = ok ? ld(g_outs, idx) : 0.f;
                const float ct = ok ? ld(cseq, idx) : 0.f;
                const float cp = !ok ? 0.f
                    : t == 0 ? c0[(size_t)(trow0 + r) * H + j]
                    : ld(cseq, idx - (size_t)B * H);
                float d[4];
                dgates_chain(d, dc[s][i], dh[s][i] + gout, a[0][i], a[1][i], a[2][i],
                             a[3][i], ct, cp);
#pragma unroll
                for (int g = 0; g < 4; ++g) {
                    const float dcg = to_cdt<E>(d[g]);
                    tile[(g * H + j) * BT + r] = dcg;
                    if (ok) {
                        st(dg, (base + r) * G + g * H + j, dcg);
                        db_acc[g] += rounded_db(MODE) ? dcg : d[g];
                    }
                }
            }
        }
        __syncthreads();

        // dh_prev = dgates @ W_hh^T for every tile from one stream of
        // columns; with dx inside the loop, [dx | dh_prev]
        float ax[NH][RPT], ah[NH][RPT];
        cols_gemm<H, E, DX_AFTER ? D : 0, K, NH>(ax, ah, buf, w_s, w_ih, w_hh, r0, j);
#pragma unroll
        for (int s = 0; s < NH; ++s) {
#pragma unroll
            for (int i = 0; i < RPT; ++i) dh[s][i] = ah[s][i];
            if constexpr (!DX_AFTER)
                store_dpre<H, E>(ax[s], xs, dpre, dbe_acc,
                                 (size_t)t * B + row0 + s * BT, nrows[s], r0, j);
        }
    }
#pragma unroll
    for (int s = 0; s < NH; ++s)
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
            const int r = r0 + i;
            if (r < nrows[s]) {
                const size_t idx = (size_t)(row0 + s * BT + r) * H + j;
                dh0[idx] = dh[s][i];
                dc0[idx] = dc[s][i];
            }
        }

    if constexpr (DX_AFTER) {
        // dx = dgates @ W_ih^T over every step, from the slab of dgates
        for (int t = 0; t < T; ++t) {
#pragma unroll
            for (int s = 0; s < NH; ++s) {
                float* tile = buf + s * G * BT;
                const size_t base = (size_t)t * B + row0 + s * BT;
#pragma unroll
                for (int i = 0; i < RPT; ++i)
#pragma unroll
                    for (int g = 0; g < 4; ++g)
                        tile[(g * H + j) * BT + r0 + i] = r0 + i < nrows[s]
                            ? ld(dg, (base + r0 + i) * G + g * H + j) : 0.f;
            }
            __syncthreads();
            float ax[NH][RPT], ah[NH][RPT];
            cols_gemm<H, E, 0, D, NH>(ax, ah, buf, w_s, w_ih, w_hh, r0, j);
#pragma unroll
            for (int s = 0; s < NH; ++s)
                store_dpre<H, E>(ax[s], xs, dpre, dbe_acc,
                                 (size_t)t * B + row0 + s * BT, nrows[s], r0, j);
        }
    }
    // buf is free: the last product ended on a barrier
    store_bias_partials<H, true>(buf, db_acc, dbe_acc, db_part, dbe_part, rg, j);
}

inline size_t archive_smem(int H, int F, int tiles) {
    return sizeof(float) * ((size_t)tiles * 4 * H * BT + (size_t)KC * 4 * H +
                            (size_t)F * H + (size_t)F * BT);
}

// The recurrent kernel, then the weight and bias gradients. part_rows is
// the number of blocks: ceil(B / (32 * row_tiles(MODE))).
template <int H, typename E, int MODE>
cudaError_t run_archive_backward(const void* feats, const float* h0, const float* c0,
                                 const float* w_enc, const float* b_enc, const float* w_ih,
                                 const float* w_hh, const float* b, const void* outs,
                                 const void* cseq, const void* g_outs, const float* g_hT,
                                 const float* g_cT, float* dh0, float* dc0, float* dw_enc,
                                 float* db_enc, float* dw, float* db, void* xs, void* dpre,
                                 void* dg, void* acts, float* dw_part, float* db_part,
                                 float* dwe_part, float* dbe_part, int T, int B, int F,
                                 int splits_w, int splits_e, int part_rows,
                                 cudaStream_t stream) {
    constexpr int ROWS = BT * row_tiles(MODE);
    const int nblk = (B + ROWS - 1) / ROWS;
    if (part_rows != nblk || splits_w < 1 || splits_e < 1) return cudaErrorInvalidValue;
    if (gates_before_loop(MODE) && !acts) return cudaErrorInvalidValue;
    auto kernel = archive_backward<H, E, MODE>;
    const size_t smem = archive_smem(H, F, row_tiles(MODE));
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<nblk, NT, smem, stream>>>(
        static_cast<const E*>(feats), h0, c0, w_enc, b_enc, w_ih, w_hh, b,
        static_cast<const E*>(outs), static_cast<const E*>(cseq),
        static_cast<const E*>(g_outs), g_hT, g_cT, dh0, dc0, static_cast<E*>(xs),
        static_cast<E*>(dpre), static_cast<E*>(dg), static_cast<E*>(acts), db_part,
        dbe_part, T, B, F);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    return encoder_weight_grads<H, E>(feats, h0, outs, xs, dpre, dg, dw_enc, db_enc, dw, db,
                                      dw_part, db_part, dwe_part, dbe_part, T, B, F,
                                      splits_w, splits_e, nblk, stream);
}

// The encoder-fused backwards: bf16 on the tensor cores (tc::backward in
// mode MODE), f32 on archive_backward. D == H. pre: in bf16 the P slab
// (lstm_tc.cuh slab_index) f32; in f32 the activations slab (T, B, 4H)
// of the modes that keep one (gates_before_loop: enc3, enc6), else null.
template <int MODE>
struct TcBackward {
    template <int H, typename E>
    struct Of {
        static cudaError_t run(const void* feats, const float* h0, const float* c0,
                               const float* w_enc, const float* b_enc, const float* w_ih,
                               const float* w_hh, const float* b, const void* outs,
                               const void* cseq, const void* g_outs, const float* g_hT,
                               const float* g_cT, float* dh0, float* dc0, float* dwe, float* dw,
                               float* db, void* xs, void* dpre, void* dg, float* dw_part,
                               float* db_part, float* dwe_part, float* dbe_part, void* pre,
                               void* w16, int T, int B, int F, int splits_w, int splits_e,
                               int part_rows, int phases, cudaStream_t stream) {
            if constexpr (std::is_same<E, bf16>::value) {
                if (!pre || !w16) return cudaErrorInvalidValue;
                const tc::Encoder enc = tc::backward_encoder(feats, w_enc, b_enc, xs, dpre, w16,
                                                             dwe, dwe_part, splits_e, F, H, H, B);
                return tc::backward<H, MODE>(
                    enc.xs, h0, c0, w_ih, w_hh, b, static_cast<const E*>(outs),
                    static_cast<const E*>(cseq), static_cast<const E*>(g_outs), g_hT, g_cT,
                    nullptr, dh0, dc0, dw, db, static_cast<E*>(dg), dw_part, db_part,
                    static_cast<float*>(pre), static_cast<E*>(w16), T, B, H, splits_w, part_rows,
                    phases, stream, enc);
            } else {
                if (phases != tc::BACKWARD_PHASES) return cudaErrorInvalidValue;
                return run_archive_backward<H, E, MODE>(
                    feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b, outs, cseq, g_outs, g_hT, g_cT,
                    dh0, dc0, dwe, dwe + (size_t)F * H, dw, db, xs, dpre, dg,
                    gates_before_loop(MODE) ? pre : nullptr, dw_part, db_part, dwe_part, dbe_part,
                    T, B, F, splits_w, splits_e, part_rows, stream);
            }
        }
    };
};

// Registers and spilled bytes per thread of the archive's own bf16 kernels
// at hidden size H, as out[2i], out[2i + 1]: enc2's pre-pass (its
// epilogue rounds the projection), the reverse loop of enc2 and enc4 (f32
// activations, db from the rounded dgates) and enc3's (rounded
// activations, db from the unrounded dgates). The encoder, the other
// pre-pass, dpre, the split-K and enc6's loop are enc5's.
template <int H>
cudaError_t tc_usage(int* out) {
    static_assert(rounded_acts(ENC2) == rounded_acts(ENC4) &&
                      rounded_db(ENC2) == rounded_db(ENC4),
                  "enc2 and enc4 share a reverse loop");
    static_assert(rounded_acts(ENC6) == rounded_acts(ENC5) &&
                      rounded_db(ENC6) == rounded_db(ENC5),
                  "enc6 runs enc5's reverse loop");
    const void* fns[] = {
        reinterpret_cast<const void*>(
            tc::rows_gemm_kernel<tc::BRows, tc::GateRows, tc::HPrev, tc::GateRows,
                                 tc::GatesOut<ENC2>>),
        reinterpret_cast<const void*>(
            tc::backward_loop<H, rounded_acts(ENC4), rounded_db(ENC4)>),
        reinterpret_cast<const void*>(
            tc::backward_loop<H, rounded_acts(ENC3), rounded_db(ENC3)>)};
    return tc::attributes(fns, 3, out);
}

template <int H, typename E>
struct Enc2Forward {
    static cudaError_t run(const void* feats, const float* h0, const float* c0,
                           const float* w_enc, const float* b_enc, const float* w_ih,
                           const float* w_hh, const float* b, void* outs, void* cseq,
                           float* hT, float* cT, int T, int B, int F, cudaStream_t stream) {
        return run_forward<H, E, E, ENC2>(feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b, outs,
                                          cseq, hT, cT, T, B, F, stream);
    }
};

template <int H, typename E>
struct TmStepForward {
    template <typename S>
    static cudaError_t run_as(const void* x_proj, const float* h_in, const float* c_in,
                              const float* w_hh, void* outs, void* cseq, float* h_out,
                              float* c_out, int t, int B, cudaStream_t stream) {
        return run_forward_steps<H, E, S, XP>(x_proj, h_in, c_in, nullptr, nullptr, nullptr,
                                              w_hh, nullptr, outs, cseq, h_out, c_out, t,
                                              t + 1, B, 0, stream);
    }
    template <typename... Args>
    static cudaError_t run(int xp_bf16, Args... args) {
        return xp_bf16 ? run_as<bf16>(args...) : run_as<float>(args...);
    }
};

template <int H, typename E>
struct TmStepBackward {
    template <typename S>
    static cudaError_t run_as(const void* x_proj, const float* h0, const float* c0,
                              const float* w_hh, const void* outs, const void* cseq,
                              const void* g_outs, const float* dh_in, const float* dc_in,
                              void* dx_proj, float* dh_out, float* dc_out, float* dw_hh,
                              void* dg, float* dw_part, int t, int T, int B, int splits,
                              cudaStream_t stream) {
        return run_backward_steps<H, E, S, XP>(
            x_proj, h0, c0, nullptr, nullptr, nullptr, w_hh, nullptr, outs, cseq, g_outs,
            dh_in, dc_in, dh_out, dc_out, nullptr, nullptr, dw_hh, nullptr, dx_proj, nullptr,
            dg, dw_part, nullptr, nullptr, nullptr, t, t + 1, T, B, 0, splits, 0,
            (B + BT - 1) / BT, stream);
    }
    template <typename... Args>
    static cudaError_t run(int xp_bf16, Args... args) {
        return xp_bf16 ? run_as<bf16>(args...) : run_as<float>(args...);
    }
};

}  // namespace

extern "C" {

// feats: (T, B, F) in the compute dtype (bf16 when cdt_bf16, else f32);
// h0, c0: (B, H); w_enc: (F, H); b_enc: (H,); w_ih, w_hh: (H, 4H); b:
// (4H,), all f32. Writes outs and, unless it is null, cseq (T, B, H) in
// the compute dtype, hT and cT (B, H) f32.
int lstm_enc2_forward(const void* feats, const float* h0, const float* c0,
                      const float* w_enc, const float* b_enc, const float* w_ih,
                      const float* w_hh, const float* b, void* outs, void* cseq, float* hT,
                      float* cT, int T, int B, int F, int H, int cdt_bf16,
                      cudaStream_t stream) {
    if (T <= 0 || B <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
    if (!aligned16(w_ih) || !aligned16(w_hh)) return (int)cudaErrorMisalignedAddress;
    return dispatch<Enc2Forward>(H, cdt_bf16, feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b,
                                 outs, cseq, hT, cT, T, B, F, stream);
}

// The four encoder-fused backwards (enc2, enc3, enc4, enc6): the arguments
// of lstm_enc.cu's lstm_enc_backward, with D == H. Inputs as the
// forward's plus its outs and cseq and the gradients g_outs (T, B, H,
// compute dtype), g_hT and g_cT (B, H, f32). Writes dh0, dc0 (B, H), dwe
// (F + 1, H): dW_enc, then db_enc, dw = [dW_ih; dW_hh] (2H, 4H) and db
// (4H,), f32.
// Scratch: xs and dpre (T, B, H) and dg (T, B, 4H) in the compute dtype;
// dw_part (splits_w, 2H, 4H) and db_part (part_rows, 4H) f32, part_rows =
// ceil(B / 64) in bf16 and in f32 ceil(B / 32), for enc6 ceil(B / 64);
// dwe_part (splits_e, F + 1, H) in bf16, (splits_e, F, H) in f32; f32 only
// (null in bf16): dbe_part (part_rows, H); pre: in bf16 the P slab (as
// lstm_enc_backward's) f32, in f32 enc3's and enc6's activations slab (T,
// B, 4H) f32, else null; bf16 only (null in f32): w16 (2H * 4H + 4H * H +
// B * H + F * H) bf16. phases: 4 runs the whole backward; in bf16, 1 .. 3
// stop after the encoder and the pre-pass, the loop or dpre (to time
// them).
#define TC_BACKWARD(NAME, MODE)                                                             \
    int NAME(const void* feats, const float* h0, const float* c0, const float* w_enc,       \
             const float* b_enc, const float* w_ih, const float* w_hh, const float* b,      \
             const void* outs, const void* cseq, const void* g_outs, const float* g_hT,     \
             const float* g_cT, float* dh0, float* dc0, float* dwe, float* dw, float* db,   \
             void* xs, void* dpre, void* dg, float* dw_part, float* db_part,                \
             float* dwe_part, float* dbe_part, void* pre, void* w16, int T, int B, int F,   \
             int D, int H, int cdt_bf16, int splits_w, int splits_e, int part_rows,         \
             int phases, cudaStream_t stream) {                                             \
        if (T <= 0 || B <= 0 || F <= 0 || D != H) return (int)cudaErrorInvalidValue;        \
        if (!aligned16(w_ih) || !aligned16(w_hh)) return (int)cudaErrorMisalignedAddress;   \
        return dispatch<TcBackward<MODE>::Of>(                                              \
            H, cdt_bf16, feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b, outs, cseq, g_outs,    \
            g_hT, g_cT, dh0, dc0, dwe, dw, db, xs, dpre, dg, dw_part, db_part, dwe_part,    \
            dbe_part, pre, w16, T, B, F, splits_w, splits_e, part_rows, phases, stream);    \
    }

TC_BACKWARD(lstm_enc2_backward, ENC2)
TC_BACKWARD(lstm_enc3_backward, ENC3)
TC_BACKWARD(lstm_enc4_backward, ENC4)
TC_BACKWARD(lstm_enc6_backward, ENC6)
#undef TC_BACKWARD

// Registers and spilled bytes per thread of the archive's own bf16
// kernels at hidden size H (tc_usage): six ints into out.
int lstm_archive_tc_usage(int H, int* out) {
    switch (H) {
        case 32: return (int)tc_usage<32>(out);
        case 64: return (int)tc_usage<64>(out);
        case 128: return (int)tc_usage<128>(out);
    }
    return (int)cudaErrorInvalidValue;
}

// Step t of the time-major forward, over the whole batch. x_proj:
// (T, B, 4H), bf16 when xp_bf16, else f32; h_in, c_in: the state before
// step t (h0, c0 at t = 0), h_out, c_out: the state after it, other
// buffers than h_in, c_in, all (B, H) f32; w_hh: (H, 4H) f32. Writes row t
// of outs and cseq (T, B, H) in the compute dtype.
int lstm_tm_step_forward(const void* x_proj, const float* h_in, const float* c_in,
                         const float* w_hh, void* outs, void* cseq, float* h_out,
                         float* c_out, int t, int T, int B, int H, int cdt_bf16,
                         int xp_bf16, cudaStream_t stream) {
    if (B <= 0 || t < 0 || t >= T || !cseq || h_in == h_out || c_in == c_out)
        return (int)cudaErrorInvalidValue;
    if (!aligned16(w_hh)) return (int)cudaErrorMisalignedAddress;
    return dispatch<TmStepForward>(H, cdt_bf16, xp_bf16, x_proj, h_in, c_in, w_hh, outs,
                                   cseq, h_out, c_out, t, B, stream);
}

// Step t of the time-major backward, over the whole batch. x_proj, h0, c0,
// w_hh, outs, cseq as the forward's whole arrays; g_outs (T, B, H, compute
// dtype); dh_in, dc_in: the gradients that enter step t (g_hT, g_cT at
// t = T - 1), dh_out, dc_out: those that leave it (dh0, dc0 at t = 0),
// other buffers than dh_in, dc_in, all (B, H) f32. Writes row t of dx_proj
// (T, B, 4H, x_proj's dtype) and, at t = 0, dw_hh (H, 4H) from the dgates
// of every step. Scratch: dw_part (splits, H, 4H) f32, and dg (T, B, 4H)
// in the compute dtype, which is null unless x_proj is bf16 and the
// compute dtype f32.
int lstm_tm_step_backward(const void* x_proj, const float* h0, const float* c0,
                          const float* w_hh, const void* outs, const void* cseq,
                          const void* g_outs, const float* dh_in, const float* dc_in,
                          void* dx_proj, float* dh_out, float* dc_out, float* dw_hh,
                          void* dg, float* dw_part, int t, int T, int B, int H,
                          int cdt_bf16, int xp_bf16, int splits, cudaStream_t stream) {
    if (B <= 0 || t < 0 || t >= T || dh_in == dh_out || dc_in == dc_out)
        return (int)cudaErrorInvalidValue;
    if (!aligned16(w_hh)) return (int)cudaErrorMisalignedAddress;
    return dispatch<TmStepBackward>(H, cdt_bf16, xp_bf16, x_proj, h0, c0, w_hh, outs, cseq,
                                    g_outs, dh_in, dc_in, dx_proj, dh_out, dc_out, dw_hh,
                                    dg, dw_part, t, T, B, splits, stream);
}

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
