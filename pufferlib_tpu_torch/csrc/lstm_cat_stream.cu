// LSTM time scan with the encoder outside, forward and backward, for
// Hopper (sm_90a): the second design of the cat pair, for the shapes the
// resident-weight kernels of lstm_cat.cu refuse.
//
// Replaces the TPU kernels of pufferlib_tpu/ops/pallas/lstm_cat.py
// (lstm_scan_cat: the forward `_impl` / `_fwd_kernel` and the backward
// `_bwd` / `_bwd_kernel`) wherever lstm_cat.cu cannot hold the weights:
// hidden sizes past 128, input widths the tensor-core kernels refuse in
// bf16, and any input width apart from the hidden size in f32. Same
// function as pufferlib_tpu_torch.ops.cuda.lstm_cat.lstm_cat_reference and
// lstm_cat_backward_reference: gates = [x_t | h] @ [W_ih; W_hh] + b, one
// f32 sum over K = D + H on operands rounded to the compute dtype, then
// the bias; h and c carried in f32, outs / cseq / dx / the dgates operands
// in the compute dtype, db from the unrounded dgates.
//
// Bound: at the Atari update's shape (T = 16, B = 256, D = H = 512) the
// forward does 2*T*B*(D+H)*4H = 17.2 GFLOP against 17 MB (f32 weights
// 8.4 MB, sequences 8.4 MB): bound by operations, 0.26 ms at the f32
// rate, 0.017 ms at the bf16 tensor-core rate; the backward three times
// the operations (gate recompute, [dx | dh_prev], dW).
//
// Design (simple, right first; at H = 512 the f32 [W_ih; W_hh] alone is
// 8 MiB, so no design that keeps the weights in one block's shared memory
// serves it):
// * forward: one launch per time step. A block owns 32 batch rows and 32
//   hidden units with all four of their gate columns, so the cell update
//   is local: it sums [x_t | h_prev] @ W over K = D + H through 16-deep
//   shared-memory tiles (the weights stream from L2, 2-8 MiB, which stays
//   resident in the 50 MB L2), adds the bias, and updates c and h. h_prev
//   is read back from the stored outs (h rounded to the compute dtype is
//   exactly the stored value), c from cT, which carries c in f32.
// * backward, per reverse step: the same tile recomputes the gates and
//   writes the dgates (rounded) and each block's column sums of the
//   unrounded dgates; a second launch takes dh_prev = dgates @ W_hh^T,
//   which needs every unit's dgates. After the loop dx = dgates @ W_ih^T
//   and dW = [x | h_prev]^T @ dgates run as tiled GEMMs over all T*B rows,
//   and a last pass adds the db partial sums in order.
// * every product on the FMA units (f32 accumulation of operands rounded
//   to the compute dtype), every sum in a fixed order, no atomics: two
//   runs are equal bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int BK = 16;   // depth of a shared-memory tile
constexpr int RB = 32;   // batch rows of a cell block
constexpr int UB = 32;   // hidden units of a cell block (4 * UB gate columns)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename E>
__device__ __forceinline__ E from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

// v rounded to the compute dtype E, carried in f32
template <typename E>
__device__ __forceinline__ float rnd(float v) { return to_f(from_f<E>(v)); }

__device__ __forceinline__ float sigm(float x) { return 1.f / (1.f + expf(-x)); }

// One time step of the cell: the inputs of the gate sum, and what the
// forward or the backward epilogue reads and writes.
template <typename E>
struct Step {
    const E* x;          // (B, D): x_t
    const float* h0;     // (B, H): h_prev at t == 0 (f32, rounded on load), else null
    const E* h_prev;     // (B, H): outs[t-1] at t > 0
    const float* w_ih;   // (D, 4H)
    const float* w_hh;   // (H, 4H)
    const float* b;      // (4H,)
    // forward
    const float* c_in;   // (B, H): c0 at t == 0, else cT
    float* c_out;        // (B, H): cT
    E* outs;             // (B, H): outs[t]
    E* cseq;             // (B, H): cseq[t], or null
    float* hT;           // (B, H): at the last step, else null
    // backward
    const float* dh_in;  // (B, H): g_hT at t == T-1, else dh0 (the carry)
    const E* g_out;      // (B, H): g_outs[t]
    const float* dc_in;  // (B, H): g_cT at t == T-1, else dc0 (the carry)
    float* dc_out;       // (B, H): dc0
    const E* c_t;        // (B, H): cseq[t]
    const E* c_prev;     // (B, H): cseq[t-1] at t > 0
    const float* c0;     // (B, H): c_prev at t == 0
    E* dg;               // (B, 4H): the rounded dgates of step t
    float* db_part;      // (ceil(B / RB), 4H): this step's column sums
    int B, D, H;
};

// acc[i][j][g] = sum over k < D + H of [x_t | h_prev](row i, k) * W(k,
// gate g of unit j), rows row0 + 2 ty + i, units unit0 + 2 tx + j, k in
// order. The operands are rounded to E as they are loaded.
template <typename E>
__device__ __forceinline__ void cell_gates(const Step<E>& s, int row0, int unit0,
                                           float acc[2][2][4]) {
    __shared__ float As[BK][RB + 1];
    __shared__ float Ws[BK][4 * UB];
    const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
    const int D = s.D, H = s.H, K = D + H, G = 4 * H;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int g = 0; g < 4; ++g) acc[i][j][g] = 0.f;
    for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
        for (int i = 0; i < RB * BK / THREADS; ++i) {
            const int idx = tid + i * THREADS, k = idx % BK, r = idx / BK;
            const int row = row0 + r, kk = k0 + k;
            float v = 0.f;
            if (row < s.B && kk < K) {
                if (kk < D) v = to_f(s.x[(size_t)row * D + kk]);
                else if (s.h0) v = rnd<E>(s.h0[(size_t)row * H + kk - D]);
                else v = to_f(s.h_prev[(size_t)row * H + kk - D]);
            }
            As[k][r] = v;
        }
#pragma unroll
        for (int i = 0; i < 4 * UB * BK / THREADS; ++i) {
            const int idx = tid + i * THREADS, c = idx % (4 * UB), k = idx / (4 * UB);
            const int kk = k0 + k, col = (c / UB) * H + unit0 + c % UB;
            float v = 0.f;
            if (kk < K)
                v = rnd<E>(kk < D ? s.w_ih[(size_t)kk * G + col]
                                  : s.w_hh[(size_t)(kk - D) * G + col]);
            Ws[k][c] = v;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < BK; ++k) {
            const float a0 = As[k][2 * ty], a1 = As[k][2 * ty + 1];
#pragma unroll
            for (int g = 0; g < 4; ++g) {
                const float w0 = Ws[k][g * UB + 2 * tx], w1 = Ws[k][g * UB + 2 * tx + 1];
                acc[0][0][g] = fmaf(a0, w0, acc[0][0][g]);
                acc[0][1][g] = fmaf(a0, w1, acc[0][1][g]);
                acc[1][0][g] = fmaf(a1, w0, acc[1][0][g]);
                acc[1][1][g] = fmaf(a1, w1, acc[1][1][g]);
            }
        }
        __syncthreads();
    }
}

template <typename E>
__global__ void __launch_bounds__(THREADS) cell_forward(Step<E> s) {
    const int row0 = blockIdx.y * RB, unit0 = blockIdx.x * UB;
    float acc[2][2][4];
    cell_gates(s, row0, unit0, acc);
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16, H = s.H;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int row = row0 + 2 * ty + i;
        if (row >= s.B) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            const int unit = unit0 + 2 * tx + j;
            const size_t at = (size_t)row * H + unit;
            const float ig = sigm(acc[i][j][0] + s.b[unit]);
            const float fg = sigm(acc[i][j][1] + s.b[H + unit]);
            const float gg = tanhf(acc[i][j][2] + s.b[2 * H + unit]);
            const float og = sigm(acc[i][j][3] + s.b[3 * H + unit]);
            const float c = fg * s.c_in[at] + ig * gg;
            const float h = og * tanhf(c);
            s.outs[at] = from_f<E>(h);
            if (s.cseq) s.cseq[at] = from_f<E>(c);
            s.c_out[at] = c;
            if (s.hT) s.hT[at] = h;
        }
    }
}

template <typename E>
__global__ void __launch_bounds__(THREADS) cell_backward(Step<E> s) {
    __shared__ float part[RB][4 * UB];
    const int row0 = blockIdx.y * RB, unit0 = blockIdx.x * UB;
    float acc[2][2][4];
    cell_gates(s, row0, unit0, acc);
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16, H = s.H, G = 4 * H;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int r = 2 * ty + i, row = row0 + r;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            const int u = 2 * tx + j, unit = unit0 + u;
            float d[4] = {0.f, 0.f, 0.f, 0.f};
            if (row < s.B) {
                const size_t at = (size_t)row * H + unit;
                const float ig = sigm(acc[i][j][0] + s.b[unit]);
                const float fg = sigm(acc[i][j][1] + s.b[H + unit]);
                const float gg = tanhf(acc[i][j][2] + s.b[2 * H + unit]);
                const float og = sigm(acc[i][j][3] + s.b[3 * H + unit]);
                const float dh = s.dh_in[at] + to_f(s.g_out[at]);
                const float ct = to_f(s.c_t[at]);
                const float cp = s.c0 ? s.c0[at] : to_f(s.c_prev[at]);
                const float tc = tanhf(ct);
                const float dout = dh * tc;
                const float dc = s.dc_in[at] + dh * og * (1.f - tc * tc);
                const float di = dc * gg, dgg = dc * ig, df = dc * cp;
                d[0] = di * ig * (1.f - ig);
                d[1] = df * fg * (1.f - fg);
                d[2] = dgg * (1.f - gg * gg);
                d[3] = dout * og * (1.f - og);
                s.dc_out[at] = dc * fg;
#pragma unroll
                for (int g = 0; g < 4; ++g)
                    s.dg[(size_t)row * G + g * H + unit] = from_f<E>(d[g]);
            }
#pragma unroll
            for (int g = 0; g < 4; ++g) part[r][g * UB + u] = d[g];
        }
    }
    __syncthreads();
    // this block's column sums of the unrounded dgates, rows in order
    if (threadIdx.x < 4 * UB) {
        const int c = threadIdx.x;
        float sum = 0.f;
        for (int r = 0; r < RB; ++r) sum += part[r][c];
        s.db_part[(size_t)blockIdx.y * G + (c / UB) * H + unit0 + c % UB] = sum;
    }
}

// C (M, N) = sum over k of A(m, k) * Bm(k, n), k in order, in tiles of
// 16 TM x 16 TN with 16-deep shared-memory tiles; 256 threads, each TM x
// TN outputs strided by 16. The loaders say which of their indices runs
// along memory (kFast) so that neighbouring threads load neighbouring
// addresses.
template <int TM, int TN, class LA, class LB, class ST>
__global__ void __launch_bounds__(THREADS) gemm(LA la, LB lb, ST st, int M, int N, int K) {
    constexpr int BM = 16 * TM, BN = 16 * TN;
    __shared__ float As[BK][BM + 1];
    __shared__ float Bs[BK][BN + 1];
    const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
    const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
        for (int i = 0; i < BM * BK / THREADS; ++i) {
            const int idx = tid + i * THREADS;
            const int k = LA::kFast ? idx % BK : idx / BM;
            const int m = LA::kFast ? idx / BK : idx % BM;
            As[k][m] = (m0 + m < M && k0 + k < K) ? la(m0 + m, k0 + k) : 0.f;
        }
#pragma unroll
        for (int i = 0; i < BN * BK / THREADS; ++i) {
            const int idx = tid + i * THREADS;
            const int k = LB::kFast ? idx % BK : idx / BN;
            const int n = LB::kFast ? idx / BK : idx % BN;
            Bs[k][n] = (n0 + n < N && k0 + k < K) ? lb(k0 + k, n0 + n) : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < BK; ++k) {
            float a[TM], bv[TN];
#pragma unroll
            for (int i = 0; i < TM; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < TN; ++j) bv[j] = Bs[k][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
            if (m < M && n < N) st(m, n, acc[i][j]);
        }
}

// A (M, K) row-major in the compute dtype: the dgates
template <typename E>
struct RowsOf {
    static constexpr bool kFast = true;
    const E* p;
    int ld;
    __device__ float operator()(int m, int k) const { return to_f(p[(size_t)m * ld + k]); }
};

// Bm(k, n) = W[n][k] rounded to E, W (N, K) row-major f32: W^T
template <typename E>
struct WeightT {
    static constexpr bool kFast = true;
    const float* w;
    int ld;
    __device__ float operator()(int k, int n) const { return rnd<E>(w[(size_t)n * ld + k]); }
};

// A(m, r) = [x | h_prev](row r, column m): the operand rows of every step,
// transposed; r = t * B + b
template <typename E>
struct OperandsT {
    static constexpr bool kFast = false;
    const E* x;
    const float* h0;
    const E* outs;
    int B, D, H;
    __device__ float operator()(int m, int r) const {
        if (m < D) return to_f(x[(size_t)r * D + m]);
        if (r < B) return rnd<E>(h0[(size_t)r * H + m - D]);
        return to_f(outs[(size_t)(r - B) * H + m - D]);
    }
};

// Bm(r, n): the dgates, (T * B, 4H) row-major
template <typename E>
struct DgatesRows {
    static constexpr bool kFast = false;
    const E* p;
    int ld;
    __device__ float operator()(int r, int n) const { return to_f(p[(size_t)r * ld + n]); }
};

template <typename O>
struct Store {
    O* p;
    int ld;
    __device__ void operator()(int m, int n, float v) const { p[(size_t)m * ld + n] = from_f<O>(v); }
};

// db[c] = sum over rows of db_part, in row order
__global__ void column_sums(const float* __restrict__ part, float* __restrict__ out, int rows,
                            int cols) {
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= cols) return;
    float sum = 0.f;
    for (int r = 0; r < rows; ++r) sum += part[(size_t)r * cols + c];
    out[c] = sum;
}

int blocks_of(int n, int per) { return (n + per - 1) / per; }

// tiles of 64 x 64 where they fill the card, else 32 x 32
template <class LA, class LB, class ST>
cudaError_t launch_gemm(LA la, LB lb, ST st, int M, int N, int K, cudaStream_t stream) {
    if ((long)blocks_of(M, 64) * blocks_of(N, 64) >= 132) {
        dim3 grid(blocks_of(N, 64), blocks_of(M, 64));
        gemm<4, 4><<<grid, THREADS, 0, stream>>>(la, lb, st, M, N, K);
    } else {
        dim3 grid(blocks_of(N, 32), blocks_of(M, 32));
        gemm<2, 2><<<grid, THREADS, 0, stream>>>(la, lb, st, M, N, K);
    }
    return cudaGetLastError();
}

template <typename E>
int forward(const E* x, const float* h0, const float* c0, const float* w_ih, const float* w_hh,
            const float* b, E* outs, E* cseq, float* hT, float* cT, int T, int B, int D, int H,
            cudaStream_t stream) {
    const dim3 grid(H / UB, blocks_of(B, RB));
    const size_t seq = (size_t)B * H;
    for (int t = 0; t < T; ++t) {
        Step<E> s{};
        s.x = x + (size_t)t * B * D;
        s.h0 = t == 0 ? h0 : nullptr;
        s.h_prev = t == 0 ? nullptr : outs + (t - 1) * seq;
        s.w_ih = w_ih;
        s.w_hh = w_hh;
        s.b = b;
        s.c_in = t == 0 ? c0 : cT;
        s.c_out = cT;
        s.outs = outs + t * seq;
        s.cseq = cseq ? cseq + t * seq : nullptr;
        s.hT = t == T - 1 ? hT : nullptr;
        s.B = B;
        s.D = D;
        s.H = H;
        cell_forward<E><<<grid, THREADS, 0, stream>>>(s);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}

template <typename E>
int backward(const E* x, const float* h0, const float* c0, const float* w_ih,
             const float* w_hh, const float* b, const E* outs, const E* cseq, const E* g_outs,
             const float* g_hT, const float* g_cT, E* dx, float* dh0, float* dc0, float* dw,
             float* db, E* dg, float* db_part, int T, int B, int D, int H, cudaStream_t stream) {
    const int G = 4 * H, row_blocks = blocks_of(B, RB);
    const dim3 grid(H / UB, row_blocks);
    const size_t seq = (size_t)B * H;
    for (int t = T - 1; t >= 0; --t) {
        Step<E> s{};
        s.x = x + (size_t)t * B * D;
        s.h0 = t == 0 ? h0 : nullptr;
        s.h_prev = t == 0 ? nullptr : outs + (t - 1) * seq;
        s.w_ih = w_ih;
        s.w_hh = w_hh;
        s.b = b;
        s.dh_in = t == T - 1 ? g_hT : dh0;
        s.g_out = g_outs + t * seq;
        s.dc_in = t == T - 1 ? g_cT : dc0;
        s.dc_out = dc0;
        s.c_t = cseq + t * seq;
        s.c_prev = t == 0 ? nullptr : cseq + (t - 1) * seq;
        s.c0 = t == 0 ? c0 : nullptr;
        s.dg = dg + (size_t)t * B * G;
        s.db_part = db_part + (size_t)t * row_blocks * G;
        s.B = B;
        s.D = D;
        s.H = H;
        cell_backward<E><<<grid, THREADS, 0, stream>>>(s);
        cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        // dh_prev = dgates_t @ W_hh^T, every unit's dgates in
        err = launch_gemm(RowsOf<E>{s.dg, G}, WeightT<E>{w_hh, G}, Store<float>{dh0, H}, B, H,
                          G, stream);
        if (err != cudaSuccess) return (int)err;
    }
    cudaError_t err = launch_gemm(RowsOf<E>{dg, G}, WeightT<E>{w_ih, G}, Store<E>{dx, D}, T * B,
                                  D, G, stream);
    if (err != cudaSuccess) return (int)err;
    err = launch_gemm(OperandsT<E>{x, h0, outs, B, D, H}, DgatesRows<E>{dg, G},
                      Store<float>{dw, G}, D + H, G, T * B, stream);
    if (err != cudaSuccess) return (int)err;
    column_sums<<<blocks_of(G, THREADS), THREADS, 0, stream>>>(db_part, db, T * row_blocks, G);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (T, B, D) in the compute dtype (bf16 when cdt_bf16, else f32); h0,
// c0: (B, H); w_ih: (D, 4H), w_hh: (H, 4H); b: (4H,), all f32. Writes outs
// and, unless it is null, cseq (T, B, H) in the compute dtype, hT and cT
// (B, H) f32. H a multiple of 32, any D >= 1; T launches.
int lstm_cat_stream_forward(const void* x, const float* h0, const float* c0,
                            const float* w_ih, const float* w_hh, const float* b, void* outs,
                            void* cseq, float* hT, float* cT, int T, int B, int D, int H,
                            int cdt_bf16, cudaStream_t stream) {
    if (T <= 0 || B <= 0 || D <= 0 || H <= 0 || H % UB) return (int)cudaErrorInvalidValue;
    if (cdt_bf16)
        return forward(static_cast<const bf16*>(x), h0, c0, w_ih, w_hh, b,
                       static_cast<bf16*>(outs), static_cast<bf16*>(cseq), hT, cT, T, B, D, H,
                       stream);
    return forward(static_cast<const float*>(x), h0, c0, w_ih, w_hh, b,
                   static_cast<float*>(outs), static_cast<float*>(cseq), hT, cT, T, B, D, H,
                   stream);
}

// Inputs as the forward's plus its outs and cseq and the gradients g_outs
// (T, B, H, compute dtype), g_hT and g_cT (B, H, f32). Writes dx (T, B, D,
// compute dtype), dh0, dc0 (B, H), dw = [dW_ih; dW_hh] (D + H, 4H) and db
// (4H,), f32. Scratch: dg (T, B, 4H) in the compute dtype and db_part
// (T * ceil(B / 32), 4H) f32. 2 T + 3 launches.
int lstm_cat_stream_backward(const void* x, const float* h0, const float* c0,
                             const float* w_ih, const float* w_hh, const float* b,
                             const void* outs, const void* cseq, const void* g_outs,
                             const float* g_hT, const float* g_cT, void* dx, float* dh0,
                             float* dc0, float* dw, float* db, void* dg, float* db_part, int T,
                             int B, int D, int H, int cdt_bf16, cudaStream_t stream) {
    if (T <= 0 || B <= 0 || D <= 0 || H <= 0 || H % UB) return (int)cudaErrorInvalidValue;
    if (cdt_bf16)
        return backward(static_cast<const bf16*>(x), h0, c0, w_ih, w_hh, b,
                        static_cast<const bf16*>(outs), static_cast<const bf16*>(cseq),
                        static_cast<const bf16*>(g_outs), g_hT, g_cT, static_cast<bf16*>(dx),
                        dh0, dc0, dw, db, static_cast<bf16*>(dg), db_part, T, B, D, H, stream);
    return backward(static_cast<const float*>(x), h0, c0, w_ih, w_hh, b,
                    static_cast<const float*>(outs), static_cast<const float*>(cseq),
                    static_cast<const float*>(g_outs), g_hT, g_cT, static_cast<float*>(dx), dh0,
                    dc0, dw, db, static_cast<float*>(dg), db_part, T, B, D, H, stream);
}

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
