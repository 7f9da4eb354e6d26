// LSTM time scan with the encoder outside, forward and backward, for
// Hopper (sm_90a).
//
// Replaces the TPU kernels of pufferlib_tpu/ops/pallas/lstm_cat.py
// (lstm_scan_cat): the forward `_impl` / `_fwd_kernel` and the backward
// `_bwd` / `_bwd_kernel`. Same function as the plain
// pufferlib_tpu_torch.ops.cuda.lstm_cat.lstm_cat_reference and
// lstm_cat_backward_reference: gates = [x_t | h] @ [W_ih; W_hh] + b, one
// f32 sum over K = D + H on operands rounded to the compute dtype, then
// the bias; h and c carried in f32, outs / cseq / dx / the dgates
// operands in the compute dtype, db from the unrounded dgates.
//
// Bound: at the bench shapes (T = 16, B = 8192, D = H = 128, bf16) the
// forward does 2*T*B*(D+H)*4H = 34.4 GFLOP against about 70 MB of
// sequences, and the backward about three times that (gate recompute,
// [dx | dh_prev] and dW, 103 GFLOP) against about 240 MB: the forward sits
// at the crossover of bytes and bf16 tensor-core operations (about 0.035
// ms), the backward is bound by operations (about 0.10 ms).
//
// Design, chosen by the compute dtype, the only branch:
// * bf16: csrc/lstm_tc.cuh in mode CAT, every product on the tensor
//   cores: x @ W_ih as a GEMM over all T*B rows into an f32 slab that the
//   loop's accumulators start from, h @ W_hh onto it with W_hh held in
//   shared memory, then the bias; the backward's gate recompute, dx and
//   dW as GEMMs around a reverse loop that keeps only dg_t @ W_hh^T. The
//   input width D is free (a multiple of 8, up to what a GEMM block's
//   shared memory holds). The loops and the slab are lstm_scan_fused's,
//   which differs only in where the bias enters the sum.
// * f32: mode CAT of csrc/lstm_common.cuh on FMA, D == H: f32 is the
//   exact test mode, and the tensor cores have no exact f32 product. One
//   block per 32 batch rows walks the time loop, streaming the (D+H, 4H)
//   weights from L2 in chunks; the weight gradients are split-K
//   contractions whose partial sums a second pass adds in a fixed order.
#include "lstm_common.cuh"
#include "lstm_tc.cuh"

namespace {

template <int H, typename E>
struct Forward : lstm::tc::CellForward<lstm::CAT, H, E> {};

template <int H, typename E>
struct Backward : lstm::tc::CellBackward<lstm::CAT, H, E> {};

}  // namespace

extern "C" {

// x: (T, B, D) in the compute dtype (bf16 when cdt_bf16, else f32);
// h0, c0: (B, H); w_ih: (D, 4H), w_hh: (H, 4H); b: (4H,), all f32. Writes
// outs and, unless it is null, cseq (T, B, H) in the compute dtype, hT
// and cT (B, H) f32. Scratch, bf16 only (null in f32): xw (T * 64
// ceil(B / 64) * 4H) f32, the slab of lstm_tc.cuh, and w16 ((D + H) *
// 4H) bf16. f32 takes D == H. phases: 2 runs the whole forward; in bf16, 1
// stops after the pre-pass (to time it).
int lstm_cat_forward(const void* x, const float* h0, const float* c0,
                     const float* w_ih, const float* w_hh, const float* b, void* outs,
                     void* cseq, float* hT, float* cT, float* xw, void* w16, int T, int B,
                     int D, int H, int cdt_bf16, int phases, cudaStream_t stream) {
    if (T <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
    if (!lstm::aligned16(w_ih) || !lstm::aligned16(w_hh))
        return (int)cudaErrorMisalignedAddress;
    if (cdt_bf16 && (!xw || !w16)) return (int)cudaErrorInvalidValue;
    return lstm::dispatch<Forward>(H, cdt_bf16, x, h0, c0, w_ih, w_hh, b, outs, cseq, hT,
                                   cT, xw, w16, T, B, D, phases, stream);
}

// Inputs as the forward's plus its outs and cseq and the gradients g_outs
// (T, B, H, compute dtype), g_hT and g_cT (B, H, f32). Writes dx (T, B, D,
// compute dtype), dh0, dc0 (B, H), dw = [dW_ih; dW_hh] (D + H, 4H) and db
// (4H,), f32. Scratch: dg (T, B, 4H) compute dtype, dw_part (splits,
// D + H, 4H) and db_part (part_rows, 4H) f32, part_rows = ceil(B / 64) in
// bf16 and ceil(B / 32) in f32; bf16 only (null in f32): pre (as the
// forward's xw) f32 and w16 ((D + H) * 4H + 4H * D + B * H) bf16. phases:
// 4 runs the whole backward; in bf16, 1 .. 3 stop after the pre-pass, the
// loop or dx (to time them).
int lstm_cat_backward(const void* x, const float* h0, const float* c0,
                      const float* w_ih, const float* w_hh, const float* b,
                      const void* outs, const void* cseq, const void* g_outs,
                      const float* g_hT, const float* g_cT, void* dx, float* dh0,
                      float* dc0, float* dw, float* db, void* dg, float* dw_part,
                      float* db_part, float* pre, void* w16, int T, int B, int D, int H,
                      int cdt_bf16, int splits, int part_rows, int phases,
                      cudaStream_t stream) {
    if (T <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
    if (!lstm::aligned16(w_ih) || !lstm::aligned16(w_hh))
        return (int)cudaErrorMisalignedAddress;
    if (cdt_bf16 && (!pre || !w16)) return (int)cudaErrorInvalidValue;
    return lstm::dispatch<Backward>(H, cdt_bf16, x, h0, c0, w_ih, w_hh, b, outs, cseq,
                                    g_outs, g_hT, g_cT, dx, dh0, dc0, dw, db, dg, dw_part,
                                    db_part, pre, w16, T, B, D, splits, part_rows, phases,
                                    stream);
}

// Registers and spilled bytes per thread of the bf16 kernels of the cat
// pair at hidden size H (lstm::tc::usage): ten ints into out.
int lstm_cat_tc_usage(int H, int* out) { return lstm::tc::usage_at<lstm::CAT>(H, out); }

// The widest input width the bf16 kernels of cat and fused take at hidden
// size H (lstm::tc::serves), into *out: the limit that
// lstm_common.tc_max_input computes for the checks made before a launch.
int lstm_tc_max_input(int H, int* out) {
    int D = 0;
    while (lstm::tc::serves(D + 8, H)) D += 8;
    *out = D;
    return 0;
}

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
