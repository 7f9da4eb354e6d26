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
// Bound: at the bench shapes (T = 16, B = 8192, D = H = 128) the forward
// does 2*T*B*(D+H)*4H = 34.4 GFLOP against about 70 MB of sequences, and
// the backward about three times that (gate recompute, [dx | dh_prev] and
// dW, 103 GFLOP) against about 240 MB. In bf16 the forward sits at the
// crossover of bytes and tensor-core operations (about 0.035 ms), the
// backward is bound by operations (about 0.10 ms); in f32, on FMA at 67
// TFLOP/s, both are bound by operations (0.513 and 1.539 ms).
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
// * f32, the default compute dtype of both packages (exact: no TF32, the
//   tensor cores have no exact f32 product): csrc/lstm_f32.cuh, enc5's f32
//   design without the encoder, D == H, at hidden sizes 32 to 128 and (cat
//   alone of the families) 256, whose loops run clusters of 8 blocks of 32
//   units. x @ W_ih, the backward's gate
//   recompute, dx and the weight gradients are FMA SGEMMs over all T*B
//   rows; the time loops keep W_hh on chip for all T steps in a thread
//   block cluster, whose blocks exchange h (forward) or the partial
//   dh_prev (backward) through distributed shared memory. Each of the
//   forward's sums is x over k < D from zero, then h, then b, the TPU
//   kernel's one sum over K = D + H in order. The backward takes
//   the forward's x @ W_ih slab again (autograd keeps it: T * B * 4H f32,
//   268 MB at the bench shape) and its gate recompute continues those sums
//   over h_prev @ W_hh alone, the same chains; it sums dx and the weight
//   gradients in the SGEMMs' fixed orders (split-K partials and db's tile
//   partials added in order, no atomics).
#include "lstm_common.cuh"
#include "lstm_f32.cuh"
#include "lstm_tc.cuh"

namespace {

// The compute dtype is the only branch: bf16 on lstm_tc.cuh, f32 on
// lstm_f32.cuh (D == H)
template <int H, typename E>
struct Forward : std::conditional_t<std::is_same<E, lstm::bf16>::value,
                                    lstm::tc::CellForward<lstm::CAT, H>,
                                    lstm::f32::CellForward<H, false>> {};

template <int H, typename E>
struct Backward : std::conditional_t<std::is_same<E, lstm::bf16>::value,
                                     lstm::tc::CellBackward<lstm::CAT, H>,
                                     lstm::f32::CellBackward<H, false>> {};

// the hidden sizes of the f32 pair: every family's, and 256 on clusters
// of 8 blocks (lstm_f32.cuh LoopConfigs)
using F32Hidden = lstm::Hidden<32, 64, 128, 256>;

}  // namespace

extern "C" {

// x: (T, B, D) in the compute dtype (bf16 when cdt_bf16, else f32);
// h0, c0: (B, H); w_ih: (D, 4H), w_hh: (H, 4H); b: (4H,), all f32. Writes
// outs and, unless it is null, cseq (T, B, H) in the compute dtype, hT
// and cT (B, H) f32. Scratch: bf16, xw (T * 64 ceil(B / 64) * 4H) f32,
// the slab of lstm_tc.cuh, and w16 ((D + H) * 4H) bf16; f32
// (lstm_f32.cuh, D == H), xw (T * B * 4H) f32, x @ W_ih, which the
// backward takes again, and a null w16.
// phases: 2 runs the whole forward, 1 stops after the pre-pass (to time
// it).
int lstm_cat_forward(const void* x, const float* h0, const float* c0,
                     const float* w_ih, const float* w_hh, const float* b, void* outs,
                     void* cseq, float* hT, float* cT, float* xw, void* w16, int T, int B,
                     int D, int H, int cdt_bf16, int phases, cudaStream_t stream) {
    if (T <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
    if (!lstm::aligned16(w_ih) || !lstm::aligned16(w_hh))
        return (int)cudaErrorMisalignedAddress;
    if (!xw || (cdt_bf16 && !w16)) return (int)cudaErrorInvalidValue;
    return lstm::dispatch<Forward, F32Hidden>(H, cdt_bf16, x, h0, c0, w_ih, w_hh, b, outs,
                                              cseq, hT, cT, xw, w16, T, B, D, phases, stream);
}

// Inputs as the forward's plus its outs and cseq and the gradients g_outs
// (T, B, H, compute dtype), g_hT and g_cT (B, H, f32). Writes dx (T, B, D,
// compute dtype), dh0, dc0 (B, H), dw = [dW_ih; dW_hh] (D + H, 4H) and db
// (4H,), f32. Scratch: dg (T, B, 4H) compute dtype, dw_part (splits,
// D + H, 4H) and db_part (part_rows, 4H) f32, part_rows = ceil(B / 64) in
// bf16 and ceil(B / 32) in f32 (the f32 loops' smallest tile); pre: bf16
// as the forward's xw, f32 the activations (T * B * 4H) then W_ih^T and
// W_hh^T (4H * (D + H)). aux: bf16, scratch for the weights and h0 in
// bf16 ((D + H) * 4H + 4H * D + B * H); f32, the forward's xw, x @ W_ih,
// an input (the gate recompute starts from it). phases: 4 runs the whole
// backward; 1 .. 3 stop after the pre-pass, the loop or dx (to time
// them).
int lstm_cat_backward(const void* x, const float* h0, const float* c0,
                      const float* w_ih, const float* w_hh, const float* b,
                      const void* outs, const void* cseq, const void* g_outs,
                      const float* g_hT, const float* g_cT, void* dx, float* dh0,
                      float* dc0, float* dw, float* db, void* dg, float* dw_part,
                      float* db_part, float* pre, void* aux, int T, int B, int D, int H,
                      int cdt_bf16, int splits, int part_rows, int phases,
                      cudaStream_t stream) {
    if (T <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
    if (!lstm::aligned16(w_ih) || !lstm::aligned16(w_hh))
        return (int)cudaErrorMisalignedAddress;
    if (!pre || !aux) return (int)cudaErrorInvalidValue;
    return lstm::dispatch<Backward, F32Hidden>(H, cdt_bf16, x, h0, c0, w_ih, w_hh, b, outs,
                                               cseq, g_outs, g_hT, g_cT, dx, dh0, dc0, dw, db,
                                               dg, dw_part, db_part, pre, aux, T, B, D, splits,
                                               part_rows, phases, stream);
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

// Registers and spilled bytes per thread of cat's f32 kernels at hidden
// size H (lstm::f32::usage without the encoder's): sixteen ints into out.
int lstm_cat_f32_usage(int H, int* out) {
    switch (H) {
        case 32: return (int)lstm::f32::usage<32, false>(out);
        case 64: return (int)lstm::f32::usage<64, false>(out);
        case 128: return (int)lstm::f32::usage<128, false>(out);
        case 256: return (int)lstm::f32::usage<256, false>(out);
    }
    return (int)cudaErrorInvalidValue;
}

// The tilings cat's f32 loops take at B batch rows (lstm::f32::loop_plan):
// forward then backward, each (units a block, rows a thread, clusters the
// card holds at once); six ints into out.
int lstm_cat_f32_plan(int H, int B, int* out) {
    switch (H) {
        case 32: return (int)lstm::f32::loop_plan<32>(B, out);
        case 64: return (int)lstm::f32::loop_plan<64>(B, out);
        case 128: return (int)lstm::f32::loop_plan<128>(B, out);
        case 256: return (int)lstm::f32::loop_plan<256>(B, out);
    }
    return (int)cudaErrorInvalidValue;
}

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
