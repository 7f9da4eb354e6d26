// LSTM time scan with the encoder outside, forward and backward, for
// Hopper (sm_90a).
//
// Replaces the TPU kernels of pufferlib_tpu/ops/pallas/lstm_cat.py
// (lstm_scan_cat): the forward `_impl` / `_fwd_kernel` and the backward
// `_bwd` / `_bwd_kernel`. Same function as the plain
// pufferlib_tpu_torch.ops.cuda.lstm_cat.lstm_cat_reference and
// lstm_cat_backward_reference: gates = [x_t | h] @ [W_ih; W_hh] + b with
// f32 accumulation on operands rounded to the compute dtype, h and c
// carried in f32, outs / cseq / dx / the dgates operands in the compute
// dtype, db from the unrounded dgates.
//
// Bound: at the bench shapes (T = 16, B = 8192, D = H = 128, bf16) the
// forward does 2*T*B*(D+H)*4H = 34.4 GFLOP against about 70 MB of
// sequences, and the backward about twice that (gate recompute, [dx |
// dh_prev] and dW, 103 GFLOP), against about 240 MB: the forward sits at
// the crossover of bytes and bf16 tensor-core operations (about 0.035
// ms), the backward is bound by operations (about 0.10 ms). The recurrent
// kernels here run plain f32 FMA (67 TFLOP/s peak), some 35-40x above
// that bound; the backward's weight-gradient contraction runs on the
// bf16 tensor cores.
//
// Design (csrc/lstm_common.cuh): one block per 32 batch rows walks the
// sequential time loop; the (D+H, 4H) weights, 256 KiB in f32, do not fit
// a block's shared memory and stream from L2 in chunks each step (the
// backward fetches the next chunk while it works on the current one);
// the weight gradients are split-K contractions over the T*B rows whose
// per-split partial sums a second pass adds in a fixed order.
#include "lstm_common.cuh"

namespace {

template <int H, typename E>
struct Forward {
    static cudaError_t run(const void* x, const float* h0, const float* c0,
                           const float* w_ih, const float* w_hh, const float* b,
                           void* outs, void* cseq, float* hT, float* cT, int T, int B,
                           cudaStream_t stream) {
        return lstm::run_forward<H, E, false>(x, h0, c0, nullptr, nullptr, w_ih, w_hh, b,
                                              outs, cseq, hT, cT, T, B, 0, stream);
    }
};

template <int H, typename E>
struct Backward {
    static cudaError_t run(const void* x, const float* h0, const float* c0,
                           const float* w_ih, const float* w_hh, const float* b,
                           const void* outs, const void* cseq, const void* g_outs,
                           const float* g_hT, const float* g_cT, void* dx, float* dh0,
                           float* dc0, float* dw, float* db, void* dg, float* dw_part,
                           float* db_part, int T, int B, int splits, int part_rows,
                           cudaStream_t stream) {
        return lstm::run_backward<H, E, false>(
            x, h0, c0, nullptr, nullptr, w_ih, w_hh, b, outs, cseq, g_outs, g_hT, g_cT,
            dh0, dc0, nullptr, nullptr, dw, db, dx, nullptr, dg, dw_part, db_part,
            nullptr, nullptr, T, B, 0, splits, 0, part_rows, stream);
    }
};

}  // namespace

extern "C" {

// x: (T, B, H) in the compute dtype (bf16 when cdt_bf16, else f32);
// h0, c0: (B, H); w_ih, w_hh: (H, 4H); b: (4H,), all f32. Writes outs and
// cseq (T, B, H) in the compute dtype, hT and cT (B, H) f32.
int lstm_cat_forward(const void* x, const float* h0, const float* c0,
                     const float* w_ih, const float* w_hh, const float* b, void* outs,
                     void* cseq, float* hT, float* cT, int T, int B, int H, int cdt_bf16,
                     cudaStream_t stream) {
    if (T <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
    if (!lstm::aligned16(w_ih) || !lstm::aligned16(w_hh))
        return (int)cudaErrorMisalignedAddress;
    return lstm::dispatch<Forward>(H, cdt_bf16, x, h0, c0, w_ih, w_hh, b, outs, cseq, hT,
                                   cT, T, B, stream);
}

// Inputs as the forward's plus its outs and cseq and the gradients g_outs
// (T, B, H, compute dtype), g_hT and g_cT (B, H, f32). Writes dx (T, B, H,
// compute dtype), dh0, dc0 (B, H), dw = [dW_ih; dW_hh] (2H, 4H) and db
// (4H,), f32. Scratch: dg (T, B, 4H) compute dtype, dw_part (splits, 2H,
// 4H) and db_part (part_rows = ceil(B / 32), 4H) f32.
int lstm_cat_backward(const void* x, const float* h0, const float* c0,
                      const float* w_ih, const float* w_hh, const float* b,
                      const void* outs, const void* cseq, const void* g_outs,
                      const float* g_hT, const float* g_cT, void* dx, float* dh0,
                      float* dc0, float* dw, float* db, void* dg, float* dw_part,
                      float* db_part, int T, int B, int H, int cdt_bf16, int splits,
                      int part_rows, cudaStream_t stream) {
    if (T <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
    if (!lstm::aligned16(w_ih) || !lstm::aligned16(w_hh))
        return (int)cudaErrorMisalignedAddress;
    return lstm::dispatch<Backward>(H, cdt_bf16, x, h0, c0, w_ih, w_hh, b, outs, cseq,
                                    g_outs, g_hT, g_cT, dx, dh0, dc0, dw, db, dg, dw_part,
                                    db_part, T, B, splits, part_rows, stream);
}

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
