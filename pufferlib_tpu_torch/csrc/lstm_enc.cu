// Encoder-fused LSTM time scan (enc5 and enc), forward and backward, for
// Hopper (sm_90a).
//
// Replaces three TPU kernels of pufferlib_tpu/ops/pallas/: the forward of
// lstm_enc5.lstm_scan_enc5 and lstm_enc.lstm_scan_enc, which is
// lstm_enc._impl / _fwd_kernel; the enc5 backward, lstm_enc5._hoisted_bwd
// / _bwd_kernel; and the un-hoisted backward of lstm_scan_enc,
// lstm_enc._bwd / _bwd_kernel (lstm_enc_step_backward below). Same
// functions as the plain pufferlib_tpu_torch.ops.cuda.lstm_enc
// lstm_enc_reference, lstm_enc_backward_reference and
// lstm_scan_enc_backward_reference: x_t = relu(feats_t @ W_enc + b_enc)
// rounded to the compute dtype feeds the cell of lstm_cat.cu. The enc5
// backward stores the gate activations and dgates in the compute dtype
// (the TPU kernel's shared activation/dgates slab), rounds dpre to it, and
// sums db and db_enc from the rounded values. The step backward keeps the
// recomputed activations in f32 and sums db from the unrounded dgates, as
// its TPU kernel does inside its loop; its dgates, dpre and db_enc round
// as enc5's. The two differ in bf16 only. The feats cotangent is zero by
// contract.
//
// Bound: at the bench shapes (T = 16, B = 8192, F = 49, D = H = 128,
// bf16) the forward does 2*T*B*(F*D + (D+H)*4H) = 36.0 GFLOP and the
// backward 2*T*B*(2*F*D + 2*(D+H)*4H + 4H*H + 4H*D) = 106.4 GFLOP, against
// some 100 MB and 140 MB of device memory traffic: bound by operations
// on the bf16 tensor cores (0.036 ms and 0.108 ms). The recurrent kernels
// run plain f32 FMA, some 35-40x above that bound; the backward's
// weight-gradient contractions run on the bf16 tensor cores.
//
// Design (csrc/lstm_common.cuh): the encoder runs inside the time loop of
// each block from a W_enc held in shared memory, so the encoded sequence
// never reaches device memory in the forward; the TPU kernel's tall
// pre-pass (all gate activations at once) becomes a per-step recompute
// inside the backward's loop, which needs no (T*B, 4H) activation slab in
// shared memory; the post-loop contractions dW_ih, dW_hh and dW_enc are
// split-K over the T*B rows with partial sums added in a fixed order.
#include "lstm_common.cuh"

namespace {

template <int H, typename E>
struct Forward {
    static cudaError_t run(const void* feats, const float* h0, const float* c0,
                           const float* w_enc, const float* b_enc, const float* w_ih,
                           const float* w_hh, const float* b, void* outs, void* cseq,
                           float* hT, float* cT, int T, int B, int F, cudaStream_t stream) {
        return lstm::run_forward<H, E, E, lstm::ENC>(feats, h0, c0, w_enc, b_enc, w_ih,
                                                     w_hh, b, outs, cseq, hT, cT, T, B, F,
                                                     stream);
    }
};

template <int H, typename E, int MODE>
cudaError_t backward(const void* feats, const float* h0, const float* c0,
                     const float* w_enc, const float* b_enc, const float* w_ih,
                     const float* w_hh, const float* b, const void* outs, const void* cseq,
                     const void* g_outs, const float* g_hT, const float* g_cT, float* dh0,
                     float* dc0, float* dw_enc, float* db_enc, float* dw, float* db,
                     void* xs, void* dpre, void* dg, float* dw_part, float* db_part,
                     float* dwe_part, float* dbe_part, int T, int B, int F, int splits_w,
                     int splits_e, int part_rows, cudaStream_t stream) {
    return lstm::run_backward<H, E, E, MODE>(
        feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b, outs, cseq, g_outs, g_hT, g_cT, dh0,
        dc0, dw_enc, db_enc, dw, db, xs, dpre, dg, dw_part, db_part, dwe_part, dbe_part,
        T, B, F, splits_w, splits_e, part_rows, stream);
}

template <int H, typename E>
struct Backward {
    template <typename... Args>
    static cudaError_t run(Args... args) {
        return backward<H, E, lstm::ENC5>(args...);
    }
};

template <int H, typename E>
struct StepBackward {
    template <typename... Args>
    static cudaError_t run(Args... args) {
        return backward<H, E, lstm::ENC>(args...);
    }
};

}  // namespace

extern "C" {

// feats: (T, B, F) in the compute dtype (bf16 when cdt_bf16, else f32);
// h0, c0: (B, H); w_enc: (F, H); b_enc: (H,); w_ih, w_hh: (H, 4H); b:
// (4H,), all f32. Writes outs and cseq (T, B, H) in the compute dtype, hT
// and cT (B, H) f32.
int lstm_enc_forward(const void* feats, const float* h0, const float* c0,
                     const float* w_enc, const float* b_enc, const float* w_ih,
                     const float* w_hh, const float* b, void* outs, void* cseq, float* hT,
                     float* cT, int T, int B, int F, int H, int cdt_bf16,
                     cudaStream_t stream) {
    if (T <= 0 || B <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
    if (!lstm::aligned16(w_ih) || !lstm::aligned16(w_hh))
        return (int)cudaErrorMisalignedAddress;
    return lstm::dispatch<Forward>(H, cdt_bf16, feats, h0, c0, w_enc, b_enc, w_ih, w_hh,
                                   b, outs, cseq, hT, cT, T, B, F, stream);
}

// Inputs as the forward's plus its outs and cseq and the gradients g_outs
// (T, B, H, compute dtype), g_hT and g_cT (B, H, f32). Writes dh0, dc0
// (B, H), dw_enc (F, H), db_enc (H,), dw = [dW_ih; dW_hh] (2H, 4H) and db
// (4H,), f32. Scratch: xs and dpre (T, B, H) and dg (T, B, 4H) in the
// compute dtype; dw_part (splits_w, 2H, 4H), db_part (part_rows, 4H),
// dwe_part (splits_e, F, H) and dbe_part (part_rows, H) f32, with
// part_rows = ceil(B / 32).
int lstm_enc_backward(const void* feats, const float* h0, const float* c0,
                      const float* w_enc, const float* b_enc, const float* w_ih,
                      const float* w_hh, const float* b, const void* outs, const void* cseq,
                      const void* g_outs, const float* g_hT, const float* g_cT, float* dh0,
                      float* dc0, float* dw_enc, float* db_enc, float* dw, float* db,
                      void* xs, void* dpre, void* dg, float* dw_part, float* db_part,
                      float* dwe_part, float* dbe_part, int T, int B, int F, int H,
                      int cdt_bf16, int splits_w, int splits_e, int part_rows,
                      cudaStream_t stream) {
    if (T <= 0 || B <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
    if (!lstm::aligned16(w_ih) || !lstm::aligned16(w_hh))
        return (int)cudaErrorMisalignedAddress;
    return lstm::dispatch<Backward>(H, cdt_bf16, feats, h0, c0, w_enc, b_enc, w_ih, w_hh,
                                    b, outs, cseq, g_outs, g_hT, g_cT, dh0, dc0, dw_enc,
                                    db_enc, dw, db, xs, dpre, dg, dw_part, db_part, dwe_part,
                                    dbe_part, T, B, F, splits_w, splits_e, part_rows, stream);
}

// The un-hoisted backward of lstm_scan_enc: arguments, outputs and scratch
// as lstm_enc_backward's.
int lstm_enc_step_backward(const void* feats, const float* h0, const float* c0,
                           const float* w_enc, const float* b_enc, const float* w_ih,
                           const float* w_hh, const float* b, const void* outs,
                           const void* cseq, const void* g_outs, const float* g_hT,
                           const float* g_cT, float* dh0, float* dc0, float* dw_enc,
                           float* db_enc, float* dw, float* db, void* xs, void* dpre,
                           void* dg, float* dw_part, float* db_part, float* dwe_part,
                           float* dbe_part, int T, int B, int F, int H, int cdt_bf16,
                           int splits_w, int splits_e, int part_rows,
                           cudaStream_t stream) {
    if (T <= 0 || B <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
    if (!lstm::aligned16(w_ih) || !lstm::aligned16(w_hh))
        return (int)cudaErrorMisalignedAddress;
    return lstm::dispatch<StepBackward>(H, cdt_bf16, feats, h0, c0, w_enc, b_enc, w_ih,
                                        w_hh, b, outs, cseq, g_outs, g_hT, g_cT, dh0, dc0,
                                        dw_enc, db_enc, dw, db, xs, dpre, dg, dw_part,
                                        db_part, dwe_part, dbe_part, T, B, F, splits_w,
                                        splits_e, part_rows, stream);
}

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
