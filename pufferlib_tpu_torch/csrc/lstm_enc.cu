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
// on the bf16 tensor cores (0.036 ms and 0.108 ms).
//
// Design, chosen by the compute dtype:
// * bf16, enc5 (lstm_enc_forward, lstm_enc_backward): csrc/lstm_tc.cuh in
//   mode ENC5, every product on the tensor cores. The encoder runs as one
//   GEMM over all T*B rows into a (T, B, D) bf16 buffer, then cat's
//   tensor-core forward runs on it (an x @ W_ih slab, a loop that keeps
//   W_hh in shared memory); the backward recomputes the encoder with the
//   same routine, runs cat's hoisted gate recompute, a reverse loop with
//   the activations rounded to bf16 and db from the rounded dgates, dpre
//   (the relu-masked dx, rounded) as a GEMM epilogue, and the weight
//   gradients as split-K contractions. D is any multiple of 8 that a GEMM
//   block's weight column holds, F up to what the encoder GEMM's block
//   holds (lstm_enc_tc_max_features).
// * f32, and every backward but enc5's bf16 one (lstm_scan_enc's step
//   backward here, the archived variants in csrc/lstm_archive.cu):
//   csrc/lstm_common.cuh on FMA, D == H. The encoder runs inside the time
//   loop of each block from a W_enc held in shared memory (F <= 128); the
//   TPU kernel's tall pre-pass becomes a per-step recompute inside the
//   backward's loop; the post-loop contractions dW_ih, dW_hh and dW_enc
//   are split-K over the T*B rows with partial sums added in a fixed
//   order. f32 is the exact test mode: the tensor cores have no exact f32
//   product.
#include "lstm_common.cuh"
#include "lstm_tc.cuh"

namespace {

template <int H, typename E>
struct Forward {
    static cudaError_t run(const void* feats, const float* h0, const float* c0,
                           const float* w_enc, const float* b_enc, const float* w_ih,
                           const float* w_hh, const float* b, void* outs, void* cseq,
                           float* hT, float* cT, void* xs, float* xw, void* w16, int T, int B,
                           int F, int D, int phases, cudaStream_t stream) {
        if constexpr (std::is_same<E, lstm::bf16>::value) {
            if (!xs || !xw || !w16) return cudaErrorInvalidValue;
            lstm::tc::Encoder enc;
            enc.feats = static_cast<const E*>(feats);
            enc.w_enc = w_enc;
            enc.b_enc = b_enc;
            enc.xs = static_cast<E*>(xs);
            // w16: [W_ih; W_hh] (D + H, 4H), then W_enc (F, D)
            enc.we16 = static_cast<E*>(w16) + (size_t)(D + H) * 4 * H;
            enc.F = F;
            return lstm::tc::enc5_forward<H>(enc, h0, c0, w_ih, w_hh, b, static_cast<E*>(outs),
                                             static_cast<E*>(cseq), hT, cT, xw,
                                             static_cast<E*>(w16), T, B, D, phases, stream);
        } else {
            if (phases != lstm::tc::FORWARD_PHASES || D != H) return cudaErrorInvalidValue;
            return lstm::run_forward<H, E, E, lstm::ENC>(feats, h0, c0, w_enc, b_enc, w_ih,
                                                         w_hh, b, outs, cseq, hT, cT, T, B, F,
                                                         stream);
        }
    }
};

template <int H, typename E>
struct Backward {
    static cudaError_t run(const void* feats, const float* h0, const float* c0,
                           const float* w_enc, const float* b_enc, const float* w_ih,
                           const float* w_hh, const float* b, const void* outs,
                           const void* cseq, const void* g_outs, const float* g_hT,
                           const float* g_cT, float* dh0, float* dc0, float* dwe, float* dw,
                           float* db, void* xs, void* dpre, void* dg, float* dw_part,
                           float* db_part, float* dwe_part, float* dbe_part, float* pre,
                           void* w16, int T, int B, int F, int D, int splits_w, int splits_e,
                           int part_rows, int phases, cudaStream_t stream) {
        if constexpr (std::is_same<E, lstm::bf16>::value) {
            if (!pre || !w16) return cudaErrorInvalidValue;
            const lstm::tc::Encoder enc = lstm::tc::backward_encoder(
                feats, w_enc, b_enc, xs, dpre, w16, dwe, dwe_part, splits_e, F, D, H, B);
            return lstm::tc::backward<H, lstm::ENC5>(
                enc.xs, h0, c0, w_ih, w_hh, b, static_cast<const E*>(outs),
                static_cast<const E*>(cseq), static_cast<const E*>(g_outs), g_hT, g_cT, nullptr,
                dh0, dc0, dw, db, static_cast<E*>(dg), dw_part, db_part, pre,
                static_cast<E*>(w16), T, B, D, splits_w, part_rows, phases, stream, enc);
        } else {
            if (phases != lstm::tc::BACKWARD_PHASES || D != H) return cudaErrorInvalidValue;
            return lstm::run_backward<H, E, E, lstm::ENC5>(
                feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b, outs, cseq, g_outs, g_hT, g_cT, dh0,
                dc0, dwe, dwe + (size_t)F * D, dw, db, xs, dpre, dg, dw_part, db_part, dwe_part,
                dbe_part, T, B, F, splits_w, splits_e, part_rows, stream);
        }
    }
};

template <int H, typename E>
struct StepBackward {
    static cudaError_t run(const void* feats, const float* h0, const float* c0,
                           const float* w_enc, const float* b_enc, const float* w_ih,
                           const float* w_hh, const float* b, const void* outs,
                           const void* cseq, const void* g_outs, const float* g_hT,
                           const float* g_cT, float* dh0, float* dc0, float* dw_enc,
                           float* db_enc, float* dw, float* db, void* xs, void* dpre, void* dg,
                           float* dw_part, float* db_part, float* dwe_part, float* dbe_part,
                           int T, int B, int F, int splits_w, int splits_e, int part_rows,
                           cudaStream_t stream) {
        return lstm::run_backward<H, E, E, lstm::ENC>(
            feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b, outs, cseq, g_outs, g_hT, g_cT, dh0,
            dc0, dw_enc, db_enc, dw, db, xs, dpre, dg, dw_part, db_part, dwe_part, dbe_part, T,
            B, F, splits_w, splits_e, part_rows, stream);
    }
};

}  // namespace

extern "C" {

// feats: (T, B, F) in the compute dtype (bf16 when cdt_bf16, else f32);
// h0, c0: (B, H); w_enc: (F, D); b_enc: (D,); w_ih: (D, 4H), w_hh: (H,
// 4H); b: (4H,), all f32. Writes outs and, unless it is null, cseq (T, B,
// H) in the compute dtype, hT and cT (B, H) f32. Scratch, bf16 only (null
// in f32): xs (T, B, D) bf16, the encoded inputs; xw (T * 64 ceil(B / 64)
// * 4H) f32, the slab of lstm_tc.cuh; w16 ((D + H) * 4H + F * D) bf16.
// f32 takes D == H. phases: 2 runs the whole forward; in bf16, 1 stops
// after the encoder and the pre-pass (to time them).
int lstm_enc_forward(const void* feats, const float* h0, const float* c0,
                     const float* w_enc, const float* b_enc, const float* w_ih,
                     const float* w_hh, const float* b, void* outs, void* cseq, float* hT,
                     float* cT, void* xs, float* xw, void* w16, int T, int B, int F, int D, int H,
                     int cdt_bf16, int phases, cudaStream_t stream) {
    if (T <= 0 || B <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
    if (!lstm::aligned16(w_ih) || !lstm::aligned16(w_hh))
        return (int)cudaErrorMisalignedAddress;
    return lstm::dispatch<Forward>(H, cdt_bf16, feats, h0, c0, w_enc, b_enc, w_ih, w_hh,
                                   b, outs, cseq, hT, cT, xs, xw, w16, T, B, F, D, phases,
                                   stream);
}

// Inputs as the forward's plus its outs and cseq and the gradients g_outs
// (T, B, H, compute dtype), g_hT and g_cT (B, H, f32). Writes dh0, dc0
// (B, H), dwe (F + 1, D): dW_enc (F, D) then db_enc (D,), dw = [dW_ih;
// dW_hh] (D + H, 4H) and db (4H,), f32. Scratch: xs and dpre (T, B, D)
// and dg (T, B, 4H) in the compute dtype; dw_part (splits_w, D + H, 4H)
// and db_part (part_rows, 4H) f32, part_rows = ceil(B / 64) in bf16 and
// ceil(B / 32) in f32; dwe_part (splits_e, F + 1, D) in bf16, (splits_e,
// F, D) in f32; f32 only (null in bf16): dbe_part (part_rows, D); bf16
// only (null in f32): pre (as the forward's xw) f32 and w16 ((D + H) * 4H
// + 4H * D + B * H + F * D) bf16. f32 takes D == H. phases: 4 runs the
// whole backward; in bf16, 1 .. 3 stop after the encoder and the
// pre-pass, the loop or dpre (to time them).
int lstm_enc_backward(const void* feats, const float* h0, const float* c0,
                      const float* w_enc, const float* b_enc, const float* w_ih,
                      const float* w_hh, const float* b, const void* outs, const void* cseq,
                      const void* g_outs, const float* g_hT, const float* g_cT, float* dh0,
                      float* dc0, float* dwe, float* dw, float* db, void* xs, void* dpre,
                      void* dg, float* dw_part, float* db_part, float* dwe_part,
                      float* dbe_part, float* pre, void* w16, int T, int B, int F, int D,
                      int H, int cdt_bf16, int splits_w, int splits_e, int part_rows,
                      int phases, cudaStream_t stream) {
    if (T <= 0 || B <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
    if (!lstm::aligned16(w_ih) || !lstm::aligned16(w_hh))
        return (int)cudaErrorMisalignedAddress;
    return lstm::dispatch<Backward>(H, cdt_bf16, feats, h0, c0, w_enc, b_enc, w_ih, w_hh,
                                    b, outs, cseq, g_outs, g_hT, g_cT, dh0, dc0, dwe, dw, db,
                                    xs, dpre, dg, dw_part, db_part, dwe_part, dbe_part, pre,
                                    w16, T, B, F, D, splits_w, splits_e, part_rows, phases,
                                    stream);
}

// The un-hoisted backward of lstm_scan_enc, on FMA in both dtypes (D ==
// H): inputs as lstm_enc_backward's; writes dh0, dc0, dw_enc (F, H),
// db_enc (H,), dw (2H, 4H) and db (4H,); scratch xs, dpre, dg, dw_part,
// db_part, dwe_part (splits_e, F, H) and dbe_part as its f32 path's.
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

// Registers and spilled bytes per thread of enc5's bf16 kernels at hidden
// size H (lstm::tc::usage in mode ENC5): twelve ints into out.
int lstm_enc_tc_usage(int H, int* out) { return lstm::tc::usage_at<lstm::ENC5>(H, out); }

// The widest feature width enc5's bf16 encoder takes
// (lstm::tc::serves_features), into *out: the limit that
// lstm_common.tc_max_features computes for the checks made before a
// launch.
int lstm_enc_tc_max_features(int* out) {
    int F = 0;
    while (lstm::tc::serves_features(F + 1)) ++F;
    *out = F;
    return 0;
}

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
