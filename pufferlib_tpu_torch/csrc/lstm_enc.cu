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
// as enc5's. The two differ in bf16 only: in f32 every rounding is the
// identity, and the step backward runs enc5's f32 backward. The feats
// cotangent is zero by contract.
//
// Bound: at the bench shapes (T = 16, B = 8192, F = 49, D = H = 128,
// bf16) the forward does 2*T*B*(F*D + (D+H)*4H) = 36.0 GFLOP and the
// backward 2*T*B*(2*F*D + 2*(D+H)*4H + 4H*H + 4H*D) = 106.4 GFLOP, against
// some 100 MB and 140 MB of device memory traffic: bound by operations
// on the bf16 tensor cores (0.036 ms and 0.108 ms).
//
// Design, chosen by the compute dtype:
// * bf16 (lstm_enc_forward, lstm_enc_backward, lstm_enc_step_backward):
//   csrc/lstm_tc.cuh, every product on the tensor cores; the forward in
//   mode ENC5, enc5's backward in mode ENC5 and the step backward in mode
//   ENC, which differ only in the reverse loop's two roundings. The
//   encoder runs as one GEMM over all T*B rows into a (T, B, D) bf16
//   buffer, then cat's tensor-core forward runs on it (an x @ W_ih slab, a
//   loop that keeps W_hh in shared memory); a backward recomputes the
//   encoder with the same routine, runs cat's hoisted gate recompute, a
//   reverse loop (ENC5: the activations rounded to bf16 and db from the
//   rounded dgates; ENC: f32 activations and db from the unrounded
//   dgates), dpre (the relu-masked dx, rounded) as a GEMM epilogue, and
//   the weight gradients as split-K contractions. The step backward's TPU
//   kernel recomputes each step's gates and adds x^T dg, h_prev^T dg into
//   dW inside its loop: here the pre-pass recomputes them (no block holds
//   [W_ih; W_hh] in bf16 beside its loop's state) and the split-K sums the
//   same products in another fixed order. D is any multiple of 8 that a
//   GEMM block's weight column holds, F up to what the encoder GEMM's
//   block holds (lstm_enc_tc_max_features).
// * f32, the default compute dtype of both packages (exact: no TF32, the
//   tensor cores have no exact f32 product): all three run
//   csrc/lstm_f32.cuh, D == H, F <= 128. The encoder, x @ W_ih and the
//   backward's gate recompute, dpre and weight gradients are FMA SGEMMs
//   over all T*B rows; the time loops keep W_hh on chip for all T steps in
//   a thread block cluster, whose blocks exchange h (forward) or the
//   partial dh_prev (backward) through distributed shared memory. Each of
//   the forward's sums is x over k < D from zero, then h over k < H, then
//   b, the TPU kernel's one sum over K = D + H in order.
//   lstm_enc_step_backward
//   runs enc5's f32 backward, and so do the archived enc3's, enc4's and
//   enc6's (csrc/lstm_archive.cu): in f32 their functions are enc5's, and
//   their gradients enc5's bit for bit (the archived enc2's runs it with
//   two sums). The
//   step backward's TPU kernel recomputes the gates inside its loop; here
//   the pre-pass recomputes them over all T*B rows before it.
#include "lstm_common.cuh"
#include "lstm_f32.cuh"
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
            if (D != H) return cudaErrorInvalidValue;
            return lstm::f32::enc5_forward<H>(static_cast<const float*>(feats), h0, c0, w_enc,
                                              b_enc, w_ih, w_hh, b, static_cast<float*>(outs),
                                              static_cast<float*>(cseq), hT, cT,
                                              static_cast<float*>(xs), xw, T, B, F, phases,
                                              stream);
        }
    }
};

// The encoder-fused backwards in mode MODE: ENC5 (enc5's) or ENC
// (lstm_scan_enc's step backward). bf16 on the tensor cores
// (tc::backward); f32 with D == H, both enc5's on lstm_f32.cuh, whose
// function the step backward's is in f32.
template <int MODE>
struct EncBackward {
    template <int H, typename E>
    struct Of {
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
                return lstm::tc::backward<H, MODE>(
                    enc.xs, h0, c0, w_ih, w_hh, b, static_cast<const E*>(outs),
                    static_cast<const E*>(cseq), static_cast<const E*>(g_outs), g_hT, g_cT,
                    nullptr, dh0, dc0, dw, db, static_cast<E*>(dg), dw_part, db_part, pre,
                    static_cast<E*>(w16), T, B, D, splits_w, part_rows, phases, stream, enc);
            } else {
                if (D != H) return cudaErrorInvalidValue;
                return lstm::f32::enc5_backward<H>(
                    static_cast<const float*>(feats), h0, c0, w_enc, b_enc, w_ih, w_hh, b,
                    static_cast<const float*>(outs), static_cast<const float*>(cseq),
                    static_cast<const float*>(g_outs), g_hT, g_cT, dh0, dc0, dwe, dw, db,
                    static_cast<float*>(xs), static_cast<float*>(dpre), static_cast<float*>(dg),
                    dw_part, db_part, dwe_part, pre, T, B, F, splits_w, splits_e, part_rows,
                    phases, stream);
            }
        }
    };
};

// Registers and spilled bytes per thread of the bf16 kernels of both
// backwards at hidden size H: enc5's six (lstm::tc::usage in mode ENC5),
// then the reverse loop of mode ENC (f32 activations, db from the
// unrounded dgates); its other kernels are enc5's
template <int H>
cudaError_t enc_usage(int* out) {
    const cudaError_t err = lstm::tc::usage<H, lstm::ENC5>(out);
    if (err != cudaSuccess) return err;
    const void* fns[] = {reinterpret_cast<const void*>(
        lstm::tc::backward_loop<H, lstm::rounded_acts(lstm::ENC), lstm::rounded_db(lstm::ENC)>)};
    return lstm::tc::attributes(fns, 1, out + 12);
}

}  // namespace

extern "C" {

// feats: (T, B, F) in the compute dtype (bf16 when cdt_bf16, else f32);
// h0, c0: (B, H); w_enc: (F, D); b_enc: (D,); w_ih: (D, 4H), w_hh: (H,
// 4H); b: (4H,), all f32. Writes outs and, unless it is null, cseq (T, B,
// H) in the compute dtype, hT and cT (B, H) f32. Scratch: xs (T, B, D) in
// the compute dtype, the encoded inputs; bf16: xw (T * 64 ceil(B / 64) *
// 4H) f32, the slab of lstm_tc.cuh, and w16 ((D + H) * 4H + F * D) bf16;
// f32 (lstm_f32.cuh, D == H): xw (T * B * 4H) f32, x @ W_ih, and a null
// w16. phases: 2 runs the whole forward, 1 stops after the encoder and
// the pre-pass (to time them).
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
// ceil(B / 32) in f32; dwe_part (splits_e, F + 1, D); dbe_part null (no
// backward reads it); pre: bf16 as the forward's xw, f32 (lstm_f32.cuh)
// the activations (T * B * 4H) then W_ih^T and W_hh^T (4H * (D + H)); w16
// bf16 only ((D + H) * 4H + 4H * D + B * H + F * D). f32 takes D == H.
// phases: 4 runs the whole backward; 1 .. 3 stop after the encoder and the
// pre-pass, the loop or dpre (to time them).
#define ENC_BACKWARD(NAME, MODE)                                                            \
    int NAME(const void* feats, const float* h0, const float* c0, const float* w_enc,       \
             const float* b_enc, const float* w_ih, const float* w_hh, const float* b,      \
             const void* outs, const void* cseq, const void* g_outs, const float* g_hT,     \
             const float* g_cT, float* dh0, float* dc0, float* dwe, float* dw, float* db,   \
             void* xs, void* dpre, void* dg, float* dw_part, float* db_part,                \
             float* dwe_part, float* dbe_part, float* pre, void* w16, int T, int B, int F,  \
             int D, int H, int cdt_bf16, int splits_w, int splits_e, int part_rows,         \
             int phases, cudaStream_t stream) {                                             \
        if (T <= 0 || B <= 0 || F <= 0) return (int)cudaErrorInvalidValue;                 \
        if (!lstm::aligned16(w_ih) || !lstm::aligned16(w_hh))                               \
            return (int)cudaErrorMisalignedAddress;                                         \
        return lstm::dispatch<EncBackward<MODE>::Of>(                                       \
            H, cdt_bf16, feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b, outs, cseq, g_outs,    \
            g_hT, g_cT, dh0, dc0, dwe, dw, db, xs, dpre, dg, dw_part, db_part, dwe_part,    \
            dbe_part, pre, w16, T, B, F, D, splits_w, splits_e, part_rows, phases, stream); \
    }

ENC_BACKWARD(lstm_enc_backward, lstm::ENC5)

// The un-hoisted backward of lstm_scan_enc: lstm_enc_backward's arguments,
// scratch and phases, in mode ENC (f32 activations, db from the unrounded
// dgates) on the tensor cores in bf16; in f32, where those roundings are
// the identity, enc5's f32 backward.
ENC_BACKWARD(lstm_enc_step_backward, lstm::ENC)
#undef ENC_BACKWARD

// Registers and spilled bytes per thread of the bf16 kernels of both
// backwards at hidden size H (enc_usage): fourteen ints into out.
int lstm_enc_tc_usage(int H, int* out) {
    switch (H) {
        case 32: return (int)enc_usage<32>(out);
        case 64: return (int)enc_usage<64>(out);
        case 128: return (int)enc_usage<128>(out);
    }
    return (int)cudaErrorInvalidValue;
}

// Registers and spilled bytes per thread of enc5's f32 kernels at hidden
// size H (lstm::f32::usage with the encoder's two): twenty ints into out.
int lstm_enc_f32_usage(int H, int* out) {
    switch (H) {
        case 32: return (int)lstm::f32::usage<32, true>(out);
        case 64: return (int)lstm::f32::usage<64, true>(out);
        case 128: return (int)lstm::f32::usage<128, true>(out);
    }
    return (int)cudaErrorInvalidValue;
}

// The tilings enc5's f32 loops take at B batch rows (lstm::f32::loop_plan):
// forward then backward, each (units a block, rows a thread, clusters the
// card holds at once); six ints into out.
int lstm_enc_f32_plan(int H, int B, int* out) {
    switch (H) {
        case 32: return (int)lstm::f32::loop_plan<32>(B, out);
        case 64: return (int)lstm::f32::loop_plan<64>(B, out);
        case 128: return (int)lstm::f32::loop_plan<128>(B, out);
    }
    return (int)cudaErrorInvalidValue;
}

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
