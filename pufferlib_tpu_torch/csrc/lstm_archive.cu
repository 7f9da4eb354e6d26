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
// In f32 the roundings to the compute dtype are the identity, so enc2's,
// enc3's, enc4's and enc6's backwards compute enc5's function, and enc2's
// forward enc5's forward's (enc2's pair with its gates summed as two sums).
// * lstm_tm.lstm_scan_tm (lstm_tm_step_forward, lstm_tm_step_backward):
//   `_fwd_impl_tm` / `_fwd_kernel_tm` and `_lstm_tm_bwd` / `_bwd_kernel_tm`,
//   the grid with time outermost: one step of the whole batch per launch,
//   gates = x_proj_t + h @ W_hh, h and c (backward: dh and dc) carried in
//   f32 device buffers between launches.
// enc3, enc4 and enc6 share the forward of lstm_enc.cu, and enc2's takes
// its arguments. Same functions as
// the plain versions of pufferlib_tpu_torch.ops.cuda.archive.
//
// Bound: the functions are those of lstm_enc.cu (enc2, 3, 4, 6: bound by
// bf16 tensor-core operations, about 0.036 ms forward and 0.108 ms backward
// at T = 16, B = 8192, F = 49, D = H = 128) and of lstm_scan.cu's lstm_scan
// (tm: bound by bytes, about 0.065 and 0.12 ms); in f32 by FMA operations
// at 67 TFLOP/s (enc2's forward 0.537 ms).
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
//   two halves, each with a barrier of its own. enc3, enc4 and enc6 take
//   the reach of enc5's f32 kernels (D == H, F <= 128), enc2 the
//   tensor-core kernels' (any D % 8 == 0 up to lstm_tc_max_input, F up to
//   lstm_enc_tc_max_features).
// * bf16 tm: csrc/lstm_tc.cuh's mode XP loops (lstm_scan's) over one step
//   a launch (xp_forward_step, xp_backward_steps over [t, t + 1)): every
//   launch stages W_hh, rounded to bf16 once per call by the first step,
//   into each block's shared memory; the forward step loads the f32 h
//   carry into the block's rounded h tile, runs h @ W_hh on mma.sync, adds
//   x_proj_t after it and runs the cell, writing row t of outs and cseq
//   and the f32 carry; the backward step recomputes the gates from x_proj_t
//   and h_prev (h0 rounded at t = 0, else outs[t - 1]), runs the cell
//   backward with c_prev from cseq[t - 1] (c0 at t = 0), writes row t of
//   dx_proj (with bf16 x_proj the rounded dgates slab) and dh_prev = dg_t
//   @ W_hh^T through the dgates tile in shared memory; after step 0 dW_hh
//   is the ring split-K over all T*B rows. The carries are the values
//   lstm_scan's loops keep in registers, so tm's outputs and gradients are
//   lstm_scan's bit for bit; the launch a step (its W_hh staging and its
//   gap) is what tm costs over lstm_scan.
// * bf16 enc2 forward: csrc/lstm_tc.cuh's enc2_forward: the encoder GEMM,
//   the projection xp = bf16(x @ W_ih + b) as a GEMM that writes it in
//   bf16 in its natural (T, B, 4H) order (the TPU kernel's xp slab), then
//   mode XP's forward loop (lstm_scan's) on it, the recurrent product its
//   own f32 sum, added to xp_t after it.
// * f32 enc2, enc3, enc4 and enc6 backwards: csrc/lstm_f32.cuh's enc5
//   backward (enc5_backward<H, TWO_SUMS>), enc3's, enc4's and enc6's with
//   enc5's one sum, as lstm_enc.cu's lstm_enc_backward calls it, so their
//   gradients are enc5's bit for bit; enc2's with lstm_scan_fused's two
//   sums: the encoder SGEMM, x @ W_ih + b as one SGEMM (the bias in its
//   epilogue) into the dgates scratch, the pre-pass h_prev @ W_hh from
//   zero with that slab added in its epilogue before the activations (the
//   others': [x | h_prev] @ [W_ih; W_hh] + b in one), the reverse loop on
//   thread block clusters (W_hh^T on chip for all T steps, the partial
//   dh_prev through distributed shared memory), dpre and the split-K
//   SGEMMs. enc2's loop writes the dgates over its slab after the pre-pass
//   has read it: enc5's scratch, no more. enc3's TPU kernel keeps its
//   activations in a slab before the loop, as enc5's f32 backward does.
// * f32 tm backward: csrc/lstm_f32.cuh's mode XP backward
//   (xp_backward_steps, lstm_scan's) over [t, t + 1): the call at t = T - 1
//   runs the pre-pass over all T*B rows (the gates recompute from x_proj
//   and h_prev depends on no carry) into the f32 dgates' storage and
//   transposes W_hh into its scratch; every call runs the cluster reverse
//   loop over step t, staging its slice of W_hh^T into shared memory, its
//   dh/dc carries in the (B, H) buffers; the call at t = 0 runs dW_hh as
//   the split-K SGEMM over all T*B rows with lstm_scan's splits. The
//   carries are the values lstm_scan's loop keeps in registers, so tm's
//   f32 gradients are lstm_scan's bit for bit.
// * f32 tm forward: csrc/lstm_f32.cuh's mode XP forward (xp_forward,
//   lstm_scan's) over [t, t + 1): the two-sums cluster loop at one step on
//   step t's rows of x_proj, outs and cseq, h_in, c_in as its h0, c0 and
//   h_out, c_out as its hT, cT, W_hh staged into shared memory by every
//   launch; stream order is the only synchronisation a step needs. The
//   f32 carries are exact, so tm's outputs are lstm_scan's bit for bit.
// * f32 enc2 forward: csrc/lstm_f32.cuh's enc5 forward with
//   lstm_scan_fused's two sums (enc5_forward<H, true>), the TPU kernel's
//   own schedule: the encoder xs = relu(feats @ W_enc + b_enc) and the
//   projection xw = xs @ W_ih + b as two SGEMMs over all T*B rows (the
//   biases in their epilogues) into f32 scratch, then the loop on thread
//   block clusters (W_hh on chip for all T steps), each step's h @ W_hh
//   summed from zero and xw_t added after it. In f32 the TPU kernel's
//   roundings of x and xp are the identity, so this is its function.
#include "lstm_common.cuh"
#include "lstm_f32.cuh"
#include "lstm_tc.cuh"

using namespace lstm;

namespace {

// The encoder-fused backwards: bf16 on the tensor cores (tc::backward in
// mode MODE; enc2 at any encoder width D the tensor-core kernels take, the
// others at D == H, their forward's reach); f32, D == H, on lstm_f32.cuh
// (enc5_backward: enc2's with two sums, enc3's, enc4's and enc6's with
// enc5's one, whose function theirs is in f32). pre: in bf16 the P slab
// (lstm_tc.cuh slab_index) f32; in f32 lstm_f32.cuh's `work` (the
// activations (T * B * 4H), then W_ih^T and W_hh^T).
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
                               void* w16, int T, int B, int F, int D, int splits_w, int splits_e,
                               int part_rows, int phases, cudaStream_t stream) {
            if constexpr (std::is_same<E, bf16>::value) {
                if (!pre || !w16 || (MODE != ENC2 && D != H)) return cudaErrorInvalidValue;
                const tc::Encoder enc = tc::backward_encoder(feats, w_enc, b_enc, xs, dpre, w16,
                                                             dwe, dwe_part, splits_e, F, D, H, B);
                return tc::backward<H, MODE>(
                    enc.xs, h0, c0, w_ih, w_hh, b, static_cast<const E*>(outs),
                    static_cast<const E*>(cseq), static_cast<const E*>(g_outs), g_hT, g_cT,
                    nullptr, dh0, dc0, dw, db, static_cast<E*>(dg), dw_part, db_part,
                    static_cast<float*>(pre), static_cast<E*>(w16), T, B, D, splits_w, part_rows,
                    phases, stream, enc);
            } else {
                // enc5's f32 design (lstm_f32.cuh); enc2's with fused's two
                // sums, enc3's, enc4's and enc6's as lstm_enc.cu's
                // lstm_enc_backward calls it
                if (D != H) return cudaErrorInvalidValue;
                return f32::enc5_backward<H, MODE == ENC2>(
                    static_cast<const float*>(feats), h0, c0, w_enc, b_enc, w_ih, w_hh, b,
                    static_cast<const float*>(outs), static_cast<const float*>(cseq),
                    static_cast<const float*>(g_outs), g_hT, g_cT, dh0, dc0, dwe, dw, db,
                    static_cast<float*>(xs), static_cast<float*>(dpre), static_cast<float*>(dg),
                    dw_part, db_part, dwe_part, static_cast<float*>(pre), T, B, F, splits_w,
                    splits_e, part_rows, phases, stream);
            }
        }
    };
};

// Registers and spilled bytes per thread of the archive's own bf16 kernels
// at hidden size H, as out[2i], out[2i + 1]: enc2's pre-pass (its
// epilogue rounds the projection), the reverse loop of enc2 and enc4 (f32
// activations, db from the rounded dgates) and enc3's (rounded
// activations, db from the unrounded dgates), then enc2's forward: its
// projection GEMM (bias and rounding in the epilogue) and its loop (mode
// XP's on bf16 x_proj, lstm_scan.cu's). The encoder, the other pre-pass,
// dpre, the split-K and enc6's loop are enc5's.
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
            tc::backward_loop<H, rounded_acts(ENC3), rounded_db(ENC3)>),
        reinterpret_cast<const void*>(
            tc::rows_gemm_kernel<tc::BRows, tc::BRows, tc::BRows, tc::BRows, tc::ProjOut>),
        reinterpret_cast<const void*>(tc::forward_loop<H, XP, bf16>)};
    return tc::attributes(fns, 5, out);
}

// enc2's forward: bf16 on the tensor cores (tc::enc2_forward), f32 on
// lstm_f32.cuh (enc5_forward with fused's two sums), D == H
template <int H, typename E>
struct Enc2Forward {
    static cudaError_t run(const void* feats, const float* h0, const float* c0,
                           const float* w_enc, const float* b_enc, const float* w_ih,
                           const float* w_hh, const float* b, void* outs, void* cseq,
                           float* hT, float* cT, void* xs, void* xp, void* w16, int T, int B,
                           int F, int D, int phases, cudaStream_t stream) {
        if constexpr (std::is_same<E, bf16>::value) {
            if (!xs || !xp || !w16) return cudaErrorInvalidValue;
            tc::Encoder enc;
            enc.feats = static_cast<const E*>(feats);
            enc.w_enc = w_enc;
            enc.b_enc = b_enc;
            enc.xs = static_cast<E*>(xs);
            // w16: [W_ih; W_hh] (D + H, 4H), then W_enc (F, D)
            enc.we16 = static_cast<E*>(w16) + (size_t)(D + H) * 4 * H;
            enc.F = F;
            return tc::enc2_forward<H>(enc, h0, c0, w_ih, w_hh, b, static_cast<E*>(outs),
                                       static_cast<E*>(cseq), hT, cT, static_cast<E*>(xp),
                                       static_cast<E*>(w16), T, B, D, phases, stream);
        } else {
            if (D != H) return cudaErrorInvalidValue;
            return f32::enc5_forward<H, true>(
                static_cast<const float*>(feats), h0, c0, w_enc, b_enc, w_ih, w_hh, b,
                static_cast<float*>(outs), static_cast<float*>(cseq), hT, cT,
                static_cast<float*>(xs), static_cast<float*>(xp), T, B, F, phases, stream);
        }
    }
};

// tm's steps: bf16 on lstm_tc.cuh's mode XP loops (xp_forward_step,
// xp_backward_steps over [t, t + 1)); f32 on lstm_f32.cuh's (xp_forward,
// xp_backward_steps over [t, t + 1)); x_proj in S (bf16 when xp_bf16, else
// f32)
template <int H, typename E>
struct TmStepForward {
    template <typename S>
    static cudaError_t run_as(const void* x_proj, const float* h_in, const float* c_in,
                              const float* w_hh, void* outs, void* cseq, float* h_out,
                              float* c_out, void* w16, int t, int T, int B,
                              cudaStream_t stream) {
        if constexpr (std::is_same<E, bf16>::value) {
            return tc::xp_forward_step<H, S>(static_cast<const S*>(x_proj), h_in, c_in, w_hh,
                                             static_cast<E*>(outs), static_cast<E*>(cseq), h_out,
                                             c_out, static_cast<E*>(w16), t, T, B, stream);
        } else {
            if (w16) return cudaErrorInvalidValue;
            return f32::xp_forward<H, S>(static_cast<const S*>(x_proj), h_in, c_in, w_hh,
                                         static_cast<E*>(outs), static_cast<E*>(cseq), h_out,
                                         c_out, t, t + 1, T, B, stream);
        }
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
                              void* dg, float* dw_part, void* w16, int t, int T, int B,
                              int splits, int phases, cudaStream_t stream) {
        if constexpr (std::is_same<E, bf16>::value) {
            return tc::xp_backward_steps<H, S>(
                static_cast<const S*>(x_proj), h0, c0, w_hh, static_cast<const E*>(outs),
                static_cast<const E*>(cseq), static_cast<const E*>(g_outs), dh_in, dc_in,
                static_cast<S*>(dx_proj), dh_out, dc_out, dw_hh, static_cast<E*>(dg), dw_part,
                static_cast<E*>(w16), t, t + 1, T, B, splits, phases, stream);
        } else {
            // tm's phases leave out dW_hh (1) or not (2): the f32 backward's
            // last two
            if (phases < 1 || phases > tc::XP_BACKWARD_PHASES) return cudaErrorInvalidValue;
            return f32::xp_backward_steps<H, S>(
                static_cast<const S*>(x_proj), h0, c0, w_hh, static_cast<const E*>(outs),
                static_cast<const E*>(cseq), static_cast<const E*>(g_outs), dh_in, dc_in,
                static_cast<S*>(dx_proj), dh_out, dc_out, dw_hh, static_cast<E*>(dg), dw_part,
                static_cast<E*>(w16), t, t + 1, T, B, splits,
                phases + f32::XP_BACKWARD_PHASES - tc::XP_BACKWARD_PHASES, stream);
        }
    }
    template <typename... Args>
    static cudaError_t run(int xp_bf16, Args... args) {
        return xp_bf16 ? run_as<bf16>(args...) : run_as<float>(args...);
    }
};

}  // namespace

extern "C" {

// The arguments of lstm_enc.cu's lstm_enc_forward. feats: (T, B, F) in
// the compute dtype (bf16 when cdt_bf16, else f32); h0, c0: (B, H); w_enc:
// (F, D); b_enc: (D,); w_ih: (D, 4H), w_hh: (H, 4H); b: (4H,), all f32.
// Writes outs and, unless it is null, cseq (T, B, H) in the compute dtype,
// hT and cT (B, H) f32. Scratch: xs (T, B, D), the encoded inputs, and xp
// (T, B, 4H), the projection x @ W_ih + b, in the compute dtype; w16 ((D +
// H) * 4H + F * D) bf16, bf16 only (null in f32). f32 takes D == H.
// phases: 2 runs the whole forward, 1 stops after the encoder and the
// projection (to time them).
int lstm_enc2_forward(const void* feats, const float* h0, const float* c0,
                      const float* w_enc, const float* b_enc, const float* w_ih,
                      const float* w_hh, const float* b, void* outs, void* cseq, float* hT,
                      float* cT, void* xs, void* xp, void* w16, int T, int B, int F, int D,
                      int H, int cdt_bf16, int phases, cudaStream_t stream) {
    if (T <= 0 || B <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
    if (!aligned16(w_ih) || !aligned16(w_hh)) return (int)cudaErrorMisalignedAddress;
    return dispatch<Enc2Forward>(H, cdt_bf16, feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b,
                                 outs, cseq, hT, cT, xs, xp, w16, T, B, F, D, phases, stream);
}

// The four encoder-fused backwards (enc2, enc3, enc4, enc6): the arguments
// of lstm_enc.cu's lstm_enc_backward; D == H but in enc2's bf16 backward,
// which takes the widths of lstm_enc_backward's. Inputs as the
// forward's plus its outs and cseq and the gradients g_outs (T, B, H,
// compute dtype), g_hT and g_cT (B, H, f32). Writes dh0, dc0 (B, H), dwe
// (F + 1, H): dW_enc, then db_enc, dw = [dW_ih; dW_hh] (2H, 4H) and db
// (4H,), f32.
// Scratch: xs and dpre (T, B, H) and dg (T, B, 4H) in the compute dtype;
// dw_part (splits_w, 2H, 4H) and db_part (part_rows, 4H) f32, part_rows =
// ceil(B / 64) in bf16 and ceil(B / 32) in f32; dwe_part (splits_e, F + 1,
// H); dbe_part null (no backward reads it); pre: in bf16 the P slab (as
// lstm_enc_backward's) f32, in f32 lstm_enc_backward's f32 `pre` (the
// activations (T * B * 4H), then W_ih^T and W_hh^T); bf16 only (null in
// f32): w16 (2H * 4H + 4H * H + B * H + F * H) bf16. phases: 4 runs the
// whole backward; 1 .. 3 stop after the encoder and the pre-pass, the loop
// or dpre (to time them).
#define TC_BACKWARD(NAME, MODE)                                                             \
    int NAME(const void* feats, const float* h0, const float* c0, const float* w_enc,       \
             const float* b_enc, const float* w_ih, const float* w_hh, const float* b,      \
             const void* outs, const void* cseq, const void* g_outs, const float* g_hT,     \
             const float* g_cT, float* dh0, float* dc0, float* dwe, float* dw, float* db,   \
             void* xs, void* dpre, void* dg, float* dw_part, float* db_part,                \
             float* dwe_part, float* dbe_part, void* pre, void* w16, int T, int B, int F,   \
             int D, int H, int cdt_bf16, int splits_w, int splits_e, int part_rows,         \
             int phases, cudaStream_t stream) {                                             \
        if (T <= 0 || B <= 0 || F <= 0) return (int)cudaErrorInvalidValue;                  \
        if (!aligned16(w_ih) || !aligned16(w_hh)) return (int)cudaErrorMisalignedAddress;   \
        return dispatch<TcBackward<MODE>::Of>(                                              \
            H, cdt_bf16, feats, h0, c0, w_enc, b_enc, w_ih, w_hh, b, outs, cseq, g_outs,    \
            g_hT, g_cT, dh0, dc0, dwe, dw, db, xs, dpre, dg, dw_part, db_part, dwe_part,    \
            dbe_part, pre, w16, T, B, F, D, splits_w, splits_e, part_rows, phases, stream); \
    }

TC_BACKWARD(lstm_enc2_backward, ENC2)
TC_BACKWARD(lstm_enc3_backward, ENC3)
TC_BACKWARD(lstm_enc4_backward, ENC4)
TC_BACKWARD(lstm_enc6_backward, ENC6)
#undef TC_BACKWARD

// Registers and spilled bytes per thread of the archive's own bf16
// kernels at hidden size H (tc_usage): ten ints into out.
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
// of outs and cseq (T, B, H) in the compute dtype. Scratch, bf16 only
// (null in f32): w16 (H * 4H bf16), W_hh rounded by the call at t = 0 and
// read by every later step of the same walk.
int lstm_tm_step_forward(const void* x_proj, const float* h_in, const float* c_in,
                         const float* w_hh, void* outs, void* cseq, float* h_out,
                         float* c_out, void* w16, int t, int T, int B, int H, int cdt_bf16,
                         int xp_bf16, cudaStream_t stream) {
    if (B <= 0 || t < 0 || t >= T || !cseq || h_in == h_out || c_in == c_out)
        return (int)cudaErrorInvalidValue;
    if (!aligned16(w_hh)) return (int)cudaErrorMisalignedAddress;
    return dispatch<TmStepForward>(H, cdt_bf16, xp_bf16, x_proj, h_in, c_in, w_hh, outs,
                                   cseq, h_out, c_out, w16, t, T, B, stream);
}

// Step t of the time-major backward, over the whole batch. x_proj, h0, c0,
// w_hh, outs, cseq as the forward's whole arrays; g_outs (T, B, H, compute
// dtype); dh_in, dc_in: the gradients that enter step t (g_hT, g_cT at
// t = T - 1), dh_out, dc_out: those that leave it (dh0, dc0 at t = 0),
// other buffers than dh_in, dc_in, all (B, H) f32. Writes row t of dx_proj
// (T, B, 4H, x_proj's dtype; f32 compute with bf16 x_proj: every row at t
// = 0) and, at t = 0, dw_hh (H, 4H) from the dgates of every step.
// Scratch: dw_part (splits, H, 4H) f32, and dg (T, B, 4H) in the compute
// dtype, which is null where x_proj is in the compute dtype (dx_proj is
// then the slab dW_hh reads); w16, written by the call at t = T - 1 and
// read by every later step of the same walk: bf16, W_hh and h0 rounded (H
// * 4H + B * H bf16), f32, W_hh^T (4H * H f32; f32 compute also writes the
// activations of every step into its dgates' storage then). phases: 2
// runs the whole step, 1 leaves out dW_hh at t = 0 (to time the steps
// alone).
int lstm_tm_step_backward(const void* x_proj, const float* h0, const float* c0,
                          const float* w_hh, const void* outs, const void* cseq,
                          const void* g_outs, const float* dh_in, const float* dc_in,
                          void* dx_proj, float* dh_out, float* dc_out, float* dw_hh,
                          void* dg, float* dw_part, void* w16, int t, int T, int B, int H,
                          int cdt_bf16, int xp_bf16, int splits, int phases,
                          cudaStream_t stream) {
    if (B <= 0 || t < 0 || t >= T || dh_in == dh_out || dc_in == dc_out)
        return (int)cudaErrorInvalidValue;
    if (!aligned16(w_hh)) return (int)cudaErrorMisalignedAddress;
    return dispatch<TmStepBackward>(H, cdt_bf16, xp_bf16, x_proj, h0, c0, w_hh, outs, cseq,
                                    g_outs, dh_in, dc_in, dx_proj, dh_out, dc_out, dw_hh,
                                    dg, dw_part, w16, t, T, B, splits, phases, stream);
}

// Registers and spilled bytes per thread of tm's bf16 kernels at hidden
// size H, as out[2i], out[2i + 1]: the step forward (mode XP's forward
// loop at one step) with bf16 and with f32 x_proj, the step backward (mode
// XP's reverse loop over one step) likewise, and the ring split-K of dW_hh
// at step 0; lstm_scan.cu's templates, built into this library: ten ints.
int lstm_tm_tc_usage(int H, int* out) {
    switch (H) {
        case 32: return (int)tc::xp_usage<32>(out);
        case 64: return (int)tc::xp_usage<64>(out);
        case 128: return (int)tc::xp_usage<128>(out);
    }
    return (int)cudaErrorInvalidValue;
}

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
