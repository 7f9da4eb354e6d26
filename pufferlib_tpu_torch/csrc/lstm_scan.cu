// LSTM time scans whose input projection stays apart from the recurrent
// sum, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of pufferlib_tpu/ops/pallas/lstm.py:
// * lstm_scan (lstm_scan_forward, lstm_scan_backward below): forward
//   `_lstm_fwd_impl` / `_fwd_kernel` and `_fwd_kernel_noresid`, backward
//   `_lstm_scan_bwd` / `_bwd_kernel`. The projection x_proj = x @ W_ih + b
//   arrives as an operand (T, B, 4H), f32 or bf16 whatever the compute
//   dtype; gates = x_proj_t (f32) + h @ W_hh, the recurrent product summed
//   in f32 on operands rounded to the compute dtype and added last. The
//   backward writes the f32 dgates to dx_proj in x_proj's dtype and
//   contracts dgates rounded to the compute dtype: dh_prev = dg @ W_hh^T,
//   dW_hh = h_prev^T dg.
// * lstm_scan_fused (lstm_fused_forward, lstm_fused_backward):
//   `_lstm_fused_impl` / `_fwd_fused_kernel` and `_noresid`, backward
//   `_lstm_fused_bwd` / `_bwd_fused_kernel`. x (T, B, D) in the compute
//   dtype; gates = (x_t @ W_ih + b) + h @ W_hh, each product its own f32
//   sum (the cat kernel's single sum over K = D + H orders them
//   otherwise); the backward is cat's: dx, dW_ih, dW_hh, and db from the
//   unrounded dgates.
// Same functions as the plain versions of
// pufferlib_tpu_torch.ops.cuda.lstm_scan. A null cseq makes either forward
// the TPU package's `_noresid` kernel: no cell sequence is written.
//
// Bound: at the bench shapes (T = 16, B = 8192, D = H = 128, bf16)
// lstm_scan's forward reads 134 MB of x_proj and writes 67 MB of outs and
// cseq against 2*T*B*H*4H = 17.2 GFLOP, and its backward moves about 400
// MB (x_proj in, dx_proj out, three sequences in) against 51.5 GFLOP:
// both bound by bytes (about 0.065 and 0.12 ms). lstm_scan_fused moves
// and computes what the cat kernel does: the forward at the crossover of
// bytes and bf16 tensor-core operations (about 0.035 ms), the backward
// bound by operations (about 0.10 ms); in f32, on FMA at 67 TFLOP/s, both
// bound by operations (0.513 and 1.539 ms; 1.282 from the kept slab).
//
// Both pairs choose by the compute dtype, the only branch:
// * bf16: csrc/lstm_tc.cuh, every product on the tensor cores, loops that
//   hold W_hh in shared memory and keep only the recurrent product.
//   lstm_scan runs mode XP: the forward loop reads x_proj itself, in its
//   natural order and dtype (no pre-pass, no slab); the reverse loop
//   recomputes each step's gates x_proj_t + h_prev @ W_hh from x_proj and
//   the stored outs (no pre-pass, no slab, no db), then dW_hh = h_prev^T
//   dg runs on lstm_common.cuh's ring split-K. With bf16 x_proj, dx_proj
//   is the rounded dgates slab the loop writes and the split-K reads; with
//   f32 x_proj the loop writes the f32 dgates to dx_proj and the rounded
//   ones to a scratch slab. Its scratch: the rounded W_hh and h0, the
//   split-K's partials. lstm_scan_fused runs mode FUSED: the projections
//   in GEMMs over all T*B rows before and after the loops; its scratch, an
//   f32 slab of the projections (XW or P) and the bf16 weights. The input
//   width D is free (a multiple of 8, up to what a GEMM block's shared
//   memory holds).
// * f32 (exact: no TF32, the tensor cores have no exact f32 product),
//   D == H. lstm_scan's forward runs csrc/lstm_f32.cuh's mode XP forward
//   (xp_forward): lstm_scan_fused's two-sums loop on thread block
//   clusters with x_proj (f32 or bf16, widened exactly) as its slab, no
//   SGEMM: W_hh on chip for all T steps, h through distributed shared
//   memory, each step's h @ W_hh summed from zero and x_proj_t added after
//   it (the order of lstm_scan_fused's sums, as the TPU kernels add
//   x_proj_t after the recurrent sum); its scratch
//   pointer is null. lstm_scan's backward runs csrc/lstm_f32.cuh's mode
//   XP backward (xp_backward_steps): every
//   step's gates at once as an FMA SGEMM, h_prev @ W_hh from zero with
//   x_proj added in its epilogue (the forward's sums) and the activations
//   written into the f32 dgates' storage (dx_proj, or with bf16 x_proj
//   the scratch dg); the reverse loop on thread block clusters, W_hh^T on
//   chip for all T steps, writing the dgates over their activations (no
//   slab); with bf16 x_proj dg rounded into dx_proj; dW_hh as the split-K
//   SGEMM. Its scratch: W_hh^T (in w16's place) and the split-K's
//   partials. lstm_scan_fused runs
//   csrc/lstm_f32.cuh, cat's f32 design with fused's two sums (TWO_SUMS):
//   xw = x @ W_ih + b as one FMA SGEMM over all T*B rows (the bias in its
//   epilogue) into a slab that the caller keeps for the backward (T * B *
//   4H f32, 268 MB at the bench shape), then a loop on thread block
//   clusters that hold W_hh on chip for all T steps, h crossing the
//   cluster through distributed shared memory; each step's h @ W_hh is
//   summed from zero and the slab added after it, the TPU kernel's two
//   sums in their order. The
//   backward's gates are h_prev @ W_hh from zero plus the kept slab, the
//   activations in the SGEMM's epilogue; a reverse loop on the clusters
//   (the partial dh_prev of each block's gate columns added in rank
//   order), dx and the split-K weight gradients as SGEMMs, db the ordered
//   sum of the loop blocks' partials: no atomics.
#include "lstm_common.cuh"
#include "lstm_f32.cuh"
#include "lstm_tc.cuh"

namespace {

// lstm_scan: bf16 on lstm_tc.cuh's mode XP, f32 on lstm_f32.cuh's; x_proj
// in S (bf16 when xp_bf16, else f32)
template <int H, typename E>
struct ScanForward {
    template <typename S>
    static cudaError_t run_as(const void* x_proj, const float* h0, const float* c0,
                              const float* w_hh, void* outs, void* cseq, float* hT,
                              float* cT, void* w16, int T, int B, int phases,
                              cudaStream_t stream) {
        if constexpr (std::is_same<E, lstm::bf16>::value) {
            return lstm::tc::xp_forward<H, S>(
                static_cast<const S*>(x_proj), h0, c0, w_hh, static_cast<E*>(outs),
                static_cast<E*>(cseq), hT, cT, static_cast<E*>(w16), T, B, phases, stream);
        } else {
            if (phases != lstm::tc::XP_FORWARD_PHASES) return cudaErrorInvalidValue;
            return lstm::f32::xp_forward<H, S>(static_cast<const S*>(x_proj), h0, c0, w_hh,
                                               static_cast<E*>(outs), static_cast<E*>(cseq), hT,
                                               cT, 0, T, T, B, stream);
        }
    }
    template <typename... Args>
    static cudaError_t run(int xp_bf16, Args... args) {
        return xp_bf16 ? run_as<lstm::bf16>(args...) : run_as<float>(args...);
    }
};

template <int H, typename E>
struct ScanBackward {
    template <typename S>
    static cudaError_t run_as(const void* x_proj, const float* h0, const float* c0,
                              const float* w_hh, const void* outs, const void* cseq,
                              const void* g_outs, const float* g_hT, const float* g_cT,
                              void* dx_proj, float* dh0, float* dc0, float* dw_hh, void* dg,
                              float* dw_part, void* w16, int T, int B, int splits, int phases,
                              cudaStream_t stream) {
        if constexpr (std::is_same<E, lstm::bf16>::value) {
            return lstm::tc::xp_backward<H, S>(
                static_cast<const S*>(x_proj), h0, c0, w_hh, static_cast<const E*>(outs),
                static_cast<const E*>(cseq), static_cast<const E*>(g_outs), g_hT, g_cT,
                static_cast<S*>(dx_proj), dh0, dc0, dw_hh, static_cast<E*>(dg), dw_part,
                static_cast<E*>(w16), T, B, splits, phases, stream);
        } else {
            return lstm::f32::xp_backward_steps<H, S>(
                static_cast<const S*>(x_proj), h0, c0, w_hh, static_cast<const E*>(outs),
                static_cast<const E*>(cseq), static_cast<const E*>(g_outs), g_hT, g_cT,
                static_cast<S*>(dx_proj), dh0, dc0, dw_hh, static_cast<E*>(dg), dw_part,
                static_cast<E*>(w16), 0, T, T, B, splits, phases, stream);
        }
    }
    template <typename... Args>
    static cudaError_t run(int xp_bf16, Args... args) {
        return xp_bf16 ? run_as<lstm::bf16>(args...) : run_as<float>(args...);
    }
};

// lstm_scan_fused: bf16 on lstm_tc.cuh's mode FUSED, f32 on lstm_f32.cuh
template <int H, typename E>
struct FusedForward : std::conditional_t<std::is_same<E, lstm::bf16>::value,
                                         lstm::tc::CellForward<lstm::FUSED, H>,
                                         lstm::f32::CellForward<H, true>> {};

template <int H, typename E>
struct FusedBackward : std::conditional_t<std::is_same<E, lstm::bf16>::value,
                                          lstm::tc::CellBackward<lstm::FUSED, H>,
                                          lstm::f32::CellBackward<H, true>> {};

}  // namespace

extern "C" {

// x_proj: (T, B, 4H), bf16 when xp_bf16, else f32; h0, c0: (B, H); w_hh:
// (H, 4H), f32. Writes outs and, unless it is null, cseq (T, B, H) in the
// compute dtype (bf16 when cdt_bf16, else f32), hT and cT (B, H) f32.
// Scratch, bf16 only (null in f32): w16 (H * 4H bf16). phases: 1, the
// whole forward (the loop; there is no pre-pass).
int lstm_scan_forward(const void* x_proj, const float* h0, const float* c0,
                      const float* w_hh, void* outs, void* cseq, float* hT, float* cT,
                      void* w16, int T, int B, int H, int cdt_bf16, int xp_bf16, int phases,
                      cudaStream_t stream) {
    if (T <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
    if (!lstm::aligned16(w_hh)) return (int)cudaErrorMisalignedAddress;
    return lstm::dispatch<ScanForward>(H, cdt_bf16, xp_bf16, x_proj, h0, c0, w_hh, outs,
                                       cseq, hT, cT, w16, T, B, phases, stream);
}

// Inputs as the forward's plus its outs and cseq and the gradients g_outs
// (T, B, H, compute dtype), g_hT and g_cT (B, H, f32). Writes dx_proj
// (T, B, 4H) in x_proj's dtype, dh0, dc0 (B, H) and dw_hh (H, 4H), f32.
// Scratch: dw_part (splits, H, 4H) f32, and dg (T, B, 4H) in the compute
// dtype, null unless x_proj and the compute dtype differ; w16: bf16, W_hh
// and h0 rounded (H * 4H + B * H bf16), f32, W_hh^T (4H * H f32).
// phases: bf16, 2 runs the whole backward and 1 stops after the loop;
// f32, 3 runs it all and 1, 2 stop after the pre-pass, the loop (to time
// them).
int lstm_scan_backward(const void* x_proj, const float* h0, const float* c0,
                       const float* w_hh, const void* outs, const void* cseq,
                       const void* g_outs, const float* g_hT, const float* g_cT,
                       void* dx_proj, float* dh0, float* dc0, float* dw_hh, void* dg,
                       float* dw_part, void* w16, int T, int B, int H,
                       int cdt_bf16, int xp_bf16, int splits, int phases,
                       cudaStream_t stream) {
    if (T <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
    if (!lstm::aligned16(w_hh)) return (int)cudaErrorMisalignedAddress;
    return lstm::dispatch<ScanBackward>(H, cdt_bf16, xp_bf16, x_proj, h0, c0, w_hh, outs,
                                        cseq, g_outs, g_hT, g_cT, dx_proj, dh0, dc0, dw_hh,
                                        dg, dw_part, w16, T, B, splits, phases, stream);
}

// x: (T, B, D) in the compute dtype; h0, c0: (B, H); w_ih: (D, 4H), w_hh:
// (H, 4H); b: (4H,), all f32. Outputs as lstm_scan_forward's. Scratch:
// bf16, xw (T * 64 ceil(B / 64) * 4H) f32, the slab of lstm_tc.cuh, and
// w16 ((D + H) * 4H) bf16; f32 (lstm_f32.cuh, D == H), xw (T * B * 4H)
// f32, x @ W_ih + b, which the backward takes again, and a null w16.
// phases: 2 runs the whole forward, 1 stops after the pre-pass (to time
// it).
int lstm_fused_forward(const void* x, const float* h0, const float* c0,
                       const float* w_ih, const float* w_hh, const float* b, void* outs,
                       void* cseq, float* hT, float* cT, float* xw, void* w16, int T, int B,
                       int D, int H, int cdt_bf16, int phases, cudaStream_t stream) {
    if (T <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
    if (!lstm::aligned16(w_ih) || !lstm::aligned16(w_hh))
        return (int)cudaErrorMisalignedAddress;
    if (!xw || (cdt_bf16 && !w16)) return (int)cudaErrorInvalidValue;
    return lstm::dispatch<FusedForward>(H, cdt_bf16, x, h0, c0, w_ih, w_hh, b, outs, cseq,
                                        hT, cT, xw, w16, T, B, D, phases, stream);
}

// Writes dx (T, B, D, compute dtype), dh0, dc0 (B, H), dw = [dW_ih; dW_hh]
// (D + H, 4H) and db (4H,), f32. Scratch: dg (T, B, 4H) compute dtype,
// dw_part (splits, D + H, 4H) and db_part (part_rows, 4H) f32, part_rows =
// ceil(B / 64) in bf16 and ceil(B / 32) in f32 (the f32 loops' smallest
// tile); pre: bf16 as the forward's xw, f32 the activations (T * B * 4H)
// then W_ih^T and W_hh^T (4H * (D + H)). aux: bf16, scratch for the
// weights and h0 in bf16 ((D + H) * 4H + 4H * D + B * H); f32, the
// forward's xw, x @ W_ih + b, an input (the gates are h_prev @ W_hh plus
// it). phases: 4 runs the whole backward; 1 .. 3 stop after the pre-pass,
// the loop or dx (to time them).
int lstm_fused_backward(const void* x, const float* h0, const float* c0,
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
    return lstm::dispatch<FusedBackward>(H, cdt_bf16, x, h0, c0, w_ih, w_hh, b, outs, cseq,
                                         g_outs, g_hT, g_cT, dx, dh0, dc0, dw, db, dg,
                                         dw_part, db_part, pre, aux, T, B, D, splits,
                                         part_rows, phases, stream);
}

// Registers and spilled bytes per thread of the bf16 kernels of
// lstm_scan_fused at hidden size H (lstm::tc::usage): ten ints into out.
int lstm_fused_tc_usage(int H, int* out) { return lstm::tc::usage_at<lstm::FUSED>(H, out); }

// Those of lstm_scan's bf16 kernels (lstm::tc::xp_usage): ten ints
int lstm_scan_tc_usage(int H, int* out) { return lstm::tc::usage_at<lstm::XP>(H, out); }

// Registers and spilled bytes per thread of lstm_scan_fused's f32 kernels
// at hidden size H (lstm::f32::usage with two sums): sixteen ints into out.
int lstm_fused_f32_usage(int H, int* out) {
    switch (H) {
        case 32: return (int)lstm::f32::usage<32, false, true>(out);
        case 64: return (int)lstm::f32::usage<64, false, true>(out);
        case 128: return (int)lstm::f32::usage<128, false, true>(out);
    }
    return (int)cudaErrorInvalidValue;
}

// The tilings lstm_scan_fused's f32 loops take at B batch rows
// (lstm::f32::loop_plan with two sums): forward then backward, each
// (units a block, rows a thread, clusters the card holds at once); six
// ints into out.
int lstm_fused_f32_plan(int H, int B, int* out) {
    switch (H) {
        case 32: return (int)lstm::f32::loop_plan<32, true>(B, out);
        case 64: return (int)lstm::f32::loop_plan<64, true>(B, out);
        case 128: return (int)lstm::f32::loop_plan<128, true>(B, out);
    }
    return (int)cudaErrorInvalidValue;
}

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
