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
// bound by operations (about 0.10 ms).
//
// Design of lstm_scan (csrc/lstm_common.cuh, mode XP): the cell kernels of
// lstm_cat.cu with a second accumulator, so that the two sums the TPU
// kernel keeps apart are rounded apart here too. It streams only W_hh
// (K = H), reads x_proj_t into registers before the recurrent product and
// adds it after; dx_proj doubles as the dgates slab of the post-loop
// split-K contraction dW_hh = h_prev^T dg, which rounds it to the compute
// dtype as it loads (a separate slab only for bf16 x_proj under f32
// compute). The TPU kernels add dW tile after tile into one block; here
// each K-split writes a partial sum and a second pass adds them in order.
// The recurrent kernels run plain f32 FMA; the contraction runs on the
// bf16 tensor cores.
//
// Design of lstm_scan_fused, chosen by the compute dtype, the only branch:
// * bf16: csrc/lstm_tc.cuh in mode FUSED, every product on the tensor
//   cores: the projections in GEMMs over all T*B rows before and after the
//   loops, and loops that hold W_hh in shared memory and keep only the
//   recurrent product. Its scratch: an f32 slab of the projections (XW or
//   P) and the bf16 weights. The input width D is free (a multiple of 8,
//   up to what a GEMM block's shared memory holds).
// * f32: mode FUSED of csrc/lstm_common.cuh, the cat kernels with a second
//   accumulator, on FMA, D == H: f32 is the exact test mode, and the
//   tensor cores have no exact f32 product. Its scratch pointers are null.
#include "lstm_common.cuh"
#include "lstm_tc.cuh"

namespace {

template <int H, typename E>
struct ScanForward {
    template <typename S>
    static cudaError_t run_as(const void* x_proj, const float* h0, const float* c0,
                              const float* w_hh, void* outs, void* cseq, float* hT,
                              float* cT, int T, int B, cudaStream_t stream) {
        return lstm::run_forward<H, E, S, lstm::XP>(x_proj, h0, c0, nullptr, nullptr,
                                                    nullptr, w_hh, nullptr, outs, cseq, hT,
                                                    cT, T, B, 0, stream);
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
                              float* dw_part, int T, int B, int splits,
                              cudaStream_t stream) {
        return lstm::run_backward<H, E, S, lstm::XP>(
            x_proj, h0, c0, nullptr, nullptr, nullptr, w_hh, nullptr, outs, cseq, g_outs,
            g_hT, g_cT, dh0, dc0, nullptr, nullptr, dw_hh, nullptr, dx_proj, nullptr, dg,
            dw_part, nullptr, nullptr, nullptr, T, B, 0, splits, 0,
            (B + lstm::BT - 1) / lstm::BT, stream);
    }
    template <typename... Args>
    static cudaError_t run(int xp_bf16, Args... args) {
        return xp_bf16 ? run_as<lstm::bf16>(args...) : run_as<float>(args...);
    }
};

template <int H, typename E>
struct FusedForward : lstm::tc::CellForward<lstm::FUSED, H, E> {};

template <int H, typename E>
struct FusedBackward : lstm::tc::CellBackward<lstm::FUSED, H, E> {};

}  // namespace

extern "C" {

// x_proj: (T, B, 4H), bf16 when xp_bf16, else f32; h0, c0: (B, H); w_hh:
// (H, 4H), f32. Writes outs and, unless it is null, cseq (T, B, H) in the
// compute dtype (bf16 when cdt_bf16, else f32), hT and cT (B, H) f32.
int lstm_scan_forward(const void* x_proj, const float* h0, const float* c0,
                      const float* w_hh, void* outs, void* cseq, float* hT, float* cT,
                      int T, int B, int H, int cdt_bf16, int xp_bf16,
                      cudaStream_t stream) {
    if (T <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
    if (!lstm::aligned16(w_hh)) return (int)cudaErrorMisalignedAddress;
    return lstm::dispatch<ScanForward>(H, cdt_bf16, xp_bf16, x_proj, h0, c0, w_hh, outs,
                                       cseq, hT, cT, T, B, stream);
}

// Inputs as the forward's plus its outs and cseq and the gradients g_outs
// (T, B, H, compute dtype), g_hT and g_cT (B, H, f32). Writes dx_proj
// (T, B, 4H) in x_proj's dtype, dh0, dc0 (B, H) and dw_hh (H, 4H), f32.
// Scratch: dw_part (splits, H, 4H) f32, and dg (T, B, 4H) in the compute
// dtype, which is null unless x_proj is bf16 and the compute dtype f32.
int lstm_scan_backward(const void* x_proj, const float* h0, const float* c0,
                       const float* w_hh, const void* outs, const void* cseq,
                       const void* g_outs, const float* g_hT, const float* g_cT,
                       void* dx_proj, float* dh0, float* dc0, float* dw_hh, void* dg,
                       float* dw_part, int T, int B, int H, int cdt_bf16, int xp_bf16,
                       int splits, cudaStream_t stream) {
    if (T <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
    if (!lstm::aligned16(w_hh)) return (int)cudaErrorMisalignedAddress;
    return lstm::dispatch<ScanBackward>(H, cdt_bf16, xp_bf16, x_proj, h0, c0, w_hh, outs,
                                        cseq, g_outs, g_hT, g_cT, dx_proj, dh0, dc0, dw_hh,
                                        dg, dw_part, T, B, splits, stream);
}

// x: (T, B, D) in the compute dtype; h0, c0: (B, H); w_ih: (D, 4H), w_hh:
// (H, 4H); b: (4H,), all f32. Outputs as lstm_scan_forward's. Scratch,
// bf16 only (null in f32): xw (T * 64 ceil(B / 64) * 4H) f32, the slab of
// lstm_tc.cuh, and w16 ((D + H) * 4H) bf16. f32 takes D == H. phases: 2
// runs the whole forward; in bf16, 1 stops after the pre-pass (to time it).
int lstm_fused_forward(const void* x, const float* h0, const float* c0,
                       const float* w_ih, const float* w_hh, const float* b, void* outs,
                       void* cseq, float* hT, float* cT, float* xw, void* w16, int T, int B,
                       int D, int H, int cdt_bf16, int phases, cudaStream_t stream) {
    if (T <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
    if (!lstm::aligned16(w_ih) || !lstm::aligned16(w_hh))
        return (int)cudaErrorMisalignedAddress;
    if (cdt_bf16 && (!xw || !w16)) return (int)cudaErrorInvalidValue;
    return lstm::dispatch<FusedForward>(H, cdt_bf16, x, h0, c0, w_ih, w_hh, b, outs, cseq,
                                        hT, cT, xw, w16, T, B, D, phases, stream);
}

// Writes dx (T, B, D, compute dtype), dh0, dc0 (B, H), dw = [dW_ih; dW_hh]
// (D + H, 4H) and db (4H,), f32. Scratch: dg (T, B, 4H) compute dtype,
// dw_part (splits, D + H, 4H) and db_part (part_rows, 4H) f32, part_rows =
// ceil(B / 64) in bf16 and ceil(B / 32) in f32; bf16 only (null in f32):
// pre (as the forward's xw) f32 and w16 ((D + H) * 4H + 4H * D + B * H)
// bf16. phases: 4 runs the whole backward; in bf16, 1 .. 3 stop after the
// pre-pass, the loop or dx (to time them).
int lstm_fused_backward(const void* x, const float* h0, const float* c0,
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
    return lstm::dispatch<FusedBackward>(H, cdt_bf16, x, h0, c0, w_ih, w_hh, b, outs, cseq,
                                         g_outs, g_hT, g_cT, dx, dh0, dc0, dw, db, dg,
                                         dw_part, db_part, pre, w16, T, B, D, splits,
                                         part_rows, phases, stream);
}

// Registers and spilled bytes per thread of the bf16 kernels of
// lstm_scan_fused at hidden size H (lstm::tc::usage): ten ints into out.
int lstm_fused_tc_usage(int H, int* out) { return lstm::tc::usage_at<lstm::FUSED>(H, out); }

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
