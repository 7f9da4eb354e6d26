// Fused Default-MLP forward, for Hopper (sm_90a):
//
//   out = relu(x @ w1 + b1) @ w2 + b2          x (B, F), out (B, O) float32
//
// Replaces the TPU kernel pufferlib_tpu/ops/pallas/mlp.py (mlp_head_fwd /
// _fwd_kernel). Same function as the plain
// pufferlib_tpu_torch.ops.cuda.mlp.mlp_head_reference: x and the weights
// round to the compute dtype cdt (bf16 or f32), products accumulate in
// f32, the hidden layer rounds to cdt after the relu, biases stay f32.
//
// Bound: at the trainer's shapes (F=49, H=128, O=9, B up to 131072) the
// work is 2*B*(F*H + H*O) = 15 kflop per row against 98 bytes of bf16
// input and 36 bytes of output per row. Against the tensor-core bf16 peak
// that is bytes-bound; against the f32 FMA peak (the route this kernel
// takes) it is flop-bound. Either way the saving over two separate layers
// is the (B, H) hidden activation, which never reaches device memory.
//
// Design: the weights (w1 F x H and w2 H x O, 29 KB in f32 at the trainer
// shapes) and biases are staged once per block in shared memory, already
// rounded to cdt. Blocks are persistent: the grid is what fits on the
// card at once, and each block walks row tiles of ROWS rows, so the
// weights are read once per block, not once per tile. Per tile: the x
// tile is copied to shared memory (one contiguous, coalesced span), each
// thread computes hidden units of the tile (a warp shares one row and
// reads consecutive w1 columns: broadcast plus conflict-free), the rounded
// hidden tile stays in shared memory, and the O outputs per row are
// dotted from it. Rows past B are masked. Plain FMA loops, no tensor
// cores: F=49 and O=9 are not multiples of the mma tile, and this kernel
// is meant to be right first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 32;
constexpr int MAX_SMEM = 227 * 1024;

template <bool BF16>
__device__ __forceinline__ float to_cdt(float v) {
    if (BF16) return __bfloat162float(__float2bfloat16_rn(v));
    return v;
}

__device__ __forceinline__ float load(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, size_t i) {
    return __bfloat162float(p[i]);
}

template <typename Tin, bool BF16>
__global__ void __launch_bounds__(THREADS) mlp_head_kernel(
        const Tin* __restrict__ x, const float* __restrict__ w1,
        const float* __restrict__ b1, const float* __restrict__ w2,
        const float* __restrict__ b2, float* __restrict__ out,
        int B, int F, int H, int O) {
    extern __shared__ float smem[];
    float* w1s = smem;              // F * H
    float* w2s = w1s + F * H;       // H * O
    float* b1s = w2s + H * O;       // H
    float* b2s = b1s + H;           // O
    float* xs = b2s + O;            // ROWS * F
    float* hs = xs + ROWS * F;      // ROWS * H

    for (int i = threadIdx.x; i < F * H; i += THREADS) w1s[i] = to_cdt<BF16>(w1[i]);
    for (int i = threadIdx.x; i < H * O; i += THREADS) w2s[i] = to_cdt<BF16>(w2[i]);
    for (int i = threadIdx.x; i < H; i += THREADS) b1s[i] = b1[i];
    for (int i = threadIdx.x; i < O; i += THREADS) b2s[i] = b2[i];

    const int tiles = (B + ROWS - 1) / ROWS;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        // weights staged, and the previous tile's xs/hs fully consumed
        __syncthreads();
        const size_t row0 = (size_t)tile * ROWS;
        const int rows = min(ROWS, B - (int)row0);
        for (int i = threadIdx.x; i < ROWS * F; i += THREADS)
            xs[i] = i < rows * F ? to_cdt<BF16>(load(x, row0 * F + i)) : 0.f;
        __syncthreads();

        for (int i = threadIdx.x; i < rows * H; i += THREADS) {
            const int r = i / H;
            const int j = i - r * H;
            const float* xr = xs + r * F;
            float acc = 0.f;
            for (int k = 0; k < F; ++k) acc = fmaf(xr[k], w1s[k * H + j], acc);
            acc += b1s[j];
            // relu that keeps a NaN, as jax.nn.relu does
            hs[i] = to_cdt<BF16>(acc < 0.f ? 0.f : acc);
        }
        __syncthreads();

        for (int i = threadIdx.x; i < rows * O; i += THREADS) {
            const int r = i / O;
            const int o = i - r * O;
            const float* hr = hs + r * H;
            float acc = 0.f;
            for (int j = 0; j < H; ++j) acc = fmaf(hr[j], w2s[j * O + o], acc);
            out[row0 * O + i] = acc + b2s[o];
        }
    }
}

size_t smem_bytes(int F, int H, int O) {
    return sizeof(float) *
        ((size_t)F * H + (size_t)H * O + H + O + (size_t)ROWS * F + (size_t)ROWS * H);
}

template <typename Tin, bool BF16>
int launch(const void* x, const float* w1, const float* b1, const float* w2,
           const float* b2, float* out, int B, int F, int H, int O,
           cudaStream_t stream) {
    auto kernel = mlp_head_kernel<Tin, BF16>;
    const size_t smem = smem_bytes(F, H, O);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    int device = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      device)) != cudaSuccess)
        return (int)err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, THREADS, smem)) != cudaSuccess)
        return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const int tiles = (B + ROWS - 1) / ROWS;
    const int blocks = tiles < sms * per_sm ? tiles : sms * per_sm;
    kernel<<<blocks, THREADS, smem, stream>>>(
        static_cast<const Tin*>(x), w1, b1, w2, b2, out, B, F, H, O);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (B, F) row-major, bfloat16 when x_bf16 else float32. w1: (F, H),
// b1: (H,), w2: (H, O), b2: (O,), all float32; out: (B, O) float32.
// cdt_bf16 selects the compute dtype (bf16 or f32).
int mlp_head_forward(const void* x, int x_bf16, const float* w1,
                     const float* b1, const float* w2, const float* b2,
                     float* out, int B, int F, int H, int O, int cdt_bf16,
                     cudaStream_t stream) {
    if (B <= 0 || F <= 0 || H <= 0 || O <= 0) return (int)cudaErrorInvalidValue;
    if (smem_bytes(F, H, O) > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
    if (x_bf16) {
        if (cdt_bf16)
            return launch<__nv_bfloat16, true>(x, w1, b1, w2, b2, out, B, F, H, O, stream);
        return launch<__nv_bfloat16, false>(x, w1, b1, w2, b2, out, B, F, H, O, stream);
    }
    if (cdt_bf16)
        return launch<float, true>(x, w1, b1, w2, b2, out, B, F, H, O, stream);
    return launch<float, false>(x, w1, b1, w2, b2, out, B, F, H, O, stream);
}

const char* cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
