// Fused MBConv inner chain for inference, for Hopper (sm_90a).
//
// Replaces the TPU kernel metrabs_tpu/ops/mbconv_pallas.py::_kernel (wrapper
// fused_mbconv_inner). Between the two 1x1 convolutions of an EfficientNetV2
// MBConv block it computes, over the expanded tensor u [N, E, H, W] (NCHW):
//
//   v = silu(BN1(dw3x3(silu(BN0(u)))))   and   se_mean[n, e] = mean_hw v
//
// exactly as the plain version metrabs_tpu_torch/ops/mbconv.py does, operation
// for operation: each BN is a multiply and an add in u's dtype (its float32
// constants rounded to that dtype first, every result rounded), silu in
// float32 as x * (1 / (1 + exp(-x))) rounded back, the depthwise conv over the
// activated tensor with SAME zero padding and its 9 taps accumulated in
// float32 in (dy, dx) order, then cast; the SE mean is a float32 sum over v
// divided by H * W (here a block reduction, so its order differs).
//
// What bounds it on the card: bytes. Per element it reads 2 or 4 bytes, writes
// as many, and does ~30 flops plus two expf; the unfused chain it replaces
// moves the expanded tensor through device memory some ten times (BN, silu,
// pad, depthwise conv, BN, silu, mean, each a kernel). The design keeps every
// intermediate on chip: one thread block per (n, e) plane, which is
// contiguous in NCHW, so the block reads its plane once with coalesced loads,
// activates it into a zero-bordered tile in shared memory (rows in strips when
// a plane is large), reads the 9 taps from shared memory, writes v once, and
// reduces its plane's sum in registers and shared memory, so se_mean needs no
// atomics and no second pass. The TPU kernel's row tiles with clamped halo
// blocks and its cross-step SE accumulator existed for VMEM and the sequential
// grid; none of that carries over.
//
// Built with --fmad=false so that no multiply-add is contracted and each
// operation rounds as the unfused PyTorch operation does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kTileBytes = 32 * 1024;  // shared-memory tile budget per block
constexpr int kTileFloats = kTileBytes / sizeof(float);

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as PyTorch's cast
}

// Rounds a float32 value to T and back (identity for float).
template <typename T> __device__ __forceinline__ float rnd(float x) {
  return to_float(from_float<T>(x));
}

// silu(x) computed in float32 as the plain version's x * sigmoid(x).
__device__ __forceinline__ float silu_f32(float x) {
  const float sig = 1.0f / (1.0f + expf(-x));
  return x * sig;
}

// BN (multiply then add, each rounded to T) followed by silu, rounded to T.
template <typename T> __device__ __forceinline__ float bn_silu(float x, float s, float b) {
  const float y = rnd<T>(rnd<T>(x * s) + b);
  return rnd<T>(silu_f32(y));
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
mbconv_inner_kernel(const T* __restrict__ u, const float* __restrict__ dw,
                    const float* __restrict__ sb, T* __restrict__ v,
                    float* __restrict__ se_mean, int e_dim, int h, int w,
                    int strip_rows) {
  extern __shared__ float tile[];  // (strip_rows + 2) x (w + 2)
  __shared__ float warp_sums[kMaxThreads / 32];

  const int64_t plane = blockIdx.x;  // n * E + e
  const int e = (int)(plane % e_dim);
  const int64_t plane_len = (int64_t)h * w;
  const T* up = u + plane * plane_len;
  T* vp = v + plane * plane_len;

  // The BN constants as the plain version applies them: rounded to T.
  const float s0 = rnd<T>(sb[e]);
  const float b0 = rnd<T>(sb[e_dim + e]);
  const float s1 = rnd<T>(sb[2 * e_dim + e]);
  const float b1 = rnd<T>(sb[3 * e_dim + e]);
  float taps[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) taps[i] = dw[e * 9 + i];

  const int wp = w + 2;
  float local_sum = 0.0f;
  for (int r0 = 0; r0 < h; r0 += strip_rows) {
    const int rows = min(strip_rows, h - r0);
    // Activated strip plus a one-pixel zero border (the SAME padding of the
    // activated tensor); rows above and below the image are zero too.
    const int n_tile = (rows + 2) * wp;
    for (int i = threadIdx.x; i < n_tile; i += blockDim.x) {
      const int ty = i / wp;
      const int tx = i - ty * wp;
      const int y = r0 - 1 + ty;
      const int x = tx - 1;
      float a = 0.0f;
      if (y >= 0 && y < h && x >= 0 && x < w) a = bn_silu<T>(to_float(up[y * w + x]), s0, b0);
      tile[i] = a;
    }
    __syncthreads();
    const int n_out = rows * w;
    for (int i = threadIdx.x; i < n_out; i += blockDim.x) {
      const int oy = i / w;
      const int ox = i - oy * w;
      const float* t = tile + oy * wp + ox;
      float acc = 0.0f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) acc = acc + t[dy * wp + dx] * taps[dy * 3 + dx];
      }
      const T out = from_float<T>(bn_silu<T>(rnd<T>(acc), s1, b1));
      vp[(r0 + oy) * w + ox] = out;
      local_sum += to_float(out);
    }
    __syncthreads();  // the tile is rewritten by the next strip
  }

  // Block reduction of the plane's sum: warp shuffles, then warp 0.
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) local_sum += __shfl_down_sync(0xffffffffu, local_sum, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = local_sum;
  __syncthreads();
  if (warp == 0) {
    const int n_warps = (blockDim.x + 31) >> 5;
    float s = lane < n_warps ? warp_sums[lane] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) se_mean[plane] = s / (float)plane_len;
  }
}

template <typename T>
int launch(const void* u, const float* dw, const float* sb, void* v, float* se_mean,
           int n, int e, int h, int w, cudaStream_t stream) {
  const int64_t planes = (int64_t)n * e;
  if (planes <= 0 || h <= 0 || w <= 0) return (int)cudaSuccess;
  if (planes > 0x7fffffff || (int64_t)h * w > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int fit_rows = kTileFloats / (w + 2) - 2;
  if (fit_rows < 1) return (int)cudaErrorInvalidValue;  // a row does not fit the tile
  const int strip_rows = h < fit_rows ? h : fit_rows;
  const int64_t warps = ((int64_t)h * w + 31) / 32;
  const int threads = warps * 32 < kMaxThreads ? (int)(warps * 32) : kMaxThreads;
  const size_t smem = (size_t)(strip_rows + 2) * (w + 2) * sizeof(float);
  mbconv_inner_kernel<T><<<(unsigned)planes, threads, smem, stream>>>(
      static_cast<const T*>(u), dw, sb, static_cast<T*>(v), se_mean, e, h, w, strip_rows);
  return (int)cudaGetLastError();
}

}  // namespace

// u, v [n, e, h, w] contiguous, float32 (dtype 0) or bfloat16 (dtype 1);
// dw [e, 9] f32 (the 3x3 taps, row-major); sb [4, e] f32 (scale0, bias0,
// scale1, bias1); se_mean [n, e] f32; all device memory. Launches on `stream`
// and returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for
// a shape the kernel does not take.
extern "C" int metrabs_mbconv_inner(int dtype, const void* u, const float* dw,
                                    const float* sb, void* v, float* se_mean, int n,
                                    int e, int h, int w, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(u, dw, sb, v, se_mean, n, e, h, w, s);
  if (dtype == 1) return launch<__nv_bfloat16>(u, dw, sb, v, se_mean, n, e, h, w, s);
  return (int)cudaErrorInvalidValue;
}
