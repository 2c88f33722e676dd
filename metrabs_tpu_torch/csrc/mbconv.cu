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
// divided by H * W (here summed in another order).
//
// What bounds it on the card: bytes in principle (2 or 4 bytes read and as
// many written per element), but the exact arithmetic costs more issue slots
// than the bytes cost time: per element two silus, 18 tap operations (no
// multiply-add may be contracted) and the roundings to bfloat16 that the
// plain version performs. The design keeps every intermediate on chip, keeps
// bytes in flight, and spends as few instructions as exactness allows:
//
// - Warp pipelines on a persistent grid: a few blocks per SM, and in each
//   block every warp walks its own steps of consecutive (n, e) planes (one
//   contiguous byte range of about kStepBytes, 16-byte aligned, sized so that
//   a step's runs keep at least 90% of the lanes busy; the last may be
//   ragged). A warp synchronises only with itself: no block barriers in the
//   loop.
// - Asynchronous staging: each step is copied with 16-byte cp.async into the
//   warp's two-deep ring in shared memory, the next step in flight while this
//   one is computed.
// - The step is activated once into a tile in u's dtype (the activation is
//   rounded to that dtype anyway), rows unpadded with zero rows above and
//   below; then each lane computes a run of R consecutive outputs of one row
//   (R = 8 in bf16, 4 in float32, fewer where R does not divide W) from a
//   3 x (R + 2) window read as one vector and two neighbours per row (zero
//   past the row's ends), and stores the run as one vector.
// - In bfloat16 each BN is the packed bf16x2 multiply and add (bit-identical,
//   see bn_silu_run), and a silu's input is then one of 65536 bf16 values:
//   a table of the exact silu of every bf16 value of magnitude in
//   [2^-10, 2^10), made once per device, is copied by each block into
//   shared memory, and the runs look their silus up there (silu_bf16_run);
//   the rest (zero, tiny or huge values, inf, NaN) are computed. The table
//   holds what the computation gives, so v is unchanged, without the exact
//   expf and division on the hot path.
// - The SE mean: each run's sum goes to the warp's shared memory; then one
//   lane adds a plane's runs where a plane has few, else the warp adds them
//   in a fixed order and a shuffle tree. No atomics, no second pass.
//
// A plane too large for a step (more than kStepMaxBytes) takes the row-strip
// kernel below, one block per plane, which activates strips of rows into a
// float tile. Both are built with --fmad=false so that no multiply-add is
// contracted and each operation rounds as the unfused PyTorch operation does.
//
// Probes, for measuring what a part of the warp kernel's work costs
// (scripts/torch_kernel_ab.py --probe; none is defined in a normal build, and
// each but the first makes v wrong): MBCONV_PROBE_FAST_SILU computes silu with
// __expf and __fdividef; MBCONV_PROBE_NO_ACT_MATH stores the raw input as the
// activation; MBCONV_PROBE_NO_OUT_MATH stores the rounded tap sum as v (no BN1,
// no silu); MBCONV_PROBE_NO_TAPS takes the window's centre as the tap sum.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;                  // depth of each warp's staging ring
constexpr int kStepBytes = 1024;            // bytes a warp step aims at
constexpr int kStepMaxBytes = 8 * 1024;     // above: the row-strip kernel
constexpr int kStripTileBytes = 32 * 1024;  // the strip kernel's float tile
constexpr int kStripTileFloats = kStripTileBytes / sizeof(float);
constexpr int kLaneSumRuns = 16;            // runs per plane up to which a lane sums a plane
// The bf16 silu table: entry i < kLutHalf is silu of the bf16 value with bits
// kLutFirst + i, entry kLutHalf + i that of its negative.
constexpr unsigned kLutFirst = (127u - 10u) << 7;  // the bits of 2^-10
constexpr unsigned kLutHalf = 20u << 7;            // 20 binades of 128 values
constexpr int kLutBytes = 2 * kLutHalf * sizeof(__nv_bfloat16);

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
#ifdef MBCONV_PROBE_FAST_SILU
  const float sig = __fdividef(1.0f, 1.0f + __expf(-x));
#else
  const float sig = 1.0f / (1.0f + expf(-x));
#endif
  return x * sig;
}

// BN (multiply then add, each rounded to T) followed by silu, rounded to T.
template <typename T> __device__ __forceinline__ float bn_silu(float x, float s, float b) {
  const float y = rnd<T>(rnd<T>(x * s) + b);
  return rnd<T>(silu_f32(y));
}

// silu of bf16 values as `bn_silu` rounds it, from the block's table where it
// holds the value. All R lookups are issued before the rare computed ones.
template <int R>
__device__ __forceinline__ void silu_bf16_run(const __nv_bfloat16* x, __nv_bfloat16* y,
                                              const __nv_bfloat16* lut) {
  unsigned computed = 0;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const unsigned bits = __bfloat16_as_ushort(x[j]);
    const unsigned i = (bits & 0x7fffu) - kLutFirst;  // wraps below the table
    const bool held = i < kLutHalf;
    computed |= (unsigned)!held << j;
    y[j] = lut[(held ? i : 0u) + (bits >> 15) * kLutHalf];
  }
  if (computed) {
#pragma unroll
    for (int j = 0; j < R; ++j)
      if (computed >> j & 1u) y[j] = __float2bfloat16(silu_f32(__bfloat162float(x[j])));
  }
}

// BN and silu of a run of R values, as `bn_silu` does each (`lut`: the
// block's silu table in bfloat16, unused in float32). In bfloat16 the BN
// takes the packed bf16x2 multiply and add: each rounds the exact result
// to bf16 once, which is what the plain version's float32 operation followed
// by its bf16 cast gives (float32 holds a product of two bf16 values exactly,
// and rounding a float32 sum to bf16 equals rounding the exact sum, as
// 24 >= 2 * 8 + 2 bits), so both forms give the same bits.
template <typename T, int R>
__device__ __forceinline__ void bn_silu_run(const T* x, T* y, float s, float b, const T* lut) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    alignas(16) T t[R];
    if constexpr (R % 2 == 0) {
      const __nv_bfloat162 s2 = __float2bfloat162_rn(s);  // s and b are bf16 values
      const __nv_bfloat162 b2 = __float2bfloat162_rn(b);
#pragma unroll
      for (int j = 0; j < R; j += 2)
        *reinterpret_cast<__nv_bfloat162*>(t + j) =
            __hadd2_rn(__hmul2_rn(*reinterpret_cast<const __nv_bfloat162*>(x + j), s2), b2);
    } else {
#pragma unroll
      for (int j = 0; j < R; ++j) t[j] = from_float<T>(rnd<T>(to_float(x[j]) * s) + b);
    }
    silu_bf16_run<R>(t, y, lut);
  } else {
#pragma unroll
    for (int j = 0; j < R; ++j) y[j] = from_float<T>(bn_silu<T>(to_float(x[j]), s, b));
  }
}

// An unsigned type of `Bytes` bytes, for vector loads and stores.
template <int Bytes> struct Vec;
template <> struct Vec<16> { using type = uint4; };
template <> struct Vec<8> { using type = uint2; };
template <> struct Vec<4> { using type = unsigned int; };
template <> struct Vec<2> { using type = unsigned short; };

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Division of a non-negative int below 2^31 by a divisor fixed at launch:
// a multiply-high and a shift in place of a division's ~20 instructions
// (round-up reciprocal, as in "Division by invariant integers using
// multiplication", Granlund and Montgomery).
struct FastDiv {
  unsigned d, mul, shift;
  FastDiv() = default;
  explicit FastDiv(unsigned divisor) : d(divisor), mul(0), shift(0) {
    if (divisor == 1) return;
    unsigned log2 = 0;
    while ((1ull << log2) < divisor) ++log2;  // ceil(log2(divisor))
    const unsigned p = 31 + log2;
    mul = (unsigned)(((1ull << p) + divisor - 1) / divisor);
    shift = p - 32;
  }
  __device__ __forceinline__ int div(int n) const {
    return d == 1 ? n : (int)(__umulhi((unsigned)n, mul) >> shift);
  }
  __device__ __forceinline__ int mod(int n) const { return n - div(n) * (int)d; }
};

// Geometry of the warp kernel, computed on the host.
struct WarpShape {
  int64_t planes;              // N * E
  int64_t n_steps;             // steps of step_planes planes, the last may be ragged
  int e_dim, h, w;
  int step_planes;             // a multiple that keeps every step 16-byte aligned
  int step_elems, tile_elems;  // each rounded up to 16 bytes
  int warp_bytes;              // shared memory of one warp: ring, tile, run sums
  FastDiv runs_per_plane, runs_per_row, channels;  // H * W / R, W / R, E
};

// Plane, row and first column of run r of a step.
__device__ __forceinline__ void run_position(const WarpShape& s, int r, int& p, int& y, int& x) {
  p = s.runs_per_plane.div(r);
  const int q = r - p * (int)s.runs_per_plane.d;
  y = s.runs_per_row.div(q);
  x = q - y * (int)s.runs_per_row.d;
}

// Starts one lane's part of the copy of step `step` into `stage`: 16-byte
// cp.async for the aligned body, plain loads for a ragged tail (only the last
// step of a shape whose size is not a multiple of 16 bytes has one).
template <typename T>
__device__ __forceinline__ void stage_step(const T* __restrict__ u, T* stage, int64_t step,
                                           const WarpShape& s, int lane) {
  const int64_t plane0 = step * s.step_planes;
  const int plane_len = s.h * s.w;
  const int n_planes = (int)min((int64_t)s.step_planes, s.planes - plane0);
  const int n_elems = n_planes * plane_len;
  const T* src = u + plane0 * plane_len;
  constexpr int kPer16 = 16 / sizeof(T);
  const int n16 = n_elems / kPer16;
  for (int c = lane; c < n16; c += 32) cp_async16(stage + c * kPer16, src + c * kPer16);
  for (int i = n16 * kPer16 + lane; i < n_elems; i += 32) stage[i] = src[i];
}

// The bf16 silu table in device memory, made once per device by
// silu_table_kernel (make_silu_table); each block of the bf16 warp kernel
// copies it into shared memory, before the warps' slices.
__device__ __align__(16) __nv_bfloat16 g_silu_lut[2 * kLutHalf];
template <typename T>
constexpr int kLutSmemBytes = std::is_same_v<T, __nv_bfloat16> ? kLutBytes : 0;

__global__ void silu_table_kernel() {
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2 * kLutHalf) return;
  const unsigned bits = (i >= kLutHalf ? 0x8000u : 0u) | (kLutFirst + i % kLutHalf);
  g_silu_lut[i] =
      __float2bfloat16(silu_f32(__bfloat162float(__ushort_as_bfloat16((unsigned short)bits))));
}

// Every warp runs its own pipeline over its own steps, in its own slice of
// shared memory, and synchronises only with itself (in bfloat16 the block
// synchronises once, when its copy of the silu table has landed).
template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
mbconv_warp_kernel(const T* __restrict__ u, const float* __restrict__ dw,
                   const float* __restrict__ sb, T* __restrict__ v,
                   float* __restrict__ se_mean, WarpShape s) {
  using VecT = typename Vec<R * sizeof(T)>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const T* lut = reinterpret_cast<const T*>(smem);
  T* stages = reinterpret_cast<T*>(smem + kLutSmemBytes<T> + (size_t)warp * s.warp_bytes);
  T* tile = stages + kStages * s.step_elems;
  float* run_sums = reinterpret_cast<float*>(tile + s.tile_elems);

  const int e_dim = s.e_dim, w = s.w;
  const int tile_plane = (s.h + 2) * w;
  const int plane_len = s.h * w;
  const int runs_per_plane = (int)s.runs_per_plane.d;

  // Image pixel (y, x) of plane p sits at tile[p][y + 1][x]; the zero rows
  // above and below, and the zero columns a window reads past the row ends,
  // are the SAME padding of the activated tensor. Only interiors are written
  // below, so the tile is zeroed once.
  for (int i = lane; i < s.tile_elems; i += 32) tile[i] = from_float<T>(0.0f);

  if constexpr (kLutSmemBytes<T> > 0) {
    const auto* table = reinterpret_cast<const unsigned char*>(g_silu_lut);
    for (int c = threadIdx.x; c < kLutBytes / 16; c += kThreads)
      cp_async16(smem + c * 16, table + c * 16);
    cp_async_commit();
  }
  const int64_t first = (int64_t)blockIdx.x * kWarps + warp;
  const int64_t stride = (int64_t)gridDim.x * kWarps;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    const int64_t step = first + i * stride;
    if (step < s.n_steps) stage_step(u, stages + i * s.step_elems, step, s, lane);
    cp_async_commit();
  }
  if constexpr (kLutSmemBytes<T> > 0) {
    cp_async_wait<kStages - 1>();  // the table's group, committed first, has landed
    __syncthreads();
  }
  int k = 0;
  for (int64_t step = first; step < s.n_steps; step += stride, ++k) {
    const int64_t ahead = step + (kStages - 1) * stride;
    if (ahead < s.n_steps)
      stage_step(u, stages + ((k + kStages - 1) % kStages) * s.step_elems, ahead, s, lane);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // this step's copies have landed
    __syncwarp();

    const T* raw = stages + (k % kStages) * s.step_elems;
    const int64_t plane0 = step * s.step_planes;
    const int e0 = s.channels.mod((int)plane0);  // planes < 2^31
    const int n_planes = (int)min((int64_t)s.step_planes, s.planes - plane0);
    const int n_runs = n_planes * runs_per_plane;

    // Activation: silu(BN0(u)) of each run into the tile's interior.
    for (int r = lane; r < n_runs; r += 32) {
      int p, y, x0;
      run_position(s, r, p, y, x0);
      x0 *= R;
      const int e = s.channels.mod(e0 + p);
      const float s0 = rnd<T>(__ldg(sb + e));
      const float b0 = rnd<T>(__ldg(sb + e_dim + e));
      alignas(16) T in[R];
      alignas(16) T act[R];
      *reinterpret_cast<VecT*>(in) = *reinterpret_cast<const VecT*>(raw + r * R);
#ifdef MBCONV_PROBE_NO_ACT_MATH
      *reinterpret_cast<VecT*>(act) = *reinterpret_cast<const VecT*>(in);
#else
      bn_silu_run<T, R>(in, act, s0, b0, lut);
#endif
      *reinterpret_cast<VecT*>(tile + p * tile_plane + (y + 1) * w + x0) =
          *reinterpret_cast<const VecT*>(act);
    }
    __syncwarp();

    // Depthwise 3x3, BN1, silu: R outputs per run from a 3 x (R + 2) window,
    // each window row one vector and its two neighbours (zero past the row's
    // ends).
    for (int r = lane; r < n_runs; r += 32) {
      int p, y, x0;
      run_position(s, r, p, y, x0);
      x0 *= R;
      const int e = s.channels.mod(e0 + p);
      float taps[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) taps[i] = __ldg(dw + e * 9 + i);
      const float s1 = rnd<T>(__ldg(sb + 2 * e_dim + e));
      const float b1 = rnd<T>(__ldg(sb + 3 * e_dim + e));
      float win[3][R + 2];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const T* row = tile + p * tile_plane + (y + dy) * w + x0;
        alignas(16) T mid[R];
        *reinterpret_cast<VecT*>(mid) = *reinterpret_cast<const VecT*>(row);
        win[dy][0] = x0 > 0 ? to_float(row[-1]) : 0.0f;
#pragma unroll
        for (int j = 0; j < R; ++j) win[dy][j + 1] = to_float(mid[j]);
        win[dy][R + 1] = x0 + R < w ? to_float(row[R]) : 0.0f;
      }
      alignas(16) T conv[R];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        float acc = 0.0f;
#ifdef MBCONV_PROBE_NO_TAPS
        acc = win[1][j + 1];
#else
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) acc = acc + win[dy][j + dx] * taps[dy * 3 + dx];
        }
#endif
        conv[j] = from_float<T>(acc);
      }
      alignas(16) T out[R];
#ifdef MBCONV_PROBE_NO_OUT_MATH
      *reinterpret_cast<VecT*>(out) = *reinterpret_cast<const VecT*>(conv);
#else
      bn_silu_run<T, R>(conv, out, s1, b1, lut);
#endif
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < R; ++j) sum += to_float(out[j]);
      *reinterpret_cast<VecT*>(v + (plane0 + p) * plane_len + y * w + x0) =
          *reinterpret_cast<const VecT*>(out);
      run_sums[r] = sum;
    }
    __syncwarp();

    // The SE mean of each plane, from its runs' sums in a fixed order: a
    // lane per plane where a plane has few runs, else the warp per plane,
    // each lane summing every 32nd run, then a shuffle tree.
    if (runs_per_plane <= kLaneSumRuns) {
      for (int p = lane; p < n_planes; p += 32) {
        float acc = 0.0f;
        for (int j = 0; j < runs_per_plane; ++j) acc += run_sums[p * runs_per_plane + j];
        se_mean[plane0 + p] = acc / (float)plane_len;
      }
    } else {
      for (int p = 0; p < n_planes; ++p) {
        float acc = 0.0f;
        for (int j = lane; j < runs_per_plane; j += 32) acc += run_sums[p * runs_per_plane + j];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
        if (lane == 0) se_mean[plane0 + p] = acc / (float)plane_len;
      }
    }
    // The next step rewrites the tile and the run sums only after the
    // __syncwarp that follows its wait, which every lane reaches after this.
  }
  cp_async_wait<0>();
}

// One block per (n, e) plane, rows in strips through a float tile: the form
// for planes larger than a warp step.
template <typename T>
__global__ void __launch_bounds__(kThreads)
mbconv_strip_kernel(const T* __restrict__ u, const float* __restrict__ dw,
                    const float* __restrict__ sb, T* __restrict__ v,
                    float* __restrict__ se_mean, int e_dim, int h, int w, int strip_rows) {
  extern __shared__ float strip_tile[];  // (strip_rows + 2) x (w + 2)
  __shared__ float warp_sums[kThreads / 32];

  const int64_t plane = blockIdx.x;  // n * E + e
  const int e = (int)(plane % e_dim);
  const int64_t plane_len = (int64_t)h * w;
  const T* up = u + plane * plane_len;
  T* vp = v + plane * plane_len;

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
    const int n_tile = (rows + 2) * wp;
    for (int i = threadIdx.x; i < n_tile; i += blockDim.x) {
      const int ty = i / wp;
      const int tx = i - ty * wp;
      const int y = r0 - 1 + ty;
      const int x = tx - 1;
      float a = 0.0f;
      if (y >= 0 && y < h && x >= 0 && x < w) a = bn_silu<T>(to_float(up[y * w + x]), s0, b0);
      strip_tile[i] = a;
    }
    __syncthreads();
    const int n_out = rows * w;
    for (int i = threadIdx.x; i < n_out; i += blockDim.x) {
      const int oy = i / w;
      const int ox = i - oy * w;
      const float* t = strip_tile + oy * wp + ox;
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

// Makes the bf16 silu table on the current device, once, and waits for it,
// so that launches on any stream find it.
int make_silu_table(cudaStream_t stream) {
  constexpr int kMaxDevices = 64;
  static bool made[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (made[device]) return (int)cudaSuccess;
  silu_table_kernel<<<(2 * kLutHalf + kThreads - 1) / kThreads, kThreads, 0, stream>>>();
  err = cudaGetLastError();
  if (err == cudaSuccess) err = cudaStreamSynchronize(stream);
  made[device] = err == cudaSuccess;
  return (int)err;
}

template <typename T, int R>
int launch_warps(const T* u, const float* dw, const float* sb, T* v, float* se_mean,
                 const WarpShape& s, int* per_sm, cudaStream_t stream) {
  if constexpr (kLutSmemBytes<T> > 0) {
    const int err = make_silu_table(stream);
    if (err != (int)cudaSuccess) return err;
  }
  const size_t smem = kLutSmemBytes<T> + (size_t)kWarps * s.warp_bytes;
  auto kernel = mbconv_warp_kernel<T, R>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess || *per_sm < 1) {
    cudaGetLastError();  // a refused size: the caller takes the strip kernel
    *per_sm = 0;
    return (int)cudaSuccess;
  }
  const int64_t wanted = (s.n_steps + kWarps - 1) / kWarps;
  const int64_t blocks = wanted < (int64_t)sms * *per_sm ? wanted : (int64_t)sms * *per_sm;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(u, dw, sb, v, se_mean, s);
  return (int)cudaGetLastError();
}

// The largest run length R <= max_r (a power of two) that divides w.
int run_length(int w, int max_r) {
  int r = max_r;
  while (w % r != 0) r >>= 1;
  return r;
}

template <typename T>
int launch(const void* u_ptr, const float* dw, const float* sb, void* v_ptr, float* se_mean,
           int n, int e, int h, int w, cudaStream_t stream) {
  const T* u = static_cast<const T*>(u_ptr);
  T* v = static_cast<T*>(v_ptr);
  const int64_t planes = (int64_t)n * e;
  if (planes <= 0 || h <= 0 || w <= 0) return (int)cudaSuccess;
  if (planes > 0x7fffffff || (int64_t)h * w > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)u_ptr | (uintptr_t)v_ptr) % 16 != 0) return (int)cudaErrorMisalignedAddress;

  // Planes per warp step: the least multiple of `align` (which keeps every
  // step 16-byte aligned) that reaches kStepBytes and keeps at least 90% of
  // the lanes busy in a step's last pass over its runs; at most
  // kStepMaxBytes, above which the strip kernel runs.
  constexpr int kPer16 = 16 / sizeof(T);
  const int r = run_length(w, kPer16);
  const int64_t runs_per_plane = (int64_t)h * (w / r);
  const int64_t plane_bytes = (int64_t)h * w * sizeof(T);
  int64_t align = 1;
  while ((align * plane_bytes) % 16 != 0) align *= 2;
  const int64_t planes_up = (planes + align - 1) / align * align;
  auto lanes_busy = [&](int64_t st) {
    const int64_t runs = st * runs_per_plane;
    return runs * 10 >= (runs + 31) / 32 * 32 * 9;
  };
  int64_t step = align;
  while (step < planes_up && step * plane_bytes <= kStepMaxBytes &&
         (step * plane_bytes < kStepBytes || !lanes_busy(step)))
    step += align;
  if (step * plane_bytes <= kStepMaxBytes) {
    WarpShape s;
    s.planes = planes;
    s.n_steps = (planes + step - 1) / step;
    s.e_dim = e;
    s.h = h;
    s.w = w;
    s.step_planes = (int)step;
    s.step_elems = (int)((step * h * w + kPer16 - 1) / kPer16 * kPer16);
    s.tile_elems = (int)((step * (h + 2) * w + kPer16 - 1) / kPer16 * kPer16);
    const int64_t runs = step * runs_per_plane;
    s.warp_bytes = (int)(((int64_t)kStages * s.step_elems + s.tile_elems) * sizeof(T) +
                         (runs * sizeof(float) + 15) / 16 * 16);
    s.runs_per_plane = FastDiv((unsigned)(h * (w / r)));
    s.runs_per_row = FastDiv((unsigned)(w / r));
    s.channels = FastDiv((unsigned)e);
    int per_sm = 0, err;
    if (r == kPer16) {
      err = launch_warps<T, kPer16>(u, dw, sb, v, se_mean, s, &per_sm, stream);
    } else if (r == 4) {
      err = launch_warps<T, 4>(u, dw, sb, v, se_mean, s, &per_sm, stream);
    } else if (r == 2) {
      err = launch_warps<T, 2>(u, dw, sb, v, se_mean, s, &per_sm, stream);
    } else {
      err = launch_warps<T, 1>(u, dw, sb, v, se_mean, s, &per_sm, stream);
    }
    if (err != (int)cudaSuccess || per_sm > 0) return err;
  }

  const int fit_rows = kStripTileFloats / (w + 2) - 2;
  if (fit_rows < 1) return (int)cudaErrorInvalidValue;  // a row does not fit the tile
  const int strip_rows = h < fit_rows ? h : fit_rows;
  const int64_t warps = ((int64_t)h * w + 31) / 32;
  const int threads = warps * 32 < kThreads ? (int)(warps * 32) : kThreads;
  const size_t smem = (size_t)(strip_rows + 2) * (w + 2) * sizeof(float);
  mbconv_strip_kernel<T><<<(unsigned)planes, threads, smem, stream>>>(u, dw, sb, v, se_mean, e,
                                                                       h, w, strip_rows);
  return (int)cudaGetLastError();
}

}  // namespace

// u, v [n, e, h, w] contiguous and 16-byte aligned, float32 (dtype 0) or
// bfloat16 (dtype 1); dw [e, 9] f32 (the 3x3 taps, row-major); sb [4, e] f32
// (scale0, bias0, scale1, bias1); se_mean [n, e] f32; all device memory.
// Launches on `stream` and returns cudaGetLastError() (0 on success), or a
// CUDA error code for a shape or pointer the kernel does not take.
extern "C" int metrabs_mbconv_inner(int dtype, const void* u, const float* dw,
                                    const float* sb, void* v, float* se_mean, int n,
                                    int e, int h, int w, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(u, dw, sb, v, se_mean, n, e, h, w, s);
  if (dtype == 1) return launch<__nv_bfloat16>(u, dw, sb, v, se_mean, n, e, h, w, s);
  return (int)cudaErrorInvalidValue;
}
