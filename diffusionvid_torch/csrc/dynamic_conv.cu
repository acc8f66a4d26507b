// Fused DynamicConv instance interaction (kernel K2).
//
// Replaces: diffusionvid_tpu/ops/dynamic_conv_pallas.py: dynamic_conv_fused
//   (the Pallas kernel _kernel).
//
// Contract, per proposal s of S:
//   a   = roi[s] @ p1t[s]^T             [49, 256] x [64, 256]^T -> [49, 64]
//   x1  = relu(LN64(round(a)))          rounded to the compute dtype
//   c   = x1 @ p2e[s]                   [49, 64] x [64, 256]   -> [49, 256]
//   out = relu(LN256(round(c)))         in the compute dtype
// roi [S, 49, 256], p1t and p2e [S, 64, 256] (e-major), float32 or bfloat16;
// LayerNorm weights and biases float32; products accumulate in fp32 and are
// rounded to the compute dtype before each fp32 LayerNorm, as in
// models/heads.py: DynamicConv and the Pallas kernel.
//
// What bounds it on an H100: bytes.  At the flagship shape (S = 2400 = 8
//   frames x 300 proposals, bf16) the least traffic is one read of roi, p1t,
//   p2e and one write of the output, 278 MB or 83 us at 3.35 TB/s; the two
//   products are 7.7 GFLOP, 8 us at the bf16 tensor-core rate.
//
// Design: one block of 256 threads per proposal.  The block stages roi, p1t
//   and p2e in dynamic shared memory (103 KB in bf16, 194 KB in fp32), so
//   device memory sees each input once and the output once.  The first
//   product gives each thread one e column and every fourth pooled row
//   (13 accumulators); p1t's rows are padded by one 4-byte word so the 32
//   lanes of a warp, which read 32 different rows, hit 32 banks.  The
//   64-wide LayerNorm runs one warp per row with shuffle reductions.  The
//   second product gives each thread one output channel and all 49 rows in
//   registers; its rounded result is staged in shared memory over the
//   roi/p1t region, which is dead by then, for the 256-wide LayerNorm.  The
//   products run on the fp32 CUDA cores, so at this size the kernel is bound
//   by shared-memory reads and fp32 issue rather than by device memory;
//   mma.sync or wgmma tiles over several proposals are the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int P = 49;         // pooled positions
constexpr int E = 64;         // dynamic dim
constexpr int D = 256;        // hidden dim
constexpr int THREADS = 256;  // == D
constexpr int ROWS1 = (P + 3) / 4;  // first-product rows per thread

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// round an fp32 value to the compute dtype and back
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float2 load2(const float* p) { return make_float2(p[0], p[1]); }
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
struct Smem {
  static constexpr int PAD = 4 / sizeof(T);  // one 4-byte word per p1t row
  static constexpr int LD1 = D + PAD;
  static constexpr size_t ROI = 0;
  static constexpr size_t P1 = ROI + sizeof(T) * P * D;
  static constexpr size_t P2 = P1 + sizeof(T) * E * LD1;
  static constexpr size_t X1 = P2 + sizeof(T) * E * D;
  static constexpr size_t BYTES = X1 + sizeof(float) * P * E;
  static_assert(sizeof(float) * P * D <= P2, "staged output must fit over roi/p1t");
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
dynamic_conv_kernel(const T* __restrict__ roi, const T* __restrict__ p1t,
                    const T* __restrict__ p2e, const float* __restrict__ g1,
                    const float* __restrict__ b1, const float* __restrict__ g2,
                    const float* __restrict__ b2, T* __restrict__ out, float eps) {
  using L = Smem<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_roi = reinterpret_cast<T*>(smem + L::ROI);
  T* s_p1 = reinterpret_cast<T*>(smem + L::P1);
  T* s_p2 = reinterpret_cast<T*>(smem + L::P2);
  float* s_x1 = reinterpret_cast<float*>(smem + L::X1);
  float* s_out = reinterpret_cast<float*>(smem + L::ROI);  // over roi/p1t

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t s = blockIdx.x;

  // ---- stage the proposal's operands (16-byte copies; p1t by 4-byte words
  // into padded rows)
  {
    const uint4* src = reinterpret_cast<const uint4*>(roi + s * P * D);
    uint4* dst = reinterpret_cast<uint4*>(s_roi);
    for (int i = tid; i < (int)(sizeof(T) * P * D / 16); i += THREADS) dst[i] = src[i];
    src = reinterpret_cast<const uint4*>(p2e + s * E * D);
    dst = reinterpret_cast<uint4*>(s_p2);
    for (int i = tid; i < (int)(sizeof(T) * E * D / 16); i += THREADS) dst[i] = src[i];
    constexpr int WD = sizeof(T) * D / 4;      // words per p1t row
    constexpr int WD1 = sizeof(T) * L::LD1 / 4;  // padded
    const uint32_t* w_src = reinterpret_cast<const uint32_t*>(p1t + s * E * D);
    uint32_t* w_dst = reinterpret_cast<uint32_t*>(s_p1);
    for (int i = tid; i < E * WD; i += THREADS) w_dst[(i / WD) * WD1 + i % WD] = w_src[i];
  }
  __syncthreads();

  // ---- a = roi @ p1t^T: thread -> (e, rows pg, pg+4, ...)
  {
    const int e = tid % E, pg = tid / E;
    float acc[ROWS1];
#pragma unroll
    for (int j = 0; j < ROWS1; ++j) acc[j] = 0.f;
    const T* w_row = s_p1 + e * L::LD1;
    for (int d = 0; d < D; d += 2) {
      const float2 w = load2(w_row + d);
#pragma unroll
      for (int j = 0; j < ROWS1; ++j) {
        const int p = pg + 4 * j;
        if (p < P) {
          const float2 a = load2(s_roi + p * D + d);
          acc[j] = fmaf(a.x, w.x, acc[j]);
          acc[j] = fmaf(a.y, w.y, acc[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < ROWS1; ++j) {
      const int p = pg + 4 * j;
      if (p < P) s_x1[p * E + e] = round_to<T>(acc[j]);
    }
  }
  __syncthreads();

  // ---- x1 = relu(LN64(a)), rounded; one warp per row
  {
    const float ga = g1[lane], gb = g1[lane + 32];
    const float ba = b1[lane], bb = b1[lane + 32];
    for (int p = warp; p < P; p += THREADS / 32) {
      const float v0 = s_x1[p * E + lane], v1 = s_x1[p * E + lane + 32];
      const float mu = warp_sum(v0 + v1) / E;
      const float d0 = v0 - mu, d1 = v1 - mu;
      const float var = warp_sum(d0 * d0 + d1 * d1) / E;
      const float inv = 1.f / sqrtf(var + eps);
      s_x1[p * E + lane] = round_to<T>(fmaxf(d0 * inv * ga + ba, 0.f));
      s_x1[p * E + lane + 32] = round_to<T>(fmaxf(d1 * inv * gb + bb, 0.f));
    }
  }
  __syncthreads();

  // ---- c = x1 @ p2e: thread -> output channel tid, all 49 rows
  {
    float acc[P];
#pragma unroll
    for (int p = 0; p < P; ++p) acc[p] = 0.f;
    for (int e = 0; e < E; ++e) {
      const float w = to_f(s_p2[e * D + tid]);
#pragma unroll
      for (int p = 0; p < P; ++p) acc[p] = fmaf(s_x1[p * E + e], w, acc[p]);
    }
    // s_out overlays roi/p1t, which no thread reads after the first product
#pragma unroll
    for (int p = 0; p < P; ++p) s_out[p * D + tid] = round_to<T>(acc[p]);
  }
  __syncthreads();

  // ---- out = relu(LN256(c)); one warp per row, lane owns channels lane + 32k
  {
    constexpr int K = D / 32;
    float g[K], bt[K];
#pragma unroll
    for (int k = 0; k < K; ++k) { g[k] = g2[lane + 32 * k]; bt[k] = b2[lane + 32 * k]; }
    T* o = out + s * P * D;
    for (int p = warp; p < P; p += THREADS / 32) {
      float v[K], sum = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) { v[k] = s_out[p * D + lane + 32 * k]; sum += v[k]; }
      const float mu = warp_sum(sum) / D;
      float sq = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) { v[k] -= mu; sq += v[k] * v[k]; }
      const float inv = 1.f / sqrtf(warp_sum(sq) / D + eps);
#pragma unroll
      for (int k = 0; k < K; ++k)
        o[p * D + lane + 32 * k] = from_f<T>(fmaxf(v[k] * inv * g[k] + bt[k], 0.f));
    }
  }
}

template <typename T>
cudaError_t launch(const void* roi, const void* p1t, const void* p2e,
                   const void* g1, const void* b1, const void* g2,
                   const void* b2, void* out, int S, float eps,
                   cudaStream_t st) {
  const size_t bytes = Smem<T>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      dynamic_conv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dynamic_conv_kernel<T><<<S, THREADS, bytes, st>>>(
      static_cast<const T*>(roi), static_cast<const T*>(p1t),
      static_cast<const T*>(p2e), static_cast<const float*>(g1),
      static_cast<const float*>(b1), static_cast<const float*>(g2),
      static_cast<const float*>(b2), static_cast<T*>(out), eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16.  Launches on `stream`; returns the
// launch's cudaGetLastError().
extern "C" int dynamic_conv_fwd(const void* roi, const void* p1t, const void* p2e,
                                const void* g1, const void* b1, const void* g2,
                                const void* b2, void* out, int S, float eps,
                                int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1
      ? launch<__nv_bfloat16>(roi, p1t, p2e, g1, b1, g2, b2, out, S, eps, st)
      : launch<float>(roi, p1t, p2e, g1, b1, g2, b2, out, S, eps, st);
  return static_cast<int>(err);
}
