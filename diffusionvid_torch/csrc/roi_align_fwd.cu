// Multilevel ROIAlignV2 forward over three FPN levels (kernel K1).
//
// Replaces: diffusionvid_tpu/ops/roi_align_pallas.py: multilevel_roi_align_mxu
//   (the Pallas kernel _kernel_v4 and its variants _kernel_v3, _kernel_v2,
//   _kernel, which share one contract).
//
// Contract: level maps NHWC with channels contiguous ([B, Hl, Wl, C], float32
//   or bfloat16), rois [B, R, 4] float32 xyxy in image pixels, the level of
//   each ROI as int32 [B, R] (computed by the wrapper with the same
//   fpn_level_assignment as the plain version).  Output [B, R, 49, C] in
//   the maps' dtype, row-major (py, px): 7x7 bins, 2x2 samples per bin, the
//   aligned -0.5 offset, the CUDA border rule (zero below -1 or above the
//   size, clamped otherwise), fp32 accumulation, x1/4 for the sample mean.
//   Any R is taken; the Pallas kernel needed R % 50 == 0.
//
// What bounds it on an H100: bytes.  Each output element needs 16 bilinear
//   taps (4 samples x 4 corners, 32 flops), and at the flagship shape
//   (p3..p5 of 8 frames at 608x1024, 300 ROIs, C = 256, bf16) the least
//   traffic is one read of the maps (52 MB) and one write of the output
//   (60 MB), about 34 us at 3.35 TB/s; the flops need 14 us at the fp32 rate.
//
// Design: one block per (frame, ROI) and one thread per pair of adjacent
//   channels, so every tap is one 4-byte (bf16x2) or 8-byte (float2) load
//   that is coalesced along the NHWC row.  The 14 y and 14 x sample
//   positions (band start, band end, fraction, inside flag) are computed once
//   per block into shared memory; the coordinate arithmetic uses
//   round-to-nearest intrinsics with no fused multiply-add, so the sample
//   positions are bit-equal to the plain PyTorch version's.  The taps of one
//   ROI come mostly from L2: the kernel reads about 16 taps per output
//   element from cache, and that cache traffic, not device memory, is what a
//   later version should cut (stage the ROI's band rows in shared memory).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int P = 7;       // output bins per axis
constexpr int SR = 2;      // samples per bin per axis
constexpr int S = P * SR;  // sample positions per axis

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __float22bfloat162_rn(v);
}

// sum of 4 weighted taps, evaluated left to right without contraction
__device__ __forceinline__ float taps(float a, float wa, float b, float wb,
                                      float c, float wc, float d, float wd) {
  float s = __fmul_rn(a, wa);
  s = __fadd_rn(s, __fmul_rn(b, wb));
  s = __fadd_rn(s, __fmul_rn(c, wc));
  return __fadd_rn(s, __fmul_rn(d, wd));
}

template <typename T>
__global__ void roi_align_fwd_kernel(const T* __restrict__ f0,
                                     const T* __restrict__ f1,
                                     const T* __restrict__ f2,
                                     int h0, int w0, int h1, int w1, int h2,
                                     int w2, float s0, float s1, float s2,
                                     const float* __restrict__ rois,
                                     const int* __restrict__ level,
                                     T* __restrict__ out, int R, int C) {
  __shared__ int s_lo[2][S];
  __shared__ int s_hi[2][S];
  __shared__ float s_frac[2][S];
  __shared__ bool s_in[2][S];

  const int r = blockIdx.x;
  const int b = blockIdx.y;
  const size_t g = (size_t)b * R + r;
  const int lvl = level[g];
  const T* f = lvl == 0 ? f0 : (lvl == 1 ? f1 : f2);
  const int H = lvl == 0 ? h0 : (lvl == 1 ? h1 : h2);
  const int W = lvl == 0 ? w0 : (lvl == 1 ? w1 : w2);
  const float scale = lvl == 0 ? s0 : (lvl == 1 ? s1 : s2);

  if (threadIdx.x < 2 * S) {
    // thread k < S: y sample k; thread S + k: x sample k
    const int axis = threadIdx.x / S;
    const int k = threadIdx.x % S;
    const float* roi = rois + 4 * g;
    const float a1 = __fsub_rn(__fmul_rn(roi[axis == 0 ? 1 : 0], scale), 0.5f);
    const float a2 = __fsub_rn(__fmul_rn(roi[axis == 0 ? 3 : 2], scale), 0.5f);
    const float bin = __fdiv_rn(__fsub_rn(a2, a1), (float)P);
    const float grid = __fadd_rn(
        (float)(k / SR), __fdiv_rn(__fadd_rn((float)(k % SR), 0.5f), (float)SR));
    const float c = __fadd_rn(a1, __fmul_rn(bin, grid));
    const float size = (float)(axis == 0 ? H : W);
    const float cc = fminf(fmaxf(c, 0.f), size - 1.f);
    const float lo = floorf(cc);
    s_lo[axis][k] = (int)lo;
    s_hi[axis][k] = (int)fminf(lo + 1.f, size - 1.f);
    s_frac[axis][k] = __fsub_rn(cc, lo);
    s_in[axis][k] = (c >= -1.f) && (c <= size);
  }
  __syncthreads();

  const int c2 = 2 * threadIdx.x;
  const T* fb = f + (size_t)b * H * W * C + c2;
  T* o = out + g * (P * P) * (size_t)C + c2;

  for (int py = 0; py < P; ++py) {
    for (int px = 0; px < P; ++px) {
      float2 acc = make_float2(0.f, 0.f);
#pragma unroll
      for (int iy = 0; iy < SR; ++iy) {
        const int ky = py * SR + iy;
        if (!s_in[0][ky]) continue;
        const float ly = s_frac[0][ky];
        const float hy = __fsub_rn(1.f, ly);
        const T* row_lo = fb + (size_t)s_lo[0][ky] * W * C;
        const T* row_hi = fb + (size_t)s_hi[0][ky] * W * C;
#pragma unroll
        for (int ix = 0; ix < SR; ++ix) {
          const int kx = px * SR + ix;
          if (!s_in[1][kx]) continue;
          const float lx = s_frac[1][kx];
          const float hx = __fsub_rn(1.f, lx);
          const float wa = __fmul_rn(hy, hx), wb = __fmul_rn(hy, lx);
          const float wc = __fmul_rn(ly, hx), wd = __fmul_rn(ly, lx);
          const size_t xl = (size_t)s_lo[1][kx] * C;
          const size_t xh = (size_t)s_hi[1][kx] * C;
          const float2 va = load2(row_lo + xl), vb = load2(row_lo + xh);
          const float2 vc = load2(row_hi + xl), vd = load2(row_hi + xh);
          acc.x = __fadd_rn(acc.x, taps(va.x, wa, vb.x, wb, vc.x, wc, vd.x, wd));
          acc.y = __fadd_rn(acc.y, taps(va.y, wa, vb.y, wb, vc.y, wc, vd.y, wd));
        }
      }
      const float inv = 1.f / (SR * SR);
      store2(o + (size_t)(py * P + px) * C,
             make_float2(__fmul_rn(acc.x, inv), __fmul_rn(acc.y, inv)));
    }
  }
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16.  Launches on `stream`; returns
// cudaGetLastError() right after the launch.
extern "C" int roi_align_fwd(const void* f0, const void* f1, const void* f2,
                             int h0, int w0, int h1, int w1, int h2, int w2,
                             float s0, float s1, float s2, const void* rois,
                             const void* level, void* out, int B, int R,
                             int C, int dtype, void* stream) {
  const dim3 grid(R, B);
  const dim3 block(C / 2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    roi_align_fwd_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        static_cast<const __nv_bfloat16*>(f0), static_cast<const __nv_bfloat16*>(f1),
        static_cast<const __nv_bfloat16*>(f2), h0, w0, h1, w1, h2, w2, s0, s1, s2,
        static_cast<const float*>(rois), static_cast<const int*>(level),
        static_cast<__nv_bfloat16*>(out), R, C);
  } else {
    roi_align_fwd_kernel<float><<<grid, block, 0, st>>>(
        static_cast<const float*>(f0), static_cast<const float*>(f1),
        static_cast<const float*>(f2), h0, w0, h1, w1, h2, w2, s0, s1, s2,
        static_cast<const float*>(rois), static_cast<const int*>(level),
        static_cast<float*>(out), R, C);
  }
  return static_cast<int>(cudaGetLastError());
}
