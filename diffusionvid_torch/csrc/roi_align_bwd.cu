// Multilevel ROIAlignV2 feature gradient over three FPN levels (kernel K3).
//
// Replaces: diffusionvid_tpu/ops/roi_align_pallas.py: multilevel_roi_align_bwd_mxu
//   (the Pallas kernel _bwd_kernel, one pallas_call per level), reached from
//   the custom VJP ops/roi_align.py: _pra_bwd.
//
// Contract: the cotangent g [B, R, 49, C] row-major (py, px), float32 or
//   bfloat16; rois [B, R, 4] float32 xyxy in image pixels; the level of each
//   ROI as int32 [B, R] (the forward's).  Output: one gradient map per level,
//   [B, Hl, Wl, C] NHWC in g's dtype, accumulated in fp32 and written once
//   (no memset, no separate cast).  Each sample of a ROI adds
//   g[py, px] * wy * wx / 4 into the two-by-two corner cells of its band: the
//   weights follow _band_params (CUDA border rule, zero outside [-1, size], a
//   sample in the last cell puts its whole weight on the upper slot).  ROIs of
//   another level add nothing.  The ROI gradient is zero and not computed.
//   The sample coordinates are K1's (csrc/roi_align_fwd.cu), computed with the
//   same round-to-nearest intrinsics and no fused multiply-add.
//
// What bounds it on an H100: bytes.  At the flagship train shape (p3..p5 of
//   5 frames at 608x1024, 300 ROIs, C = 256, bf16) it must read g (37.6 MB)
//   and write the three maps (32.7 MB): about 21 us at 3.35 TB/s.  The
//   arithmetic, about 0.6 GFLOP in fp32, needs 9 us at 67 TFLOP/s.
//
// Design: deterministic, with no atomics.  The TPU kernel walks the ROIs in
//   order into a revisited output block; here each block owns one tile of
//   one level of one frame (256 cells: rows x columns, and 32 channels) and
//   accumulates it in shared memory in fp32.  The block walks all R ROIs in
//   index order, 8 at a time: 224 threads compute the 8 ROIs' 2 x 14 band
//   parameters, 8 threads reduce each ROI to the columns and output rows it
//   touches in the tile, and ROIs of another level or outside the tile are
//   skipped.  For a ROI that touches the tile, warp w owns the tile columns
//   x with (x - c0) % 8 == w and lane l owns channel c0 + l: the thread
//   gathers the x-pass transpose v[py] = sum_kx wx(kx, x) g[py, kx / 2] for
//   the output rows it needs, then adds wy * v / 4 into the two band rows of
//   each y sample.  Every shared-memory cell has one owner thread, which adds
//   the ROIs in index order, so two launches give bit-equal results.  The
//   tile is then written once in the output dtype.  Each block reads g for
//   the ROIs that touch its rows, mostly from L2; a faster version would
//   stage those g rows in shared memory and spread wide ROIs over more warps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int P = 7;               // output bins per axis
constexpr int SR = 2;              // samples per bin per axis
constexpr int S = P * SR;          // sample positions per axis
constexpr int CELLS = 256;         // rows x columns of a tile (the wrapper's _BWD_CELLS)
constexpr int CS = 32;             // channels of a tile, one per lane
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int RC = 8;              // ROIs per chunk: RC * 2 * S = 224 threads
constexpr int NO_COLUMN = 1 << 30;

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

struct Level {
  int H, W;      // map size
  float scale;   // 1 / stride
  int TR, TW;    // rows and columns of a tile (TR * TW <= CELLS)
  int NX;        // tiles across the width
  int tiles;     // tiles of the level
};

// at most 64 registers a thread, so that four blocks share an SM
template <typename T>
__global__ void __launch_bounds__(THREADS, 4)
roi_align_bwd_kernel(T* __restrict__ d0, T* __restrict__ d1, T* __restrict__ d2,
                     Level L0, Level L1, Level L2, const T* __restrict__ g,
                     const float* __restrict__ rois, const int* __restrict__ level,
                     int R, int C) {
  __shared__ float s_acc[CELLS * CS];
  __shared__ int s_lo[RC][2][S];
  __shared__ float s_w0[RC][2][S];
  __shared__ float s_w1[RC][2][S];
  __shared__ int s_rows[RC];   // bit i: output row i has a sample in the tile's rows
  __shared__ int s_x0[RC];     // first and last tile column with weight
  __shared__ int s_x1[RC];

  int tile = blockIdx.x;
  int lvl;
  Level L;
  T* df;
  if (tile < L0.tiles) {
    lvl = 0; L = L0; df = d0;
  } else if ((tile -= L0.tiles) < L1.tiles) {
    lvl = 1; L = L1; df = d1;
  } else {
    tile -= L1.tiles;
    lvl = 2; L = L2; df = d2;
  }
  const int r0 = (tile / L.NX) * L.TR;
  const int c0 = (tile % L.NX) * L.TW;
  const int ch0 = blockIdx.y * CS;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool ch_ok = ch0 + lane < C;
  const size_t rstride = (size_t)(P * P) * C;
  const T* gb = g + (size_t)b * R * rstride + ch0 + lane;

  for (int i = threadIdx.x; i < CELLS * CS; i += THREADS) s_acc[i] = 0.f;

  for (int base = 0; base < R; base += RC) {
    __syncthreads();   // the previous chunk's parameters are no longer read
    if (threadIdx.x < RC * 2 * S) {
      // thread -> (ROI j of the chunk, axis 0 = y / 1 = x, sample k)
      const int j = threadIdx.x / (2 * S);
      const int axis = (threadIdx.x / S) % 2;
      const int k = threadIdx.x % S;
      const int r = base + j;
      int lo = 0;
      float w0 = 0.f, w1 = 0.f;
      if (r < R && level[(size_t)b * R + r] == lvl) {
        // K1's sample coordinate, operation for operation
        const float* roi = rois + 4 * ((size_t)b * R + r);
        const float a1 = __fsub_rn(__fmul_rn(roi[axis == 0 ? 1 : 0], L.scale), 0.5f);
        const float a2 = __fsub_rn(__fmul_rn(roi[axis == 0 ? 3 : 2], L.scale), 0.5f);
        const float bin = __fdiv_rn(__fsub_rn(a2, a1), (float)P);
        const float grid = __fadd_rn(
            (float)(k / SR), __fdiv_rn(__fadd_rn((float)(k % SR), 0.5f), (float)SR));
        const float c = __fadd_rn(a1, __fmul_rn(bin, grid));
        const float size = (float)(axis == 0 ? L.H : L.W);
        // _band_params
        const float cc = fminf(fmaxf(c, 0.f), size - 1.f);
        const float low = floorf(cc);
        const float high = fminf(low + 1.f, size - 1.f);
        const float frac = __fsub_rn(cc, low);
        const bool inside = (c >= -1.f) && (c <= size);
        const float w_low = inside ? __fsub_rn(1.f, frac) : 0.f;
        const float w_high = (inside && high > low) ? frac : 0.f;
        const float lo_f = fminf(low, fmaxf(size - 2.f, 0.f));
        const bool shifted = low > lo_f;
        lo = (int)lo_f;
        w0 = shifted ? 0.f : w_low;
        w1 = shifted ? w_low : w_high;
      }
      s_lo[j][axis][k] = lo;
      s_w0[j][axis][k] = w0;
      s_w1[j][axis][k] = w1;
    }
    __syncthreads();
    if (threadIdx.x < RC) {
      const int j = threadIdx.x;
      int rows = 0, x0 = NO_COLUMN, x1 = -1;
      for (int k = 0; k < S; ++k) {
        const int y = s_lo[j][0][k] - r0;
        if ((s_w0[j][0][k] != 0.f && y >= 0 && y < L.TR) ||
            (s_w1[j][0][k] != 0.f && y + 1 >= 0 && y + 1 < L.TR))
          rows |= 1 << (k / SR);
        const int x = s_lo[j][1][k];
        if (s_w0[j][1][k] != 0.f) { x0 = min(x0, x); x1 = max(x1, x); }
        if (s_w1[j][1][k] != 0.f) { x0 = min(x0, x + 1); x1 = max(x1, x + 1); }
      }
      x0 = max(x0, c0);
      x1 = min(x1, c0 + L.TW - 1);
      s_rows[j] = x0 <= x1 ? rows : 0;
      s_x0[j] = x0;
      s_x1[j] = x1;
    }
    __syncthreads();

    for (int j = 0; j < RC; ++j) {
      const int rows = s_rows[j];
      if (rows == 0) continue;
      const T* gr = gb + (size_t)(base + j) * rstride;
      const int xs = s_x0[j];
      // this warp's first column at or after xs
      int x = xs + (((warp - (xs - c0)) % WARPS) + WARPS) % WARPS;
      for (; x <= s_x1[j]; x += WARPS) {
        // x-pass transpose for this column and channel
        float v[P];
#pragma unroll
        for (int i = 0; i < P; ++i) v[i] = 0.f;
#pragma unroll 1
        for (int kx = 0; kx < S; ++kx) {
          const int xl = s_lo[j][1][kx];
          const float w = (xl == x ? s_w0[j][1][kx] : 0.f) +
                          (xl + 1 == x ? s_w1[j][1][kx] : 0.f);
          if (w == 0.f || !ch_ok) continue;
#pragma unroll
          for (int i = 0; i < P; ++i) {
            if (rows & (1 << i))
              v[i] = __fadd_rn(v[i], __fmul_rn(w, load1(gr + (size_t)(i * P + kx / SR) * C)));
          }
        }
        // y-pass transpose into the tile's band rows
        float* col = s_acc + (x - c0) * CS + lane;
        const int row_stride = L.TW * CS;
#pragma unroll
        for (int ky = 0; ky < S; ++ky) {
          const int i = ky / SR;
          if (!(rows & (1 << i))) continue;
          const float vq = __fmul_rn(v[i], 1.f / (SR * SR));
          const int y = s_lo[j][0][ky] - r0;
          if (y >= 0 && y < L.TR)
            col[y * row_stride] = __fadd_rn(col[y * row_stride], __fmul_rn(s_w0[j][0][ky], vq));
          if (y + 1 >= 0 && y + 1 < L.TR)
            col[(y + 1) * row_stride] =
                __fadd_rn(col[(y + 1) * row_stride], __fmul_rn(s_w1[j][0][ky], vq));
        }
      }
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < L.TR * L.TW * CS; i += THREADS) {
    const int cell = i / CS;
    const int ch = ch0 + i % CS;
    const int row = r0 + cell / L.TW;
    const int colx = c0 + cell % L.TW;
    if (row < L.H && colx < L.W && ch < C)
      store1(df + (((size_t)b * L.H + row) * L.W + colx) * C + ch, s_acc[i]);
  }
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16.  Per level: map size, scale and the
// tiling the wrapper computed (rows and columns per tile, tiles across,
// tiles).  Launches on `stream`; returns cudaGetLastError() right after the
// launch.
extern "C" int roi_align_bwd(void* d0, void* d1, void* d2, int h0, int w0,
                             int h1, int w1, int h2, int w2, float s0, float s1,
                             float s2, const void* g, const void* rois,
                             const void* level, int tr0, int tw0, int nx0,
                             int n0, int tr1, int tw1, int nx1, int n1, int tr2,
                             int tw2, int nx2, int n2, int B, int R, int C,
                             int dtype, void* stream) {
  const Level L0{h0, w0, s0, tr0, tw0, nx0, n0};
  const Level L1{h1, w1, s1, tr1, tw1, nx1, n1};
  const Level L2{h2, w2, s2, tr2, tw2, nx2, n2};
  for (const Level& L : {L0, L1, L2}) {
    if (L.TR * L.TW > CELLS || L.TR < 1 || L.TW < 1) return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(n0 + n1 + n2, (C + CS - 1) / CS, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    roi_align_bwd_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<__nv_bfloat16*>(d0), static_cast<__nv_bfloat16*>(d1),
        static_cast<__nv_bfloat16*>(d2), L0, L1, L2,
        static_cast<const __nv_bfloat16*>(g), static_cast<const float*>(rois),
        static_cast<const int*>(level), R, C);
  } else {
    roi_align_bwd_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<float*>(d0), static_cast<float*>(d1), static_cast<float*>(d2),
        L0, L1, L2, static_cast<const float*>(g), static_cast<const float*>(rois),
        static_cast<const int*>(level), R, C);
  }
  return static_cast<int>(cudaGetLastError());
}
