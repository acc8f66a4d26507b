// Multilevel ROIAlignV2 forward over three FPN levels (kernel K1).
//
// Replaces: diffusionvid_tpu/ops/roi_align_pallas.py: multilevel_roi_align_mxu
//   (the Pallas kernel _kernel_v4 and its variants _kernel_v3, _kernel_v2,
//   _kernel, which share one contract).
//
// Contract: level maps NHWC with channels contiguous ([B, Hl, Wl, C], float32
//   or bfloat16), rois [B, R, 4] float32 xyxy in image pixels.  Output
//   [B, R, 49, C] in the maps' dtype, row-major (py, px): 7x7 bins, 2x2
//   samples per bin, the aligned -0.5 offset, the CUDA border rule (zero
//   below -1 or above the size, clamped otherwise), fp32 accumulation, x1/4
//   for the sample mean; and each ROI's level, int32 [B, R], which the
//   kernel assigns itself with fpn_level_assignment's operations in their
//   order, as PyTorch runs them on CUDA (the division by 224 as a
//   multiplication by its fp32 reciprocal).  Any R is taken; the Pallas
//   kernel needed R % 50 == 0.
//
// What bounds it on an H100: bytes.  At the flagship shape (p3..p5 of 8
//   frames at 608x1024, 300 ROIs, C = 256, bf16) the least traffic is one
//   read of the maps (52 MB) and one write of the output (60 MB), 33.6 us
//   at 3.35 TB/s; the flops (16 taps an output element) need 14 us at the
//   fp32 rate.  What this design itself must move is the ROIs' footprints,
//   not the maps: a ROI's distinct band rows (at most 28) times its
//   distinct band columns (at most 28), about 115 cells of 512 bytes a ROI
//   on phase 3's inputs (141 MB at 2,400 ROIs, much of it L2 hits), plus
//   the 60 MB output: 201 MB, 60 us if all of it went to device memory.
//   The footprint design reads each of those cells once a block, 16 bytes
//   a lane, and writes each output element once, 16 bytes a lane.
//
// Two designs, one entry point each:
//
// footprint (bf16, roi_align_fwd_footprint; launch plan ops/roi_align.py:
//   fwd_plan).  One block of 14 warps per (frame, ROI) and slice of 256
//   channels, 8 channels (16 bytes) a lane.
//   - Warps 0 and 1 assign the level and compute the 14 y and 14 x sample
//     positions (round-to-nearest intrinsics, no contraction: bit-equal to
//     the plain version's), keep the band rows and columns that carry a
//     non-zero weight, and sort and deduplicate them by warp shuffles.
//   - Warps 2..13 then copy the footprint's cells (distinct rows x distinct
//     columns) into two shared buffers of `cells` cells by cp.async, one
//     512-byte cell a warp instruction, each cell once per block (the first
//     design made 784 4-byte loads a lane a ROI, most of them from L2),
//     while warps 0 and 1 fold the two samples of each bin into its weights:
//     per bin its (at most 4) rows, and a table of bins by columns.
//   - Warp (py, side) owns output row py.  Side 0 pools bins 0..3 and side
//     1 bins 3..6 over disjoint column ranges, bin 3's two sums meeting in
//     a fixed order at the end; where a column is weighed by bins of both
//     halves (boxes under about four cells wide), side 0 takes bins 0..3
//     and side 1 bins 4..6.  For each column of its range a warp folds the
//     staged rows of bin py (the y-pass), then adds the column into its 4
//     fp32 accumulators of 8 channels (the x-pass); the loop has no branch,
//     so its shared loads issue together.  Each output element is rounded
//     once and leaves as a 16-byte store.
//   - A footprint larger than a buffer streams through the two in bands of
//     rows; the common one (about 10 x 10 cells at p3, 14 x 15 at p4 and
//     p5) takes one or two bands, the largest (28 x 28) eight.
//   - The guard (before the stores): these separable sums round in another
//     order than the plain version, so where a bin's sum cancels to a tiny
//     fraction of its terms, the two can differ by more than bf16's
//     tolerance (seen on the stream's activations, up to 1.3e6).  Each lane
//     tracks the largest |f| it reads; where that bound says the tolerance
//     could be broken, the bin is pooled again from the map in the plain
//     version's order, bit-equal to it.  Maps with |f| below 6.7 never
//     take that path.
//   72 registers and 110 KB of shared memory a block: two blocks an SM.
//   What holds it back on the card is latency, not bytes: with two ROIs an
//   SM, each block's prologue, first copies and store wait in turn around
//   its pooling, and the boxes of six to eight bands, which pool two warps
//   at a time, finish after the rest of the grid.  A persistent block that
//   staged the next ROI while it pooled this one (producer warps, table
//   sets in a ring) was built and timed against this design, and was
//   slower: 14 pooling warps an SM are too few.
//
// v1 (float32, and bf16 for the benchmark only; roi_align_fwd).  The first
//   design: one block per (frame, ROI), one thread per pair of channels,
//   every tap one 4- or 8-byte load from L2.
//
// Both designs write the level; every block of a ROI computes it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int P = 7;           // output bins per axis
constexpr int SR = 2;          // samples per bin per axis
constexpr int S = P * SR;      // sample positions per axis
constexpr int NCAND = 2 * S;   // band rows (or columns) the samples of an axis touch

// fpn_level_assignment (ops/roi_align.py) on one ROI: its operations in its
// order, each rounded as PyTorch's CUDA kernels round it; the division of
// sqrt(area) by 224 (a Python number) runs there as a multiplication by the
// fp32 reciprocal.  Levels 0..2 are p3..p5.
__device__ __forceinline__ int roi_level(const float* roi) {
  const float w = fmaxf(__fsub_rn(roi[2], roi[0]), 0.f);
  const float h = fmaxf(__fsub_rn(roi[3], roi[1]), 0.f);
  const float v = __fadd_rn(__fmul_rn(__fsqrt_rn(__fmul_rn(w, h)), 1.f / 224.f), 1e-8f);
  const float l = floorf(__fadd_rn(log2f(v), 4.f));
  return static_cast<int>(fminf(fmaxf(l, 3.f), 5.f)) - 3;
}

// Sample k of an axis (0: y from roi[1], roi[3]; 1: x from roi[0], roi[2])
// at `scale` on a map of `size` cells: the band's low and high cell and
// their weights (zero outside the border rule).  The coordinate arithmetic
// is the plain version's, operation for operation.
struct Sample {
  int low, high;
  float w_low, w_high;
};

__device__ __forceinline__ Sample sample_at(const float* roi, int axis, int k, float scale,
                                            int size) {
  const float a1 = __fsub_rn(__fmul_rn(roi[axis == 0 ? 1 : 0], scale), 0.5f);
  const float a2 = __fsub_rn(__fmul_rn(roi[axis == 0 ? 3 : 2], scale), 0.5f);
  const float bin = __fdiv_rn(__fsub_rn(a2, a1), (float)P);
  // (k % SR + 0.5) / SR is 0.25 or 0.75 exactly, as in the plain version
  const float grid = __fadd_rn((float)(k / SR), (k % SR) ? 0.75f : 0.25f);
  const float c = __fadd_rn(a1, __fmul_rn(bin, grid));
  const float fsize = (float)size;
  const float cc = fminf(fmaxf(c, 0.f), fsize - 1.f);
  const float lo = floorf(cc);
  const float frac = __fsub_rn(cc, lo);
  const bool inside = (c >= -1.f) && (c <= fsize);
  Sample s;
  s.low = (int)lo;
  s.high = (int)fminf(lo + 1.f, fsize - 1.f);
  s.w_low = inside ? __fsub_rn(1.f, frac) : 0.f;
  s.w_high = (inside && s.high > s.low) ? frac : 0.f;
  return s;
}

// ------------------------------------------------------------ footprint

constexpr int WARPS = 2 * P;               // warp (py, side): output row py, bins px of a side
constexpr int THREADS = 32 * WARPS;
constexpr int FILL_WARPS = WARPS - 2;      // warps 2.. copy cells while 0 and 1 weigh them
constexpr int SIDE0 = 4;                   // side 0: px 0..3; side 1: px 4..6
constexpr int LANE_CH = 8;                 // bf16 channels a lane: 16 bytes
constexpr int SLICE = 32 * LANE_CH;        // channels a block
constexpr int CELL = SLICE * 2;            // bytes of a staged cell
constexpr int BIN_ROWS = 2 * SR;           // distinct rows a bin can weigh
constexpr unsigned FULL = 0xffffffffu;

// A ROI's tables, after the two buffers in shared memory.
struct Tables {
  int row_off[NCAND];        // distinct band rows, ascending, as element offsets (row * W * C)
  int col_off[NCAND];        // distinct band columns, ascending, as element offsets (col * C)
  float wx[P][NCAND];        // weight of bin px on column j
  int yslot[P][BIN_ROWS];    // the distinct rows bin py weighs (slots into row_off), ascending
  float yw[P][BIN_ROWS];     // and its weights on them
  int yn[P + 1];             // how many (the last entry is padding)
  int n[2];                  // distinct rows, distinct columns
  int crange[2][2];          // per side: the first and last column it pools
  int px1;                   // side 1's first bin: 3 when the sides split the columns, else 4
  int level;
  int pad[4];
  Sample samp[2][S];         // the y, then the x samples, for the exact path
};
static_assert(sizeof(Tables) == 1760, "ops/roi_align.py: K1_TABLES");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// a += w * (8 bf16 in v), lowest channel first
__device__ __forceinline__ void fma8(float* a, float w, uint4 v) {
  const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a[2 * i] = fmaf(w, __uint_as_float(u[i] << 16), a[2 * i]);
    a[2 * i + 1] = fmaf(w, __uint_as_float(u[i] & 0xffff0000u), a[2 * i + 1]);
  }
}

__device__ __forceinline__ float lo_f(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_f(unsigned u) { return __uint_as_float(u & 0xffff0000u); }

// The lane's running bound on |f| over what it has read, kept as two
// per-half maxima of the raw bf16 patterns (sign and magnitude): as signed
// 16-bit integers the largest positive value wins, or without one the
// negative of largest magnitude; as unsigned, the negative of largest
// magnitude wins, or without one the largest positive.  Either way the
// largest magnitude is the larger of the two maxima's magnitudes.
struct Mag {
  unsigned s = 0x80008000u;  // -0, the least signed pattern
  unsigned u = 0u;
};
__device__ __forceinline__ void max_mag(Mag& m, uint4 v) {
  m.s = __vmaxs2(__vmaxs2(m.s, v.x), __vmaxs2(v.y, v.z));
  m.s = __vmaxs2(m.s, v.w);
  m.u = __vmaxu2(__vmaxu2(m.u, v.x), __vmaxu2(v.y, v.z));
  m.u = __vmaxu2(m.u, v.w);
}
__device__ __forceinline__ float mag_bound(const Mag& m) {
  const unsigned a = m.s & 0x7fff7fffu, b = m.u & 0x7fff7fffu;
  return fmaxf(fmaxf(lo_f(a), hi_f(a)), fmaxf(lo_f(b), hi_f(b)));
}

// sum of 4 weighted taps, evaluated left to right without contraction
__device__ __forceinline__ float taps(float a, float wa, float b, float wb,
                                      float c, float wc, float d, float wd) {
  float s = __fmul_rn(a, wa);
  s = __fadd_rn(s, __fmul_rn(b, wb));
  s = __fadd_rn(s, __fmul_rn(c, wc));
  return __fadd_rn(s, __fmul_rn(d, wd));
}

__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Warp `axis` (0: rows, 1: columns), first part: lane k < S holds the low
// cell of sample k, lane S + k its high cell.  The cells with a non-zero
// weight, sorted and deduplicated, go to the tables as element offsets
// (`stride` elements a cell) with their count; each lane keeps its slot
// and weight for the second part.
struct Cand {
  int slot;
  float w;
};

__device__ __forceinline__ Cand axis_cells(const float* roi, int axis, float scale, int size,
                                           int stride, Tables& t) {
  const int lane = threadIdx.x % 32;
  const Sample s = sample_at(roi, axis, lane % S, scale, size);
  const bool high = lane >= S;
  const float wt = high ? s.w_high : s.w_low;
  const bool valid = lane < NCAND && wt != 0.f;
  const int v = valid ? (high ? s.high : s.low) : INT_MAX;
  bool first = valid;
#pragma unroll
  for (int j = 0; j < NCAND; ++j) {
    const int o = __shfl_sync(FULL, v, j);
    first = first && !(j < lane && o == v);
  }
  const unsigned firsts = __ballot_sync(FULL, first);
  int rank = 0;  // distinct cells below v: the slot of v
#pragma unroll
  for (int j = 0; j < NCAND; ++j) {
    const int o = __shfl_sync(FULL, v, j);
    rank += ((firsts >> j) & 1u) && o < v;
  }
  if (first) (axis == 0 ? t.row_off : t.col_off)[rank] = v * stride;
  if (lane == 0) t.n[axis] = __popc(firsts);
  if (lane < S) t.samp[axis][lane] = s;
  return Cand{rank, valid ? wt : 0.f};
}

// Second part: lane p < P gathers the four candidates of bin p (the low and
// high cell of sample 2p, then of sample 2p + 1), merges those on one cell
// (their weights summed in that order) and sorts them by slot.  Rows: each
// bin's list; columns: the weights as a table and, per side, the range of
// columns its bins weigh.
__device__ __forceinline__ void axis_weights(int axis, Cand cand, Tables& t) {
  const int lane = threadIdx.x % 32;
  const int p = min(lane, P - 1);
  int sl[4];
  float w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int c = (q & 1) * S + 2 * p + (q >> 1);
    sl[q] = __shfl_sync(FULL, cand.slot, c);
    w[q] = __shfl_sync(FULL, cand.w, c);
  }
  // the first candidate on each cell keeps the sum; the others drop out
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    bool dup = false;
#pragma unroll
    for (int e = 0; e < q; ++e) dup = dup || (w[e] != 0.f && sl[e] == sl[q]);
    float sum = w[q];
#pragma unroll
    for (int e = q + 1; e < 4; ++e)
      if (sl[e] == sl[q]) sum = __fadd_rn(sum, w[e]);
    w[q] = dup ? 0.f : sum;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (w[q] == 0.f) sl[q] = INT_MAX;
  // sort the four (slot, weight) pairs by slot
#define K1_SWAP(i, j)                                     \
  if (sl[j] < sl[i]) {                                    \
    const int ts = sl[i]; sl[i] = sl[j]; sl[j] = ts;      \
    const float tw = w[i]; w[i] = w[j]; w[j] = tw;        \
  }
  K1_SWAP(0, 1) K1_SWAP(2, 3) K1_SWAP(0, 2) K1_SWAP(1, 3) K1_SWAP(1, 2)
#undef K1_SWAP
  const int n = (sl[0] != INT_MAX) + (sl[1] != INT_MAX) + (sl[2] != INT_MAX) + (sl[3] != INT_MAX);
  if (axis == 0) {
    if (lane < P) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        t.yslot[p][q] = sl[q];
        t.yw[p][q] = w[q];
      }
      t.yn[p] = n;
    }
  } else {
    for (int i = lane; i < P * NCAND; i += 32) (&t.wx[0][0])[i] = 0.f;
    __syncwarp();
    if (lane < P)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (q < n) t.wx[p][sl[q]] = w[q];
    // The sides' columns (ranges; empty: first > last).  Columns split:
    // side 1 pools bins 3..6 over the columns of bins 4..6 (D), side 0 bins
    // 0..3 over the rest, when no column is weighed by bins 0..2 and 4..6
    // both; bin 3's two sums meet at the end.  Else bins split: side 0
    // pools bins 0..3 over their columns, side 1 bins 4..6 over D.
    int hi = -1;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (sl[q] != INT_MAX) hi = max(hi, sl[q]);
    const int lo = lane < P ? sl[0] : INT_MAX;
    hi = lane < P ? hi : -1;
    const int loA = __reduce_min_sync(FULL, lane < 3 ? lo : INT_MAX);
    const int hiA = __reduce_max_sync(FULL, lane < 3 ? hi : -1);
    const int lo0 = __reduce_min_sync(FULL, lane < SIDE0 ? lo : INT_MAX);
    const int hi0 = __reduce_max_sync(FULL, lane < SIDE0 ? hi : -1);
    const int loD = __reduce_min_sync(FULL, lane < SIDE0 ? INT_MAX : lo);
    const int hiD = __reduce_max_sync(FULL, lane < SIDE0 ? -1 : hi);
    const bool split = loD <= hiD && (loA > hiA || hiA < loD || hiD < loA);
    if (lane == 0) {
      t.crange[0][0] = split && lo0 >= loD ? max(lo0, hiD + 1) : lo0;
      t.crange[0][1] = split && lo0 < loD ? min(hi0, loD - 1) : hi0;
      t.crange[1][0] = loD;
      t.crange[1][1] = hiD;
      t.px1 = split ? SIDE0 - 1 : SIDE0;
    }
  }
}

// One band for warp (py, side): for each column of the side's range, the y-pass
// over the NQ rows of bin py in the band (offsets `off`, weights `wy`), then
// the x-pass into the NPX bins of the side.  No branch in the loop: a bin
// that does not weigh a column of the range has weight 0 there.
template <int NQ, int NPX>
__device__ __forceinline__ void band_pass(float (&acc)[SIDE0][LANE_CH], Mag& mag,
                                          const unsigned char* src, const int* off,
                                          const float* wy, const float* wx, int c0, int c1) {
  for (int c = c0; c <= c1; ++c) {
    uint4 v[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      v[q] = *reinterpret_cast<const uint4*>(src + off[q] + c * CELL);
      max_mag(mag, v[q]);
    }
    float w[NPX];
#pragma unroll
    for (int k = 0; k < NPX; ++k) w[k] = wx[k * NCAND + c];
    float a[LANE_CH];
#pragma unroll
    for (int q = 0; q < LANE_CH; ++q) a[q] = 0.f;
#pragma unroll
    for (int q = 0; q < NQ; ++q) fma8(a, wy[q], v[q]);
#pragma unroll
    for (int k = 0; k < NPX; ++k)
#pragma unroll
      for (int q = 0; q < LANE_CH; ++q) acc[k][q] = fmaf(w[k], a[q], acc[k][q]);
  }
}

template <int NPX>
__device__ __forceinline__ void band_dispatch(float (&acc)[SIDE0][LANE_CH], Mag& mag, int nq,
                                              const unsigned char* src, const int* off,
                                              const float* wy, const float* wx, int c0, int c1) {
  switch (nq) {
    case 1: band_pass<1, NPX>(acc, mag, src, off, wy, wx, c0, c1); break;
    case 2: band_pass<2, NPX>(acc, mag, src, off, wy, wx, c0, c1); break;
    case 3: band_pass<3, NPX>(acc, mag, src, off, wy, wx, c0, c1); break;
    case 4: band_pass<4, NPX>(acc, mag, src, off, wy, wx, c0, c1); break;
    default: break;
  }
}

// Bin (py, px) for the lane's 8 channels in the plain version's order,
// operation for operation (the first design's arithmetic, which is
// bit-equal to it), reading the taps from the map `fb` (the lane's
// channels of the frame) of W columns and C channels.
__device__ void exact_bin(const Tables& t, const __nv_bfloat16* fb, int W, int C, int py,
                          int px, float* o) {
#pragma unroll
  for (int q = 0; q < LANE_CH; ++q) o[q] = 0.f;
  for (int iy = 0; iy < SR; ++iy) {
    const Sample y = t.samp[0][py * SR + iy];
    if (y.w_low == 0.f) continue;  // outside: the plain version adds 0
    const float ly = y.w_high, hy = y.w_low;
    for (int ix = 0; ix < SR; ++ix) {
      const Sample x = t.samp[1][px * SR + ix];
      if (x.w_low == 0.f) continue;
      const float lx = x.w_high, hx = x.w_low;
      const float wa = __fmul_rn(hy, hx), wb = __fmul_rn(hy, lx);
      const float wc = __fmul_rn(ly, hx), wd = __fmul_rn(ly, lx);
      const uint4 va = *reinterpret_cast<const uint4*>(fb + ((size_t)y.low * W + x.low) * C);
      const uint4 vb = *reinterpret_cast<const uint4*>(fb + ((size_t)y.low * W + x.high) * C);
      const uint4 vc = *reinterpret_cast<const uint4*>(fb + ((size_t)y.high * W + x.low) * C);
      const uint4 vd = *reinterpret_cast<const uint4*>(fb + ((size_t)y.high * W + x.high) * C);
      const unsigned a[4] = {va.x, va.y, va.z, va.w}, b[4] = {vb.x, vb.y, vb.z, vb.w};
      const unsigned c[4] = {vc.x, vc.y, vc.z, vc.w}, d[4] = {vd.x, vd.y, vd.z, vd.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        o[2 * i] = __fadd_rn(o[2 * i], taps(lo_f(a[i]), wa, lo_f(b[i]), wb, lo_f(c[i]), wc,
                                            lo_f(d[i]), wd));
        o[2 * i + 1] = __fadd_rn(o[2 * i + 1], taps(hi_f(a[i]), wa, hi_f(b[i]), wb,
                                                    hi_f(c[i]), wc, hi_f(d[i]), wd));
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, 2) roi_footprint_kernel(
    const __nv_bfloat16* __restrict__ f0, const __nv_bfloat16* __restrict__ f1,
    const __nv_bfloat16* __restrict__ f2, int h0, int w0, int h1, int w1, int h2, int w2,
    float s0, float s1, float s2, const float* __restrict__ rois, int* __restrict__ level,
    __nv_bfloat16* __restrict__ out, int R, int C, int cells) {
  extern __shared__ __align__(16) unsigned char smem[];
  Tables& t = *reinterpret_cast<Tables*>(smem + 2 * cells * CELL);

  const int r = blockIdx.x;
  const int b = blockIdx.y;
  const int ch0 = blockIdx.z * SLICE;
  const size_t g = (size_t)b * R + r;
  const float* roi = rois + 4 * g;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  Cand cand{0, 0.f};
  if (warp < 2) {
    const int lvl = roi_level(roi);
    const int H = lvl == 0 ? h0 : (lvl == 1 ? h1 : h2);
    const int W = lvl == 0 ? w0 : (lvl == 1 ? w1 : w2);
    const float scale = lvl == 0 ? s0 : (lvl == 1 ? s1 : s2);
    cand = axis_cells(roi, warp, scale, warp == 0 ? H : W, warp == 0 ? W * C : C, t);
    if (threadIdx.x == 0) {
      t.level = lvl;
      if (blockIdx.z == 0) level[g] = lvl;
    }
  }
  __syncthreads();

  // the footprint's cells go into the buffers while warps 0 and 1 weigh them
  const int lvl = t.level;
  const __nv_bfloat16* f = lvl == 0 ? f0 : (lvl == 1 ? f1 : f2);
  const int H = lvl == 0 ? h0 : (lvl == 1 ? h1 : h2);
  const int W = lvl == 0 ? w0 : (lvl == 1 ? w1 : w2);
  const int nrows = t.n[0], ncols = t.n[1];
  const bool active = lane * LANE_CH < C - ch0;
  const __nv_bfloat16* fb = f + (size_t)b * H * W * C + ch0 + lane * LANE_CH;
  const int band = ncols > 0 ? cells / ncols : 0;  // rows a buffer holds
  const int nbands = nrows > 0 && ncols > 0 ? (nrows + band - 1) / band : 0;
  // fill warp w (warps 2..) copies rows w - 2, w - 2 + FILL_WARPS, ... of
  // a band, each row's cells in column order
  const int fw = warp - 2;
  auto fill = [&](int k) {
    const int j0 = k * band;
    const int rows = min(band, nrows - j0);
    unsigned char* dst = smem + (k & 1) * cells * CELL + lane * 16;
    if (active && fw >= 0)
      for (int j = fw; j < rows; j += FILL_WARPS) {
        const __nv_bfloat16* src = fb + t.row_off[j0 + j];
        unsigned char* d = dst + j * ncols * CELL;
        for (int c = 0; c < ncols; ++c) cp_async16(d + c * CELL, src + t.col_off[c]);
      }
    cp_async_commit();
  };
  if (nbands > 0) fill(0);
  if (nbands > 1) fill(1);
  if (warp < 2) axis_weights(warp, cand, t);

  const int py = warp % P;
  const int side = warp / P;
  __syncthreads();  // the weights and the sides' split
  const int px0 = side == 0 ? 0 : t.px1;
  float acc[SIDE0][LANE_CH];
#pragma unroll
  for (int k = 0; k < SIDE0; ++k)
#pragma unroll
    for (int q = 0; q < LANE_CH; ++q) acc[k][q] = 0.f;
  Mag mag;

  for (int k = 0; k < nbands; ++k) {
    if (k + 1 < nbands)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    // the rows of bin py in this band: a run of its ascending list
    const int j0 = k * band;
    const int j1 = min(nrows, j0 + band);
    const int yn = t.yn[py];
    int qa = 0, nq = 0;
#pragma unroll
    for (int q = 0; q < BIN_ROWS; ++q) {
      const int slot = t.yslot[py][q];
      qa += q < yn && slot < j0;
      nq += q < yn && slot >= j0 && slot < j1;
    }
    const int c0 = t.crange[side][0], c1 = t.crange[side][1];
    if (nq > 0 && c0 <= c1 && active) {
      int off[BIN_ROWS];
      float wy[BIN_ROWS];
#pragma unroll
      for (int q = 0; q < BIN_ROWS; ++q) {
        const int e = min(qa + q, BIN_ROWS - 1);
        off[q] = (t.yslot[py][e] - j0) * ncols * CELL;
        wy[q] = t.yw[py][e];
      }
      const unsigned char* src = smem + (k & 1) * cells * CELL + lane * 16;
      if (px0 + SIDE0 <= P)
        band_dispatch<SIDE0>(acc, mag, nq, src, off, wy, &t.wx[px0][0], c0, c1);
      else
        band_dispatch<P - SIDE0>(acc, mag, nq, src, off, wy, &t.wx[px0][0], c0, c1);
    }
    __syncthreads();
    if (k + 2 < nbands) fill(k + 2);
  }

  // Columns split: side 1 hands its sums of bin 3, and its bound, to side
  // 0 through the (now free) first buffer; side 0 adds them to its own.
  float bound = 1.45e-6f * mag_bound(mag);
  if (t.px1 == SIDE0 - 1) {
    float* part = reinterpret_cast<float*>(smem) + (py * 32 + lane) * (LANE_CH + 1);
    if (side == 1) {
#pragma unroll
      for (int q = 0; q < LANE_CH; ++q) part[q] = acc[0][q];
      part[LANE_CH] = bound;
    }
    __syncthreads();
    if (side == 0) {
#pragma unroll
      for (int q = 0; q < LANE_CH; ++q) acc[SIDE0 - 1][q] = __fadd_rn(acc[SIDE0 - 1][q], part[q]);
      bound = fmaxf(bound, part[LANE_CH]);
    }
  }
  const int k0 = side == 1 && px0 == SIDE0 - 1;  // side 1 does not store bin 3

  if (active) {
    __nv_bfloat16* o = out + (g * P * P + py * P + px0) * (size_t)C + ch0 + lane * LANE_CH;
    // The guard.  The plain version and these separable sums round in other
    // orders; to first order each differs from the exact sum by at most 8
    // and 12 roundings of M = sum(w |f|) / 4 <= max |f| over the bin's taps
    // <= the lane's bound `mag` (bin 3's two halves: the larger of their
    // bounds, and one rounding more), so the two differ by d <= 21 eps M,
    // with eps = 2^-24.  An element within (1e-5, 2^-6) of the plain version
    // after both round to bf16 needs d (1 + 2^-7 + 2^-8) <= 1e-5 + (2^-7 -
    // 2^-14) |out|; where 1.45e-6 mag (> 24 eps M) could break that, the
    // bin is pooled again in the plain version's order.  Only sums that
    // cancel to a small fraction of their terms get there.
    const float inv = 1.f / (SR * SR);
    unsigned redo = 0;  // bit k: bin px0 + k goes the exact way
#pragma unroll
    for (int k = 0; k < SIDE0; ++k) {
      if (px0 + k < P && k >= k0) {
        float r[LANE_CH];
        float small = INFINITY;  // the lane's smallest |out| in this bin
#pragma unroll
        for (int q = 0; q < LANE_CH; ++q) {
          r[q] = acc[k][q] * inv;
          small = fminf(small, fabsf(r[q]));
        }
        redo |= (unsigned)(bound > 9.8e-6f + 0.00390625f * small) << k;
        uint4 v;
        v.x = pack2(r[0], r[1]);
        v.y = pack2(r[2], r[3]);
        v.z = pack2(r[4], r[5]);
        v.w = pack2(r[6], r[7]);
        *reinterpret_cast<uint4*>(o + (size_t)k * C) = v;
      }
    }
    for (; redo; redo &= redo - 1) {
      const int k = __ffs(redo) - 1;
      float r[LANE_CH];
      exact_bin(t, fb, W, C, py, px0 + k, r);
      uint4 v;
      v.x = pack2(__fmul_rn(r[0], inv), __fmul_rn(r[1], inv));
      v.y = pack2(__fmul_rn(r[2], inv), __fmul_rn(r[3], inv));
      v.z = pack2(__fmul_rn(r[4], inv), __fmul_rn(r[5], inv));
      v.w = pack2(__fmul_rn(r[6], inv), __fmul_rn(r[7], inv));
      *reinterpret_cast<uint4*>(o + (size_t)k * C) = v;
    }
  }
}

// ------------------------------------------------------------ v1

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

template <typename T>
__global__ void roi_align_fwd_kernel(const T* __restrict__ f0,
                                     const T* __restrict__ f1,
                                     const T* __restrict__ f2,
                                     int h0, int w0, int h1, int w1, int h2,
                                     int w2, float s0, float s1, float s2,
                                     const float* __restrict__ rois,
                                     int* __restrict__ level,
                                     T* __restrict__ out, int R, int C) {
  __shared__ int s_lo[2][S];
  __shared__ int s_hi[2][S];
  __shared__ float s_frac[2][S];
  __shared__ bool s_in[2][S];

  const int r = blockIdx.x;
  const int b = blockIdx.y;
  const size_t g = (size_t)b * R + r;
  const int lvl = roi_level(rois + 4 * g);
  if (threadIdx.x == 0) level[g] = lvl;
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

// The footprint design (bf16).  `cells` and `smem` come from the plan
// (ops/roi_align.py: fwd_plan) and must match the layout above.  Launches
// on `stream`; returns cudaGetLastError() right after the launch.
extern "C" int roi_align_fwd_footprint(const void* f0, const void* f1, const void* f2,
                                       int h0, int w0, int h1, int w1, int h2, int w2,
                                       float s0, float s1, float s2, const void* rois,
                                       void* level, void* out, int B, int R, int C,
                                       int cells, int smem, void* stream) {
  // cell offsets within a frame's map are int32
  const long long frame = (long long)C * max(h0 * w0, max(h1 * w1, h2 * w2));
  if (C % LANE_CH != 0 || cells < NCAND || smem != 2 * cells * CELL + (int)sizeof(Tables) ||
      smem > 232448 || frame >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  static int smem_set = 0;  // the dynamic shared bytes the kernel is allowed
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        roi_footprint_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = smem;
  }
  const dim3 grid(R, B, (C + SLICE - 1) / SLICE);
  roi_footprint_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(f0), static_cast<const __nv_bfloat16*>(f1),
      static_cast<const __nv_bfloat16*>(f2), h0, w0, h1, w1, h2, w2, s0, s1, s2,
      static_cast<const float*>(rois), static_cast<int*>(level),
      static_cast<__nv_bfloat16*>(out), R, C, cells);
  return static_cast<int>(cudaGetLastError());
}

// The first design.  dtype: 0 = float32, 1 = bfloat16.  Launches on
// `stream`; returns cudaGetLastError() right after the launch.
extern "C" int roi_align_fwd(const void* f0, const void* f1, const void* f2,
                             int h0, int w0, int h1, int w1, int h2, int w2,
                             float s0, float s1, float s2, const void* rois,
                             void* level, void* out, int B, int R,
                             int C, int dtype, void* stream) {
  const dim3 grid(R, B);
  const dim3 block(C / 2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    roi_align_fwd_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        static_cast<const __nv_bfloat16*>(f0), static_cast<const __nv_bfloat16*>(f1),
        static_cast<const __nv_bfloat16*>(f2), h0, w0, h1, w1, h2, w2, s0, s1, s2,
        static_cast<const float*>(rois), static_cast<int*>(level),
        static_cast<__nv_bfloat16*>(out), R, C);
  } else {
    roi_align_fwd_kernel<float><<<grid, block, 0, st>>>(
        static_cast<const float*>(f0), static_cast<const float*>(f1),
        static_cast<const float*>(f2), h0, w0, h1, w1, h2, w2, s0, s1, s2,
        static_cast<const float*>(rois), static_cast<int*>(level),
        static_cast<float*>(out), R, C);
  }
  return static_cast<int>(cudaGetLastError());
}
