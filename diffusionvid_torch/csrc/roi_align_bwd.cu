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
//   arithmetic, about 0.4-0.6 GFLOP of corner contributions in fp32, needs
//   9 us at 67 TFLOP/s.  What holds it far above that is the walk over each
//   tile's ROIs: the train step piles up to about 200 ROIs of a frame onto
//   one coarse tile, and every ROI a block takes costs it a barrier, its
//   weight tables and the shared-memory traffic of its sums.
//
// Design: deterministic, with no atomics; four launches a call.
//   1. roi_prepass_kernel, one block a frame: a warp a ROI computes the 2 x 14
//      band parameters (lo, w0, w1) once, with K1's sample coordinates, and
//      the ROI's extent (the first and last row and column of its level with
//      a non-zero weight) by warp reductions, into a 352-byte record.  Then a
//      warp a tile builds the tile's list of the ROIs of its level whose
//      extent meets it, in ROI index order (ballot and prefix count over 32
//      ROIs at a time), with its length.
//   2. roi_align_bwd_kernel, one launch a level: a cluster of S blocks (the
//      plan's split for the level, at most 8) owns one tile (rows x columns,
//      at most 256 cells) of one frame and 64 channels, two a lane.  Rank q
//      takes the list's entries [q n / S, (q + 1) n / S) in order and
//      accumulates them in its own fp32 tile in shared memory.  Each ROI's
//      49 cotangent rows of the block's channels and its record are copied
//      into shared memory by 16-byte cp.async, one ROI ahead, so that the
//      next ROI's copy overlaps the current one's sums.  Per ROI, the block
//      first folds the 14 samples of each axis into 7-bin weight tables over
//      the ROI's footprint in the tile, a thread a (cell, bin) (x weights
//      carry the 1/4 of the sample mean); then each warp takes fixed
//      (column, row group) items: the x-pass v[py] = sum_px Ax[px] g[py, px]
//      reads shared memory only, and the y-pass adds sum_py Ay[py] v[py]
//      into each row of the group.  Every cell has one owner thread per ROI
//      and the ROIs follow each other between block barriers, so the order
//      of the sums is fixed.  After the cluster barrier, rank q sums its 1/S
//      of the tile's cells over ranks 0..S-1, in rank order, through
//      distributed shared memory, and writes them once in the output dtype.
//   The launch plan (tiles, split, shared bytes) comes from the wrapper
//   (ops/roi_align.py: bwd_plan) and is checked here.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

namespace cg = cooperative_groups;

constexpr int P = 7;               // output bins per axis
constexpr int SR = 2;              // samples per bin per axis
constexpr int S = P * SR;          // sample positions per axis
constexpr int CELLS = 256;         // most rows x columns of a tile
constexpr int CB = 64;             // channels of a block, two per lane
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_CLUSTER = 8;     // the portable cluster size
constexpr int PRE_THREADS = 1024;
constexpr int PRE_BYTES_PER_ROI = 36;   // the prepass's extent, box and level a ROI
constexpr int SMEM_BLOCK_LIMIT = 232448;
// a ROI's record: lo[28], w0[28], w1[28] (y samples, then x), extent y0, y1,
// x0, x1 (empty: y0 > y1)
constexpr int REC = 88;
constexpr int REC_LO = 0, REC_W0 = 28, REC_W1 = 56, REC_EXT = 84;
constexpr int TAB = 8;             // a table entry: 7 bin weights, padded

struct Level {
  int H, W;       // map size
  float scale;    // 1 / stride
  int TR, TW;     // rows and columns of a tile
  int NX;         // tiles across the width
  int tiles;      // tiles of the level
  int toff;       // the level's first tile among all levels' tiles
  int cluster;    // blocks that split a tile's list
  int smem;       // dynamic shared bytes of a block
};

__host__ __device__ constexpr int stage_bytes(int elt) { return P * P * CB * elt + REC * 4; }

__host__ __device__ constexpr int list_bytes(int R) { return (R + 3) / 4 * 16; }

__host__ __device__ constexpr int main_smem(int tr, int tw, int elt, int R) {
  return tr * tw * CB * 4 + 2 * stage_bytes(elt) + (tr + tw) * TAB * 4 + list_bytes(R);
}

// ---------------------------------------------------------------- prepass

__global__ void __launch_bounds__(PRE_THREADS)
roi_prepass_kernel(Level L0, Level L1, Level L2, const float* __restrict__ rois,
                   const int* __restrict__ level, int* __restrict__ rec,
                   int* __restrict__ lists, int* __restrict__ counts, int R, int T) {
  extern __shared__ int4 s_ext[];                        // [R] extents
  float4* s_roi = reinterpret_cast<float4*>(s_ext + R);  // [R] boxes
  int* s_lvl = reinterpret_cast<int*>(s_roi + R);        // [R] levels
  __shared__ float s_scale[3];
  __shared__ int s_geo[3][6];                            // H, W, TR, TW, NX, tiles
  const int b = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = PRE_THREADS / 32;
  if (threadIdx.x < 3) {
    const Level L = threadIdx.x == 0 ? L0 : (threadIdx.x == 1 ? L1 : L2);
    s_scale[threadIdx.x] = L.scale;
    int* geo = s_geo[threadIdx.x];
    geo[0] = L.H; geo[1] = L.W; geo[2] = L.TR; geo[3] = L.TW; geo[4] = L.NX; geo[5] = L.tiles;
  }
  for (int r = threadIdx.x; r < R; r += PRE_THREADS) {
    const float* roi = rois + 4 * ((size_t)b * R + r);
    s_roi[r] = make_float4(roi[0], roi[1], roi[2], roi[3]);
    const int lv = level[(size_t)b * R + r];
    s_lvl[r] = lv >= 0 && lv < 3 ? lv : -1;
  }
  __syncthreads();

  for (int r = warp; r < R; r += nwarps) {
    const int lv = s_lvl[r];
    int* out = rec + ((size_t)b * R + r) * REC;
    int mn = INT_MAX, mx = -1;
    if (lane < 2 * S) {
      const int axis = lane / S;      // 0: y, 1: x
      const int k = lane % S;
      int lo = 0;
      float w0 = 0.f, w1 = 0.f;
      if (lv >= 0) {
        // K1's sample coordinate, operation for operation
        const float4 box = s_roi[r];
        const float scale = s_scale[lv];
        const float a1 = __fsub_rn(__fmul_rn(axis == 0 ? box.y : box.x, scale), 0.5f);
        const float a2 = __fsub_rn(__fmul_rn(axis == 0 ? box.w : box.z, scale), 0.5f);
        const float bin = __fdiv_rn(__fsub_rn(a2, a1), (float)P);
        const float grid = __fadd_rn(
            (float)(k / SR), __fdiv_rn(__fadd_rn((float)(k % SR), 0.5f), (float)SR));
        const float c = __fadd_rn(a1, __fmul_rn(bin, grid));
        const float size = (float)s_geo[lv][axis];
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
      out[REC_LO + lane] = lo;
      out[REC_W0 + lane] = __float_as_int(w0);
      out[REC_W1 + lane] = __float_as_int(w1);
      if (w0 != 0.f) { mn = lo; mx = lo; }
      if (w1 != 0.f) { mn = min(mn, lo + 1); mx = lo + 1; }
    }
    const bool is_y = lane < S;
    const int y0 = __reduce_min_sync(0xffffffffu, is_y ? mn : INT_MAX);
    const int y1 = __reduce_max_sync(0xffffffffu, is_y ? mx : -1);
    const int x0 = __reduce_min_sync(0xffffffffu, is_y ? INT_MAX : mn);
    const int x1 = __reduce_max_sync(0xffffffffu, is_y ? -1 : mx);
    if (lane == 0) {
      // a ROI with no weight on one axis touches no cell
      const int4 e = (y0 <= y1 && x0 <= x1) ? make_int4(y0, y1, x0, x1)
                                             : make_int4(INT_MAX, -1, INT_MAX, -1);
      reinterpret_cast<int4*>(out + REC_EXT)[0] = e;
      s_ext[r] = e;
    }
  }
  __syncthreads();

  // a warp a tile: its ROIs in index order
  for (int t = warp; t < T; t += nwarps) {
    int lv = 0, tile = t;
    while (lv < 2 && tile >= s_geo[lv][5]) tile -= s_geo[lv++][5];
    const int* geo = s_geo[lv];
    const int r0 = (tile / geo[4]) * geo[2], c0 = (tile % geo[4]) * geo[3];
    const int r1 = r0 + geo[2] - 1, c1 = c0 + geo[3] - 1;
    int* list = lists + ((size_t)b * T + t) * R;
    int n = 0;
    for (int base = 0; base < R; base += 32) {
      const int r = base + lane;
      bool hit = false;
      if (r < R && s_lvl[r] == lv) {
        const int4 e = s_ext[r];
        hit = e.x <= r1 && e.y >= r0 && e.z <= c1 && e.w >= c0;
      }
      const unsigned m = __ballot_sync(0xffffffffu, hit);
      if (hit) list[n + __popc(m & ((1u << lane) - 1u))] = r;
      n += __popc(m);
    }
    if (lane == 0) counts[(size_t)b * T + t] = n;
  }
}

// ---------------------------------------------------------------- main kernel

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_wait0() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// a lane's two channels of a staged cotangent row, and of the output
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

// One row of the y-pass for a lane's two channels: sum_py ay[py] v[py] in
// ascending py, from a row-table entry (7 weights, zero outside the row's
// bins).
__device__ __forceinline__ float2 row_sum(float4 t0, float4 t1, const float (&v0)[P],
                                          const float (&v1)[P]) {
  const float ay[P] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z};
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int py = 0; py < P; ++py) {
    s0 = __fmaf_rn(ay[py], v0[py], s0);
    s1 = __fmaf_rn(ay[py], v1[py], s1);
  }
  return make_float2(s0, s1);
}

// at most 80 registers a thread, so that three blocks may share an SM
template <typename T>
__global__ void __launch_bounds__(THREADS, 3)
roi_align_bwd_kernel(T* __restrict__ df, Level L, const T* __restrict__ g,
                     const int* __restrict__ rec, const int* __restrict__ lists,
                     const int* __restrict__ counts, int R, int C, int T_all, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int G_BYTES = P * P * CB * (int)sizeof(T);    // a ROI's staged rows
  constexpr int CHUNKS = CB * (int)sizeof(T) / 16;        // 16-byte copies a row
  const int cells = L.TR * L.TW;
  float* s_acc = reinterpret_cast<float*>(smem);                        // [cells][CB]
  unsigned char* s_stage = smem + (size_t)cells * CB * 4;                // 2 x (g rows, record)
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* s_xtab = reinterpret_cast<float*>(s_stage + 2 * stage_bytes(sizeof(T)));  // [TW][TAB]
  float* s_ytab = s_xtab + L.TW * TAB;                                             // [TR][TAB]
  int* s_list = reinterpret_cast<int*>(s_ytab + L.TR * TAB);    // the block's share of the list

  const int S_ = L.cluster;
  const int tile = blockIdx.x / S_;
  const int rank = blockIdx.x % S_;
  const int r0 = (tile / L.NX) * L.TR;
  const int c0 = (tile % L.NX) * L.TW;
  const int ch0 = blockIdx.y * CB;
  const int b = blockIdx.z;
  const int nch = min(CB, C - ch0);          // even
  const bool ch_ok = 2 * lane < nch;
  // the tile's fixed (column, row group) items, a warp each
  const int nrg = min(L.TR, max(1, (2 * WARPS + L.TW - 1) / L.TW));
  const int rpg = (L.TR + nrg - 1) / nrg;
  const int items = L.TW * nrg;

  const int n = counts[(size_t)b * T_all + L.toff + tile];
  const int first = rank * n / S_;
  const int mine = (rank + 1) * n / S_ - first;
  {
    const int* list = lists + ((size_t)b * T_all + L.toff + tile) * R + first;
    for (int i = threadIdx.x; i < mine; i += THREADS) s_list[i] = list[i];
    __syncthreads();
  }

  // ROI j of this block's share -> stage j % 2, as one cp.async group
  const int row_bytes = nch * (int)sizeof(T);
  auto issue = [&](int j) {
    if (j < mine) {
      const int r = s_list[j];
      unsigned char* st = s_stage + (j & 1) * stage_bytes(sizeof(T));
      const unsigned char* src = reinterpret_cast<const unsigned char*>(
          g + ((size_t)b * R + r) * (P * P) * C + ch0);
      const size_t src_row = (size_t)C * sizeof(T);
      constexpr int n_rec = REC * 4 / 16;
      const int* rsrc = rec + ((size_t)b * R + r) * REC;
      if (threadIdx.x < n_rec) cp_async16(st + G_BYTES + threadIdx.x * 16, rsrc + threadIdx.x * 4);
      if (vec == 16) {
        for (int i = threadIdx.x; i < P * P * CHUNKS; i += THREADS) {
          const int row = i / CHUNKS, q = i % CHUNKS;
          if (q * 16 < row_bytes)
            cp_async16(st + row * (CB * (int)sizeof(T)) + q * 16, src + row * src_row + q * 16);
        }
      } else {
        const int per_row = row_bytes / 4;
        for (int i = threadIdx.x; i < P * P * per_row; i += THREADS) {
          const int row = i / per_row, q = i % per_row;
          cp_async4(st + row * (CB * (int)sizeof(T)) + q * 4, src + row * src_row + q * 4);
        }
      }
    }
    cp_commit();
  };

  float4* acc4 = reinterpret_cast<float4*>(s_acc);
  for (int i = threadIdx.x; i < cells * CB / 4; i += THREADS)
    acc4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  issue(0);

  for (int j = 0; j < mine; ++j) {
    cp_wait0();
    __syncthreads();   // ROI j has landed; ROI j - 1's stage and tables are free
    issue(j + 1);
    const unsigned char* st = s_stage + (j & 1) * stage_bytes(sizeof(T));
    const T* gs = reinterpret_cast<const T*>(st) + 2 * lane;
    const int* rc = reinterpret_cast<const int*>(st + G_BYTES);
    const int4 e = reinterpret_cast<const int4*>(rc + REC_EXT)[0];
    const int ya = max(e.x, r0), yb = min(e.y, r0 + L.TR - 1);
    const int xa = max(e.z, c0), xb = min(e.w, c0 + L.TW - 1);
    const int nrow = yb - ya + 1, ncol = xb - xa + 1;

    // the footprint's column and row tables, a thread a (cell, bin): the
    // bin's two samples' corner weights at the cell (x weights carry the
    // 1/4 of the sample mean, exactly)
    for (int t = threadIdx.x; t < (ncol + nrow) * P; t += THREADS) {
      const int idx = t / P, bin = t % P;
      const bool is_x = idx < ncol;
      const int pos = is_x ? xa + idx : ya + (idx - ncol);
      const int k0 = (is_x ? S : 0) + bin * SR;
      float a = 0.f;
#pragma unroll
      for (int h = 0; h < SR; ++h) {
        const int lo = rc[REC_LO + k0 + h];
        if (lo == pos) a = __fadd_rn(a, __int_as_float(rc[REC_W0 + k0 + h]));
        if (lo + 1 == pos) a = __fadd_rn(a, __int_as_float(rc[REC_W1 + k0 + h]));
      }
      if (is_x) a = __fmul_rn(a, 1.f / (SR * SR));
      (is_x ? s_xtab + idx * TAB : s_ytab + (idx - ncol) * TAB)[bin] = a;
    }
    __syncthreads();

    if (!ch_ok) continue;
    for (int it = warp; it < items; it += WARPS) {
      const int x = c0 + it % L.TW;
      const int y_lo = max(ya, r0 + (it / L.TW) * rpg);
      const int y_hi = min(yb, r0 + (it / L.TW + 1) * rpg - 1);
      if (x < xa || x > xb || y_lo > y_hi) continue;   // the same for the whole warp
      // the x-pass: v[py] = sum_px ax[px] g[py, px]
      const float4* xt = reinterpret_cast<const float4*>(s_xtab + (x - xa) * TAB);
      const float4 x0 = xt[0], x1 = xt[1];
      const float ax[P] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z};
      float v0[P], v1[P];
#pragma unroll
      for (int py = 0; py < P; ++py) v0[py] = v1[py] = 0.f;
#pragma unroll
      for (int px = 0; px < P; ++px) {
        if (ax[px] == 0.f) continue;   // the same for the whole warp
#pragma unroll
        for (int py = 0; py < P; ++py) {
          const float2 gv = load2(gs + (py * P + px) * CB);
          v0[py] = __fmaf_rn(ax[px], gv.x, v0[py]);
          v1[py] = __fmaf_rn(ax[px], gv.y, v1[py]);
        }
      }
      // the y-pass, two rows at a time: both rows' weights and cells are
      // read before either is written
      float* cell = s_acc + ((y_lo - r0) * L.TW + (x - c0)) * CB + 2 * lane;
      const int step = L.TW * CB;
      int y = y_lo;
      for (; y < y_hi; y += 2, cell += 2 * step) {
        const float4* t = reinterpret_cast<const float4*>(s_ytab + (y - ya) * TAB);
        const float4 p0 = t[0], p1 = t[1], q0 = t[2], q1 = t[3];
        float2 a0 = *reinterpret_cast<float2*>(cell);
        float2 a1 = *reinterpret_cast<float2*>(cell + step);
        const float2 s0 = row_sum(p0, p1, v0, v1);
        const float2 s1 = row_sum(q0, q1, v0, v1);
        a0.x = __fadd_rn(a0.x, s0.x);
        a0.y = __fadd_rn(a0.y, s0.y);
        a1.x = __fadd_rn(a1.x, s1.x);
        a1.y = __fadd_rn(a1.y, s1.y);
        *reinterpret_cast<float2*>(cell) = a0;
        *reinterpret_cast<float2*>(cell + step) = a1;
      }
      if (y == y_hi) {
        const float4* t = reinterpret_cast<const float4*>(s_ytab + (y - ya) * TAB);
        float2 a0 = *reinterpret_cast<float2*>(cell);
        const float2 s0 = row_sum(t[0], t[1], v0, v1);
        a0.x = __fadd_rn(a0.x, s0.x);
        a0.y = __fadd_rn(a0.y, s0.y);
        *reinterpret_cast<float2*>(cell) = a0;
      }
    }
  }
  cp_wait0();

  // write the tile once, a warp a cell and a lane two channels: rank q sums
  // its share of the cells over the ranks, in rank order
  T* out = df + (size_t)b * L.H * L.W * C + ch0 + 2 * lane;
  if (S_ > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int cell_lo = rank * cells / S_, cell_hi = (rank + 1) * cells / S_;
    constexpr int U = 4;   // cells a warp sums at a time
    for (int c4 = cell_lo + U * warp; c4 < cell_hi; c4 += U * WARPS) {
      float2 sum[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        sum[u] = *reinterpret_cast<const float2*>(
            cluster.map_shared_rank(s_acc + min(c4 + u, cell_hi - 1) * CB + 2 * lane, 0));
      for (int q = 1; q < S_; ++q) {
        float2 part[U];
#pragma unroll
        for (int u = 0; u < U; ++u)
          part[u] = *reinterpret_cast<const float2*>(
              cluster.map_shared_rank(s_acc + min(c4 + u, cell_hi - 1) * CB + 2 * lane, q));
#pragma unroll
        for (int u = 0; u < U; ++u)
          sum[u] = make_float2(__fadd_rn(sum[u].x, part[u].x), __fadd_rn(sum[u].y, part[u].y));
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int cell = c4 + u;
        const int row = r0 + cell / L.TW, col = c0 + cell % L.TW;
        if (cell < cell_hi && row < L.H && col < L.W && ch_ok)
          store2(out + ((size_t)row * L.W + col) * C, sum[u]);
      }
    }
    cluster.sync();   // no block leaves while another reads its tile
  } else {
    __syncthreads();
    for (int cell = warp; cell < cells; cell += WARPS) {
      const int row = r0 + cell / L.TW, col = c0 + cell % L.TW;
      if (row < L.H && col < L.W && ch_ok)
        store2(out + ((size_t)row * L.W + col) * C, load2(s_acc + cell * CB + 2 * lane));
    }
  }
}

// the plan's checks: the tiling covers the map, the split and the bytes
bool level_ok(const Level& L, int elt, int R) {
  if (L.H < 1 || L.W < 1 || L.TR < 1 || L.TW < 1 || L.TR * L.TW > CELLS) return false;
  if (L.NX != (L.W + L.TW - 1) / L.TW) return false;
  if (L.tiles != L.NX * ((L.H + L.TR - 1) / L.TR)) return false;
  if (L.cluster < 1 || L.cluster > MAX_CLUSTER) return false;
  return L.smem == main_smem(L.TR, L.TW, elt, R) && L.smem <= SMEM_BLOCK_LIMIT;
}

template <typename T>
cudaError_t launch_level(T* df, const Level& L, const T* g, const int* rec,
                         const int* lists, const int* counts, int B, int R, int C,
                         int T_all, int vec, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(roi_align_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = L.cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(L.tiles * L.cluster, (C + CB - 1) / CB, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = L.smem;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, roi_align_bwd_kernel<T>, df, L, g, rec, lists, counts, R, C,
                           T_all, vec);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
cudaError_t run(void* const* d, const Level* Ls, const void* g, const float* rois,
                const int* level, int* scratch, int B, int R, int C, cudaStream_t st) {
  const int T_all = Ls[0].tiles + Ls[1].tiles + Ls[2].tiles;
  int* rec = scratch;
  int* lists = rec + (size_t)B * R * REC;
  int* counts = lists + (size_t)B * T_all * R;
  const int pre_smem = R * PRE_BYTES_PER_ROI;
  cudaError_t err = cudaFuncSetAttribute(roi_prepass_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, pre_smem);
  if (err != cudaSuccess) return err;
  roi_prepass_kernel<<<B, PRE_THREADS, pre_smem, st>>>(Ls[0], Ls[1], Ls[2], rois, level, rec,
                                                      lists, counts, R, T_all);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // 16-byte copies where every cotangent row starts on 16 bytes
  const int vec = (C * (int)sizeof(T)) % 16 == 0 ? 16 : 4;
  for (int l = 0; l < 3; ++l) {
    err = launch_level<T>(static_cast<T*>(d[l]), Ls[l], static_cast<const T*>(g), rec, lists,
                          counts, B, R, C, T_all, vec, st);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16.  Per level: map size, scale and the
// wrapper's plan (rows and columns per tile, tiles across, tiles, cluster
// split, shared bytes); cb the channels of a block.  `scratch` holds B R
// records of REC int32, then B T lists of R ROI indices and B T counts (T:
// the tiles of all levels; ops/roi_align.py: bwd_scratch_words).  Launches
// the prepass and one kernel a level on `stream`; returns the first launch
// error, or cudaErrorInvalidValue for a plan the kernel was not built for.
extern "C" int roi_align_bwd(void* d0, void* d1, void* d2, int h0, int w0, int h1, int w1,
                             int h2, int w2, float s0, float s1, float s2, const void* g,
                             const void* rois, const void* level, void* scratch, int tr0,
                             int tw0, int nx0, int n0, int cl0, int sm0, int tr1, int tw1,
                             int nx1, int n1, int cl1, int sm1, int tr2, int tw2, int nx2,
                             int n2, int cl2, int sm2, int cb, int B, int R, int C, int dtype,
                             void* stream) {
  Level Ls[3] = {{h0, w0, s0, tr0, tw0, nx0, n0, 0, cl0, sm0},
                 {h1, w1, s1, tr1, tw1, nx1, n1, n0, cl1, sm1},
                 {h2, w2, s2, tr2, tw2, nx2, n2, n0 + n1, cl2, sm2}};
  const int elt = dtype == 1 ? 2 : 4;
  if (cb != CB || (dtype != 0 && dtype != 1) || B < 1 || R < 0 || C < 2 || C % 2)
    return (int)cudaErrorInvalidValue;
  for (const Level& L : Ls)
    if (!level_ok(L, elt, R)) return (int)cudaErrorInvalidValue;
  if (R * PRE_BYTES_PER_ROI > SMEM_BLOCK_LIMIT) return (int)cudaErrorInvalidValue;
  void* d[3] = {d0, d1, d2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1
      ? run<__nv_bfloat16>(d, Ls, g, static_cast<const float*>(rois),
                           static_cast<const int*>(level), static_cast<int*>(scratch), B, R, C, st)
      : run<float>(d, Ls, g, static_cast<const float*>(rois), static_cast<const int*>(level),
                   static_cast<int*>(scratch), B, R, C, st);
  return static_cast<int>(err);
}
