// The TMA-fed wgmma product and the LayerNorm pass of the Swin kernels that
// put their maps through device memory: K5's design from C = 512 on
// (swin_block_mlp.cu) and K4's staged design (swin_block_attn.cu: window
// 12, and C = 1536).  Each source wraps these bodies in kernels of its own
// names (mlp_* and attn_*), so that a profile tells K4's time from K5's.
// The design and its reasons are in swin_block_mlp.cu's header.
// ops/_build.py hashes this header into every library.

#pragma once

#include "swin_hopper.cuh"

namespace swin {

constexpr int BM = 128;                              // rows of an output tile
constexpr int KC = 64;                               // channels of a k-chunk
constexpr int A_BOX = BM * KC * sizeof(bf16);        // 16,384 bytes
constexpr int LN_ROWS = 2 * WARPS;                   // rows a LN block
// FC1: round(gelu(round(.))), the GELU by table; FC2: the residual plus
// round(.); QKV: round(.)
enum Epilogue { FC1, FC2, QKV };
constexpr float INV_SQRT2 = 0.70710678118654752f;

__device__ __forceinline__ float gelu(float z) {
  return 0.5f * z * (1.f + erff(z * INV_SQRT2));
}

// GELU by table.  fc1's z = round(y w1^T + b1) is a bf16 value, so
// round(gelu(z)) is a function of its 16 bits: entry i of the table holds it
// (gelu() above, the exact erf GELU) for the z of sign i / TBL_HALF,
// exponent TBL_E0 + (i % TBL_HALF) / 128 and mantissa i % 128, that is for
// 2^-20 <= |z| < 8.  The LN pass fills it in device memory, each fc1 block
// copies it into shared memory while its first boxes land, and the rare z
// outside it is computed.
constexpr int TBL_E0 = 107, TBL_NE = 23;
constexpr int TBL_HALF = TBL_NE * 128, TBL = 2 * TBL_HALF;        // 5,888 entries
constexpr int TBL_BYTES = TBL * static_cast<int>(sizeof(bf16));    // 11,776 bytes

__device__ __forceinline__ bf16 gelu_entry(int i) {
  const uint32_t bits = static_cast<uint32_t>(i / TBL_HALF) << 15 |
                        static_cast<uint32_t>(TBL_E0 + i % TBL_HALF / 128) << 7 | i % 128;
  return __float2bfloat16_rn(gelu(__uint_as_float(bits << 16)));
}

// y[m] = round(LN(x[m]) * keep(m)), LN_ROWS rows a block, two a warp: lane
// l holds the 16-byte pieces l, l + 32, ... of a row; both rows' loads are
// issued before either row is reduced.  ln_g and ln_b are 16-byte aligned.
// keep(m) is false where the row's LN output is zeroed (K4's window
// padding); K5 keeps every row.
template <int C, class Keep>
__device__ __forceinline__ void ln_rows_pass(const bf16* __restrict__ x,
                                             const float* __restrict__ ln_g,
                                             const float* __restrict__ ln_b,
                                             bf16* __restrict__ y, int M, float eps, Keep keep) {
  constexpr int P = C / 8, NV = (P + 31) / 32, R = LN_ROWS / WARPS;
  const int lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * LN_ROWS + (threadIdx.x >> 5) * R;
  uint4 raw[R][NV];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int p = lane + 32 * i;
      if (m0 + r < M && p < P)
        raw[r][i] =
            __ldg(reinterpret_cast<const uint4*>(x + static_cast<size_t>(m0 + r) * C) + p);
    }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (m0 + r >= M) return;
    float v[NV][8], s = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (lane + 32 * i < P) {
        const bf16* e = reinterpret_cast<const bf16*>(&raw[r][i]);
#pragma unroll
        for (int j = 0; j < 8; ++j) { v[i][j] = __bfloat162float(e[j]); s += v[i][j]; }
      }
    const float mu = warp_sum(s) / C;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (lane + 32 * i < P)
#pragma unroll
        for (int j = 0; j < 8; ++j) { v[i][j] -= mu; q += v[i][j] * v[i][j]; }
    const float inv = 1.f / sqrtf(warp_sum(q) / C + eps);
    const bool kept = keep(m0 + r);
    uint4* dst = reinterpret_cast<uint4*>(y + static_cast<size_t>(m0 + r) * C);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int p = lane + 32 * i;
      if (p < P) {
        const float4* g4 = reinterpret_cast<const float4*>(ln_g) + 2 * p;
        const float4* b4 = reinterpret_cast<const float4*>(ln_b) + 2 * p;
        const float4 ga = __ldg(g4), gb = __ldg(g4 + 1), ba = __ldg(b4), bb = __ldg(b4 + 1);
        const float g[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
        const float b[8] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
        uint4 out;
        uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
        for (int j = 0; j < 8; j += 2)
          o[j / 2] = kept ? pack2(v[i][j] * inv * g[j] + b[j],
                                  v[i][j + 1] * inv * g[j + 1] + b[j + 1])
                          : 0u;
        dst[p] = out;
      }
    }
  }
}

// gelu8's rare path, out of line: round(gelu(z)) for the z of v marked in
// `miss`
__device__ __noinline__ uint4 gelu_missed(uint4 v, uint32_t miss) {
  uint16_t* z = reinterpret_cast<uint16_t*>(&v);
  for (int e = 0; e < 8; ++e)
    if (miss >> e & 1) {
      const bf16 h = __float2bfloat16_rn(gelu(__uint_as_float(static_cast<uint32_t>(z[e]) << 16)));
      z[e] = *reinterpret_cast<const uint16_t*>(&h);
    }
  return v;
}

// round(gelu(z)) for the 8 bf16 values z of v, in place
__device__ __forceinline__ void gelu8(uint4& v, const bf16* tbl) {
  const uint16_t* tb = reinterpret_cast<const uint16_t*>(tbl);
  uint16_t* z = reinterpret_cast<uint16_t*>(&v);
  uint32_t miss = 0;  // the z outside the table, which keep their bits
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const uint32_t b = z[e], x = ((b >> 7) & 0xFF) - TBL_E0;
    const uint16_t h = tb[(b >> 15) * TBL_HALF + min(x, TBL_NE - 1u) * 128 + (b & 127)];
    miss |= static_cast<uint32_t>(x >= TBL_NE) << e;
    z[e] = x < TBL_NE ? h : b;
  }
  if (miss) v = gelu_missed(v, miss);
}

// shared bytes of a product block: the ring, the mbarriers, the tile's
// bias, fc1's GELU table
constexpr int gemm_smem(int bn, int stages, int epi) {
  return stages * (A_BOX + bn * KC * static_cast<int>(sizeof(bf16))) + 256 +
         bn * static_cast<int>(sizeof(float)) + (epi == FC1 ? TBL_BYTES : 0);
}

template <int BN>
__device__ __forceinline__ void wgmma_ss(float (&d)[BN / 2], uint64_t a, uint64_t b) {
  if constexpr (BN == 256) swin::wgmma_ss_n256(d, a, b);
  else if constexpr (BN == 128) swin::wgmma_ss_n128(d, a, b);
  else swin::wgmma_ss_n64(d, a, b);
}

// A product kernel's body: out[tile] = epilogue(A[tile rows] W[tile
// cols]^T + bias), A [M, K] and W [N, K] by the tensor maps tm_a (boxes of
// 128 rows) and tm_w (boxes of BN rows); block b takes row tile b / (N /
// BN) and column tile b % (N / BN).  FC1: out [M, N] = round(gelu(round(.))),
// the GELU by the table gelu_tbl; FC2: out [M, N] = res + round(.), res
// [M, N] the residual x; QKV: out [M, N] = round(.).  A block is
// RING_THREADS threads.
template <int BN, int EPI>
__device__ __forceinline__ void gemm_tile(const CUtensorMap* tm_a, const CUtensorMap* tm_w,
                                          const float* __restrict__ bias,
                                          const bf16* __restrict__ res,
                                          const bf16* __restrict__ gelu_tbl,
                                          bf16* __restrict__ out, int M, int N, int K,
                                          int stages) {
  constexpr int SLOT = A_BOX + BN * KC * static_cast<int>(sizeof(bf16));
  extern __shared__ __align__(1024) unsigned char ring[];
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * SLOT);
  uint64_t* empty = full + swin::MAX_STAGES;
  float* s_bias = reinterpret_cast<float*>(ring + stages * SLOT + 256);
  bf16* tbl = reinterpret_cast<bf16*>(s_bias + BN);
  const int tid = threadIdx.x, lane = tid & 31;
  const int n_tiles = N / BN, nk = K / KC;
  const int m0 = blockIdx.x / n_tiles * BM, n0 = blockIdx.x % n_tiles * BN;
  if (tid == THREADS) {
    if (swin::smem_u32(ring) & 1023) __trap();  // the swizzled boxes need 1024-byte slots
    for (int s = 0; s < stages; ++s) {
      swin::mbar_init(&full[s], 1);
      swin::mbar_init(&empty[s], WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= THREADS) {  // the producer warp: lane 0 fills the ring
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(tm_a))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(tm_w))
                   : "memory");
      for (int c = 0; c < nk; ++c) {
        const int s = c % stages;
        if (c >= stages) swin::mbar_wait(&empty[s], (c / stages - 1) & 1);
        unsigned char* dst = ring + s * SLOT;
        swin::mbar_expect(&full[s], SLOT);
        swin::tma_2d(dst, tm_a, c * KC, m0, &full[s]);
        swin::tma_2d(dst + A_BOX, tm_w, c * KC, n0, &full[s]);
      }
    }
    return;
  }

  // the consumers: warpgroup wg takes rows 64 wg .. 64 wg + 63 of the tile;
  // while the first boxes land they copy the tile's bias (and fc1's table)
  for (int i = tid; i < BN; i += THREADS) s_bias[i] = __ldg(bias + n0 + i);
  if constexpr (EPI == FC1)
    for (int i = tid; i < TBL_BYTES / 16; i += THREADS)
      reinterpret_cast<uint4*>(tbl)[i] = __ldg(reinterpret_cast<const uint4*>(gelu_tbl) + i);
  const int wg = tid >> 7;
  float acc[BN / 2];
  swin::zero(acc);
  int slot = 0, phase = 0, prev = 0;
  for (int c = 0; c < nk; ++c) {
    swin::mbar_wait(&full[slot], phase);
    const bf16* a = reinterpret_cast<const bf16*>(ring + slot * SLOT) + wg * 64 * KC;
    const bf16* w = reinterpret_cast<const bf16*>(ring + slot * SLOT + A_BOX);
    const uint64_t da = swin::swz_desc(a, KC), dw = swin::swz_desc(w, KC);
    swin::wg_fence();
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) wgmma_ss<BN>(acc, da + 2 * ks, dw + 2 * ks);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (c > 0) {  // the previous chunk's products have read their slot
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) swin::mbar_arrive(&empty[prev]);
    }
    prev = slot;
    if (++slot == stages) { slot = 0; phase ^= 1; }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  swin::keep(acc);

  // The epilogue, staged through the ring (both warpgroups are past their
  // last product, so every box has landed and been read): warpgroup wg puts
  // its 64 rows of z = round(acc + bias) into rows of BN + 8 bf16 (the 8
  // rows of a fragment store fall on distinct banks), then takes them back
  // as 16-byte pieces of 8 columns and stores round(gelu(z)) (FC1), x + z
  // rounded (FC2) or z (QKV), rows past M masked.  FC2's rows of x are
  // copied into the ring beside them by cp.async while z is staged.
  constexpr int LDS = BN + 8, PIECES = 64 * (BN / 8) / 128;
  swin::consumers_sync();
  bf16* stage = reinterpret_cast<bf16*>(ring) + wg * 64 * LDS;
  bf16* xs = reinterpret_cast<bf16*>(ring) + (2 + wg) * 64 * LDS;
  // piece i of this thread: p = tid % 128 + 128 i, row p / (BN / 8) of the
  // warpgroup's rows, columns 8 (p % (BN / 8)) ..
  const int wt = tid & 127, rows = M - m0 - 64 * wg;
  auto row_of = [&](int i) { return (wt + 128 * i) / (BN / 8); };
  auto col_of = [&](int i) { return 8 * ((wt + 128 * i) % (BN / 8)); };
  auto off_of = [&](int i) {
    return static_cast<size_t>(m0 + 64 * wg + row_of(i)) * N + n0 + col_of(i);
  };
  if constexpr (EPI == FC2) {
#pragma unroll
    for (int i = 0; i < PIECES; ++i)
      if (row_of(i) < rows) swin::cp_async16(xs + row_of(i) * LDS + col_of(i), res + off_of(i));
    swin::cp_async_commit();
  }
  {
    const int g = lane >> 2, t = lane & 3, r0 = 16 * ((tid >> 5) & 3) + g;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * t;
      const float bias0 = s_bias[col], bias1 = s_bias[col + 1];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        st2(stage + (r0 + 8 * hh) * LDS + col, acc[4 * j + 2 * hh] + bias0,
            acc[4 * j + 2 * hh + 1] + bias1);
    }
  }
  if constexpr (EPI == FC2) swin::cp_async_wait_all();
  swin::wg_sync(wg);
#pragma unroll
  for (int i = 0; i < PIECES; ++i) {
    if (row_of(i) >= rows) break;  // rows grow with i
    uint4 v = *reinterpret_cast<const uint4*>(stage + row_of(i) * LDS + col_of(i));
    if constexpr (EPI == FC1) {
      gelu8(v, tbl);
    } else if constexpr (EPI == FC2) {
      const uint4 xr = *reinterpret_cast<const uint4*>(xs + row_of(i) * LDS + col_of(i));
      const __nv_bfloat162* xa = reinterpret_cast<const __nv_bfloat162*>(&xr);
      __nv_bfloat162* va = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 xf = __bfloat1622float2(xa[e]), vf = __bfloat1622float2(va[e]);
        va[e] = __floats2bfloat162_rn(xf.x + vf.x, xf.y + vf.y);
      }
    }
    *reinterpret_cast<uint4*>(out + off_of(i)) = v;
  }
}

// a product's plan against the layout: the tile width, the ring and its
// shared bytes
template <int EPI>
bool gemm_plan_ok(int N, int K, int bn, int stages, int smem_bytes) {
  return (bn == 64 || bn == 128 || bn == 256) && N % bn == 0 && K % KC == 0 && stages >= 3 &&
         stages <= swin::MAX_STAGES && smem_bytes == gemm_smem(bn, stages, EPI);
}

// One product's launch: a [M, K] by w [N, K] through the ring of `stages`
// slots, bn columns a tile, by `kernel` (a wrapper of gemm_tile<bn, EPI>)
template <class Kernel>
cudaError_t launch_gemm_kernel(Kernel kernel, const void* a, const void* w, const float* bias,
                               const bf16* res, const bf16* gelu_tbl, bf16* out, int M, int N,
                               int K, int bn, int smem_bytes, int stages, cudaStream_t st) {
  CUtensorMap tm_a, tm_w;
  if (!swin::tile_map_2d(&tm_a, a, K, M, BM) || !swin::tile_map_2d(&tm_w, w, K, N, bn))
    return cudaErrorNotSupported;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  const int blocks = (M + BM - 1) / BM * (N / bn);
  kernel<<<blocks, swin::RING_THREADS, smem_bytes, st>>>(tm_a, tm_w, bias, res, gelu_tbl, out,
                                                         M, N, K, stages);
  return cudaGetLastError();
}

}  // namespace swin
