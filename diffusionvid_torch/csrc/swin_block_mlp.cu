// Fused Swin MLP half-block (kernel K5).
//
// Replaces: diffusionvid_tpu/ops/swin_attention_pallas.py: fused_swin_block_mlp
//   (the Pallas kernel _kernel_block_mlp).
//
// Contract, per token row of x [M, C] in the compute dtype T:
//   y   = round(LN2(x))                  fp32 LayerNorm (eps, two-pass variance)
//   z   = round(y @ w1^T + b1)           w1 [4C, C], fp32 sum and bias
//   z   = round(gelu(z))                 exact erf GELU in fp32
//   out = x + round(z @ w2^T + b2)       w2 [C, 4C]
// The LayerNorm weights and the biases are fp32.  These are the rounding
// points of the Pallas kernel.
//
// What bounds it on an H100: operations.  For Swin-B at 608x1024 over 4
//   frames the two products are about 1.16 TFLOP per backbone pass (24
//   launches), 1.17 ms at the bf16 tensor-core rate; a stage-2 launch
//   ([4,42,70,512]) is 49.3 GFLOP (50 us) against 24 MB of traffic (7 us).
//
// Design (bf16, C <= 384; also built up to 1024, where only
//   utils/k5_bench.py --paths asks for it), "MLP on the fly": one block of
//   8 warps per tile of TM token rows, compiled per C (TM = 64 and hidden
//   chunks of HC = 64 for C <= 512; 32 and 32 above).  The block writes the
//   tile's LayerNorm into shared memory as bf16, then walks the hidden
//   dimension chunk by chunk: h = gelu(y @ w1[chunk]^T + b1) with mma.sync
//   m16n8k16 tiles, rounded into shared memory as bf16, and acc[TM x C] +=
//   h @ w2[:, chunk]^T in fp32 registers (C/4 or C/8 values a thread: 128
//   at C = 512 and 1024).
//   The [M, 4C] hidden map never reaches device memory, so device memory
//   sees x once and out once.  Each chunk's rows of w1 and columns of w2
//   are copied into shared memory once per block with cp.async (16-byte,
//   coalesced), w2's while fc1 runs and the next w1's while fc2 runs; a
//   warp applies each weight fragment to all the m-tiles it holds.
//   Shared memory: y (C + 8) * TM * 2 B, h (HC + 8) * TM * 2 B, the w1
//   chunk (C + 8) * HC * 2 B and the w2 chunk (HC + 8) * C * 2 B: 216,064 B
//   at C = 512, 216,576 B at C = 1024, 49,664 B at C = 96.  Rows are padded
//   by 16 bytes, so the 8 rows a fragment load touches fall on 8 distinct
//   bank groups.  Known limit: the weights are read from L2 once per row
//   tile, and at C = 1024 (stage 3 of Swin-B at 608x1024, 2,940 tokens)
//   there are 92 tiles for 132 SMs.
//
// Design (bf16, C >= 512: Swin-B's stages 2 and 3, 86% of its K5 time),
//   three launches on the caller's stream, no host synchronisation:
//   1. mlp_ln_kernel: y = round(LN2(x)) into a bf16 [M, C] map, two rows a
//      warp, 16-byte loads and stores, fp32 two-pass variance as above; its
//      threads also fill the GELU table (below) in device memory.
//   2. mlp_gemm_kernel<BN, FC1>: h = round(gelu(round(y w1^T + b1))) into a
//      bf16 [M, 4C] map.
//   3. mlp_gemm_kernel<BN, FC2>: out = x + round(h w2^T + b2).
//   Each stored map is a rounding point of the contract, so the function is
//   the fused design's up to the order of fp32 sums.  The hidden map goes
//   through device memory: at stage 2 ([4,42,70,512], M = 11,760) it is
//   48 MB written and read once (14 us each way at 3.35 TB/s) against 49.3
//   GFLOP (50 us).  Swin-L's C = 1536 (fc1 [6144, 1536], fc2 [1536,
//   6144]) takes this design too: the products are generic in N and K;
//   its LN pass holds a row pair's 48 pieces in 127 registers, no spill
//   (ptxas, chip_smoke.py).
//   The product kernel is one mainloop with two epilogues (in swin_gemm.cuh,
//   with the LN pass's body; K4's staged design runs them too).  A block is two
//   consumer warpgroups and one producer warp (swin::RING_THREADS) and owns
//   an output tile of BM = 128 rows x BN (64, 128 or 256) columns, each
//   warpgroup 64 rows.  The producer's lane 0 streams, per k-chunk of 64
//   channels, an A box (128 rows of y or h) and a W box (BN rows of w1 or
//   w2) by TMA with the 128-byte swizzle into one of `stages` ring slots
//   (full/empty mbarriers); rows past M land as zeros.  The consumers issue
//   wgmma m64nBNk16 with both operands from shared memory (swz_desc) and keep
//   one chunk's group in flight while the next chunk's is issued, freeing a
//   slot once its group has completed: at 128 x 256 the products run at
//   98% of the tensor cores' rate (utils/k5_phases.py).  Blocks take the
//   column tiles of one row tile in turn, so that a tile of A is read from
//   device memory about once.
//   What a block costs besides its products is its first boxes' latency
//   and its epilogue, which the design keeps short.  The epilogue stages z
//   = round(acc + bias) (the tile's bias from shared memory) through the
//   ring in rows padded by 16 bytes, then stores 16-byte pieces: fc1 maps z
//   to round(gelu(z)) by a table, fc2 adds x, whose rows cp.async has
//   copied into the ring while z was staged.  The table: z is a bf16 value,
//   so round(gelu(z)) is a function of 16 bits; the LN pass computes it
//   with gelu() for |z| in [2^-20, 8), 5,888 entries, each fc1 block copies
//   it into shared memory while its first boxes land, and the rare z
//   outside it is computed.  Loads of the bias from device memory one after
//   another, x's 4-byte loads and gelu() on every element each took longer
//   than the products (utils/k5_phases.py).
//   The launch plan (ops/swin_attention.py: mlp_plan, checked below against
//   the layout) picks BN, the ring depth and one or two blocks an SM per
//   product by the fewest waves x work on the card's SMs, with a block's
//   fixed cost counted.  Shared memory: stages x (16,384 + 128 BN) bytes of
//   ring, 256 of barriers, 4 BN of bias and, for fc1, 11,776 of table.
//   The numbers' source: chip_smoke.py (the K5 rows), utils/k5_bench.py
//   and utils/k5_phases.py.
//
// Design (fp32, for the checks): the same chunked walk on the CUDA cores,
//   16 rows a block, the LN'd tile (16 x C) and the hidden chunk in shared
//   memory, each thread accumulating up to 6 output columns of 16 rows in
//   registers (C <= 1536; 184 registers, no spill).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "swin_gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int HC = 64;        // hidden columns per chunk, fp32 path
constexpr int F32_ROWS = 16;  // rows per block, fp32 path
constexpr int F32_COLS = 6;   // output columns per thread (C <= 1536), fp32 path
constexpr float INV_SQRT2 = 0.70710678118654752f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float gelu(float z) {
  return 0.5f * z * (1.f + erff(z * INV_SQRT2));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ void st2(bf16* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* A, int ld, int ra,
                                       int rb, int k0, int t) {
  a[0] = ld32(A + ra * ld + k0 + 2 * t);
  a[1] = ld32(A + rb * ld + k0 + 2 * t);
  a[2] = ld32(A + ra * ld + k0 + 8 + 2 * t);
  a[3] = ld32(A + rb * ld + k0 + 8 + 2 * t);
}

// round(LN(x[m])) -> y[r * ld ...] for rows r of the tile (one warp per
// row; C <= 32 MAXK); rows past M are zero
template <typename T, int MAXK>
__device__ void ln_rows(const T* x, const float* g, const float* bt, T* y, int ld,
                        int m0, int rows, int M, int C, float eps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nk = C / 32;
  for (int r = warp; r < rows; r += WARPS) {
    const int m = m0 + r;
    if (m >= M) {
      for (int c = lane; c < C; c += 32) y[r * ld + c] = from_f<T>(0.f);
      continue;
    }
    const T* src = x + static_cast<size_t>(m) * C;
    float v[MAXK], s = 0.f;
#pragma unroll
    for (int k = 0; k < MAXK; ++k)
      if (k < nk) { v[k] = to_f(src[lane + 32 * k]); s += v[k]; }
    const float mu = warp_sum(s) / C;
    float q = 0.f;
#pragma unroll
    for (int k = 0; k < MAXK; ++k)
      if (k < nk) { v[k] -= mu; q += v[k] * v[k]; }
    const float inv = 1.f / sqrtf(warp_sum(q) / C + eps);
#pragma unroll
    for (int k = 0; k < MAXK; ++k)
      if (k < nk) {
        const int c = lane + 32 * k;
        y[r * ld + c] = from_f<T>(v[k] * inv * g[c] + bt[c]);
      }
  }
}

// ------------------------------------------------------------------ bf16

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until at most one committed group of this thread is still in flight
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }

// Tiling.  A block takes TM token rows and walks the hidden dimension in
// chunks of HC.  The 8 warps form a WM x WN grid for fc2 (a warp takes MTW
// m-tiles of 16 rows and NTW of the C/8 n-tiles) and an FWM x FWN grid for
// fc1 (FMTW m-tiles, FNTW of the chunk's HC/8 n-tiles), so that a weight
// fragment read from shared memory serves several m-tiles.
template <int C>
struct Tile {
  static constexpr int TM = C <= 512 ? 64 : 32;   // rows a block
  static constexpr int HC = C <= 512 ? 64 : 32;   // hidden columns a chunk
  static constexpr int MT = TM / 16;
  static constexpr int WN = (C / 8) % WARPS == 0 ? WARPS : WARPS / 2;
  static constexpr int WM = WARPS / WN;
  static constexpr int MTW = MT / WM;
  static constexpr int NTW = C / 8 / WN;
  static constexpr int FWN = HC / 8 < WARPS ? HC / 8 : WARPS;
  static constexpr int FWM = WARPS / FWN;
  static constexpr int FMTW = MT / FWM;
  static constexpr int FNTW = HC / 8 / FWN;
  static constexpr int LDY = C + 8;               // y and w1-chunk rows
  static constexpr int LDH = HC + 8;              // h and w2-chunk rows
  // shared memory: y [TM, C], h [TM, HC], w1 chunk [HC, C], w2 chunk [C, HC]
  static constexpr size_t Y = 0;
  static constexpr size_t H = Y + sizeof(bf16) * TM * LDY;
  static constexpr size_t W1 = H + sizeof(bf16) * TM * LDH;
  static constexpr size_t W2 = W1 + sizeof(bf16) * HC * LDY;
  static constexpr size_t BYTES = W2 + sizeof(bf16) * C * LDH;
  static_assert(C % 32 == 0 && NTW * WN * 8 == C && MTW * WM == MT, "C must be a multiple of 32");
  static_assert(FMTW * FWM == MT && FNTW * FWN * 8 == HC, "fc1 tiling");
  static_assert(BYTES <= 232448, "shared memory over the opt-in limit");
};

template <int C>
__global__ void __launch_bounds__(THREADS, 1)
mlp_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_g,
                const float* __restrict__ ln_b, const bf16* __restrict__ w1,
                const float* __restrict__ b1, const bf16* __restrict__ w2,
                const float* __restrict__ b2, bf16* __restrict__ out, int M, float eps) {
  using L = Tile<C>;
  constexpr int HID = 4 * C, HC = L::HC;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_y = reinterpret_cast<bf16*>(smem + L::Y);
  bf16* s_h = reinterpret_cast<bf16*>(smem + L::H);
  bf16* s_w1 = reinterpret_cast<bf16*>(smem + L::W1);
  bf16* s_w2 = reinterpret_cast<bf16*>(smem + L::W2);

  const int m0 = blockIdx.x * L::TM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, tid = threadIdx.x;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / L::WN, wn = warp % L::WN;
  const int row0 = 16 * L::MTW * wm + g;     // fc2: the warp's first row
  const int fwm = warp / L::FWN, fwn = warp % L::FWN;
  const int frow0 = 16 * L::FMTW * fwm + g;  // fc1: the warp's first row

  // w1 rows h0 .. h0+HC-1 -> s_w1, w2 columns h0 .. h0+HC-1 -> s_w2, as
  // 16-byte copies (C/8 a w1 row, HC/8 a w2 row)
  auto load_w1 = [&](int h0) {
    for (int i = tid; i < HC * (C / 8); i += THREADS) {
      const int r = i / (C / 8), piece = i % (C / 8);
      cp_async16(s_w1 + r * L::LDY + 8 * piece, w1 + static_cast<size_t>(h0 + r) * C + 8 * piece);
    }
  };
  auto load_w2 = [&](int h0) {
    for (int i = tid; i < C * (HC / 8); i += THREADS) {
      const int r = i / (HC / 8), piece = i % (HC / 8);
      cp_async16(s_w2 + r * L::LDH + 8 * piece,
                 w2 + static_cast<size_t>(r) * HID + h0 + 8 * piece);
    }
  };

  load_w1(0);
  cp_async_commit();
  ln_rows<bf16, 32>(x, ln_g, ln_b, s_y, L::LDY, m0, L::TM, M, C, eps);

  float acc[L::MTW][L::NTW][4] = {};
  for (int h0 = 0; h0 < HID; h0 += HC) {
    load_w2(h0);              // lands while fc1 runs
    cp_async_commit();
    cp_async_wait1();         // this chunk's w1 has landed
    __syncthreads();
    // ---- h = round(gelu(round(y @ w1[h0:h0+HC]^T + b1)))
    {
      float hacc[L::FMTW][L::FNTW][4] = {};
#pragma unroll 4
      for (int k0 = 0; k0 < C; k0 += 16) {
        uint32_t a[L::FMTW][4];
#pragma unroll
        for (int i = 0; i < L::FMTW; ++i)
          load_a(a[i], s_y, L::LDY, frow0 + 16 * i, frow0 + 16 * i + 8, k0, t);
#pragma unroll
        for (int q = 0; q < L::FNTW; ++q) {
          const bf16* wr = s_w1 + (8 * (fwn * L::FNTW + q) + g) * L::LDY + k0;
          const uint32_t b0 = ld32(wr + 2 * t), b1v = ld32(wr + 8 + 2 * t);
#pragma unroll
          for (int i = 0; i < L::FMTW; ++i) mma16816(hacc[i][q], a[i], b0, b1v);
        }
      }
#pragma unroll
      for (int q = 0; q < L::FNTW; ++q) {
        const int col = 8 * (fwn * L::FNTW + q) + 2 * t;
        const float bias0 = b1[h0 + col], bias1 = b1[h0 + col + 1];
#pragma unroll
        for (int i = 0; i < L::FMTW; ++i) {
          const int r = frow0 + 16 * i;
          st2(s_h + r * L::LDH + col, gelu(round_bf16(hacc[i][q][0] + bias0)),
              gelu(round_bf16(hacc[i][q][1] + bias1)));
          st2(s_h + (r + 8) * L::LDH + col, gelu(round_bf16(hacc[i][q][2] + bias0)),
              gelu(round_bf16(hacc[i][q][3] + bias1)));
        }
      }
    }
    __syncthreads();          // h is complete and s_w1 free
    if (h0 + HC < HID) load_w1(h0 + HC);   // lands while fc2 runs
    cp_async_commit();
    cp_async_wait1();         // this chunk's w2 has landed
    __syncthreads();
    // ---- acc += h @ w2[:, h0:h0+HC]^T
#pragma unroll
    for (int ks = 0; ks < HC / 16; ++ks) {
      uint32_t a[L::MTW][4];
#pragma unroll
      for (int i = 0; i < L::MTW; ++i)
        load_a(a[i], s_h, L::LDH, row0 + 16 * i, row0 + 16 * i + 8, 16 * ks, t);
#pragma unroll
      for (int q = 0; q < L::NTW; ++q) {
        const bf16* wr = s_w2 + (8 * (wn * L::NTW + q) + g) * L::LDH + 16 * ks;
        const uint32_t b0 = ld32(wr + 2 * t), b1v = ld32(wr + 8 + 2 * t);
#pragma unroll
        for (int i = 0; i < L::MTW; ++i) mma16816(acc[i][q], a[i], b0, b1v);
      }
    }
    __syncthreads();          // s_h and s_w2 free
  }

#pragma unroll
  for (int q = 0; q < L::NTW; ++q) {
    const int c = 8 * (wn * L::NTW + q) + 2 * t;
    const float bias0 = b2[c], bias1 = b2[c + 1];
#pragma unroll
    for (int i = 0; i < L::MTW; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + row0 + 16 * i + 8 * h;
        if (m >= M) continue;
        const size_t off = static_cast<size_t>(m) * C + c;
        const float2 res =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + off));
        st2(out + off, res.x + round_bf16(acc[i][q][2 * h] + bias0),
            res.y + round_bf16(acc[i][q][2 * h + 1] + bias1));
      }
  }
}

template <int C>
cudaError_t launch_bf16(const void* x, const void* g, const void* b, const void* w1,
                        const void* b1, const void* w2, const void* b2, void* out, int M,
                        float eps, cudaStream_t st) {
  using L = Tile<C>;
  cudaError_t err = cudaFuncSetAttribute(
      mlp_bf16_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::BYTES));
  if (err != cudaSuccess) return err;
  mlp_bf16_kernel<C><<<(M + L::TM - 1) / L::TM, THREADS, L::BYTES, st>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(g),
      static_cast<const float*>(b), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<bf16*>(out), M, eps);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ fp32

__global__ void __launch_bounds__(THREADS)
mlp_f32_kernel(const float* __restrict__ x, const float* __restrict__ ln_g,
               const float* __restrict__ ln_b, const float* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ w2,
               const float* __restrict__ b2, float* __restrict__ out, int M, int C,
               float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_y = reinterpret_cast<float*>(smem);   // [16, C]
  float* s_h = s_y + F32_ROWS * C;               // [16, 64]
  const int hid = 4 * C, tid = threadIdx.x;
  const int m0 = blockIdx.x * F32_ROWS;

  ln_rows<float, F32_COLS * THREADS / 32>(x, ln_g, ln_b, s_y, C, m0, F32_ROWS, M, C, eps);
  __syncthreads();

  float acc[F32_COLS][F32_ROWS] = {};
  for (int h0 = 0; h0 < hid; h0 += HC) {
    {
      const int k = tid % HC;
      const float* w = w1 + static_cast<size_t>(h0 + k) * C;
      for (int r = tid / HC; r < F32_ROWS; r += THREADS / HC) {
        float z = 0.f;
        for (int c = 0; c < C; ++c) z = fmaf(s_y[r * C + c], w[c], z);
        s_h[r * HC + k] = gelu(z + b1[h0 + k]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < F32_COLS; ++q) {
      const int c = tid + THREADS * q;
      if (c >= C) break;
      const float* w = w2 + static_cast<size_t>(c) * hid + h0;
      for (int k = 0; k < HC; ++k) {
        const float wk = w[k];
#pragma unroll
        for (int r = 0; r < F32_ROWS; ++r) acc[q][r] = fmaf(s_h[r * HC + k], wk, acc[q][r]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < F32_COLS; ++q) {
    const int c = tid + THREADS * q;
    if (c >= C) break;
#pragma unroll
    for (int r = 0; r < F32_ROWS; ++r) {
      const int m = m0 + r;
      if (m < M) out[static_cast<size_t>(m) * C + c] =
          x[static_cast<size_t>(m) * C + c] + (acc[q][r] + b2[c]);
    }
  }
}

// ------------------------------------------------- bf16, C >= 512: wgmma
// (the product and the LN pass are in swin_gemm.cuh, shared with K4)

using swin::FC1;
using swin::FC2;
using swin::LN_ROWS;

// y[m] = round(LN(x[m])) (swin::ln_rows_pass); the grid's threads also
// fill the GELU table gelu_tbl [TBL].
template <int C>
__global__ void __launch_bounds__(THREADS)
mlp_ln_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_g,
              const float* __restrict__ ln_b, bf16* __restrict__ y, bf16* __restrict__ gelu_tbl,
              int M, float eps) {
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < swin::TBL; i += gridDim.x * THREADS)
    gelu_tbl[i] = swin::gelu_entry(i);
  swin::ln_rows_pass<C>(x, ln_g, ln_b, y, M, eps, [](int) { return true; });
}

// the product kernel (swin::gemm_tile): FC1 with the GELU table, FC2 with
// the residual
template <int BN, int EPI>
__global__ void __launch_bounds__(swin::RING_THREADS, BN <= 128 ? 2 : 1)
mlp_gemm_kernel(const __grid_constant__ CUtensorMap tm_a,
                const __grid_constant__ CUtensorMap tm_w, const float* __restrict__ bias,
                const bf16* __restrict__ res, const bf16* __restrict__ gelu_tbl,
                bf16* __restrict__ out, int M, int N, int K, int stages) {
  swin::gemm_tile<BN, EPI>(&tm_a, &tm_w, bias, res, gelu_tbl, out, M, N, K, stages);
}

// One product's launch: a [M, K] by w [N, K] through the ring of `stages`
// slots, bn columns a tile
template <int EPI>
cudaError_t launch_gemm(const void* a, const void* w, const float* bias, const bf16* res,
                        const bf16* gelu_tbl, bf16* out, int M, int N, int K, int bn,
                        int stages, int smem_bytes, cudaStream_t st) {
  auto kernel = bn == 256 ? mlp_gemm_kernel<256, EPI>
                : bn == 128 ? mlp_gemm_kernel<128, EPI> : mlp_gemm_kernel<64, EPI>;
  return swin::launch_gemm_kernel(kernel, a, w, bias, res, gelu_tbl, out, M, N, K, bn,
                                  smem_bytes, stages, st);
}

template <int C>
cudaError_t launch_ln(const void* x, const void* g, const void* b, void* y, void* gelu_tbl,
                      int M, float eps, cudaStream_t st) {
  mlp_ln_kernel<C><<<(M + LN_ROWS - 1) / LN_ROWS, THREADS, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(g), static_cast<const float*>(b),
      static_cast<bf16*>(y), static_cast<bf16*>(gelu_tbl), M, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x/out [M, C]; dtype: 0 = float32 (C a multiple of 32 up to 1536), 1 =
// bfloat16 (C one of 96, 128, 192, 256, 384, 512, 768, 1024; 1536 takes
// the wgmma design only: its tiles would not fit).  Other widths:
// cudaErrorInvalidValue.
// Launches on `stream`; returns the launch's cudaGetLastError().
extern "C" int swin_block_mlp_fwd(const void* x, const void* ln_g, const void* ln_b,
                                  const void* w1, const void* b1, const void* w2,
                                  const void* b2, void* out, int M, int C, float eps,
                                  int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (C > THREADS * F32_COLS || C % 32) return static_cast<int>(cudaErrorInvalidValue);
    const size_t bytes = sizeof(float) * (F32_ROWS * C + F32_ROWS * HC);
    cudaError_t err = cudaFuncSetAttribute(
        mlp_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    mlp_f32_kernel<<<(M + F32_ROWS - 1) / F32_ROWS, THREADS, bytes, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(ln_g),
        static_cast<const float*>(ln_b), static_cast<const float*>(w1),
        static_cast<const float*>(b1), static_cast<const float*>(w2),
        static_cast<const float*>(b2), static_cast<float*>(out), M, C, eps);
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t err;
  switch (C) {
    case 96: err = launch_bf16<96>(x, ln_g, ln_b, w1, b1, w2, b2, out, M, eps, st); break;
    case 128: err = launch_bf16<128>(x, ln_g, ln_b, w1, b1, w2, b2, out, M, eps, st); break;
    case 192: err = launch_bf16<192>(x, ln_g, ln_b, w1, b1, w2, b2, out, M, eps, st); break;
    case 256: err = launch_bf16<256>(x, ln_g, ln_b, w1, b1, w2, b2, out, M, eps, st); break;
    case 384: err = launch_bf16<384>(x, ln_g, ln_b, w1, b1, w2, b2, out, M, eps, st); break;
    case 512: err = launch_bf16<512>(x, ln_g, ln_b, w1, b1, w2, b2, out, M, eps, st); break;
    case 768: err = launch_bf16<768>(x, ln_g, ln_b, w1, b1, w2, b2, out, M, eps, st); break;
    case 1024: err = launch_bf16<1024>(x, ln_g, ln_b, w1, b1, w2, b2, out, M, eps, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The bf16 design from C = 512 on, at any width of 128, 192, 256, 384, 512,
// 768, 1024 or 1536: y [M, C], h [M, 4C] and gelu [5,888] (the GELU table) are
// bf16 scratch; (bn1, stages1, smem1) and (bn2, stages2, smem2) are the
// plans of the fc1 and fc2 products (ops/swin_attention.py: mlp_plan), checked against the
// layout (cudaErrorInvalidValue otherwise).  Three launches on `stream`;
// returns the first error.
extern "C" int swin_block_mlp_wgmma(const void* x, const void* ln_g, const void* ln_b,
                                    const void* w1, const void* b1, const void* w2,
                                    const void* b2, void* out, void* y, void* h, void* gelu,
                                    int M, int C,
                                    float eps, int bn1, int stages1, int smem1, int bn2,
                                    int stages2, int smem2, void* stream) {
  if (!swin::gemm_plan_ok<FC1>(4 * C, C, bn1, stages1, smem1) ||
      !swin::gemm_plan_ok<FC2>(C, 4 * C, bn2, stages2, smem2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (C) {
    case 128: err = launch_ln<128>(x, ln_g, ln_b, y, gelu, M, eps, st); break;
    case 192: err = launch_ln<192>(x, ln_g, ln_b, y, gelu, M, eps, st); break;
    case 256: err = launch_ln<256>(x, ln_g, ln_b, y, gelu, M, eps, st); break;
    case 384: err = launch_ln<384>(x, ln_g, ln_b, y, gelu, M, eps, st); break;
    case 512: err = launch_ln<512>(x, ln_g, ln_b, y, gelu, M, eps, st); break;
    case 768: err = launch_ln<768>(x, ln_g, ln_b, y, gelu, M, eps, st); break;
    case 1024: err = launch_ln<1024>(x, ln_g, ln_b, y, gelu, M, eps, st); break;
    case 1536: err = launch_ln<1536>(x, ln_g, ln_b, y, gelu, M, eps, st); break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_gemm<FC1>(y, w1, static_cast<const float*>(b1), nullptr,
                         static_cast<const bf16*>(gelu), static_cast<bf16*>(h), M, 4 * C, C, bn1,
                         stages1, smem1, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_gemm<FC2>(h, w2, static_cast<const float*>(b2),
                                           static_cast<const bf16*>(x), nullptr,
                                           static_cast<bf16*>(out), M, C, 4 * C, bn2, stages2,
                                           smem2, st));
}
