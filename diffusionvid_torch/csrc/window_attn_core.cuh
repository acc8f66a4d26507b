// The Swin window-attention core shared by K4 (swin_block_attn.cu) and by
// K6 and K7 (window_attn_qkv.cu): the fp32 qkv projection of one head of
// one 7x7 window (the fp32 paths of K4 and K6), then its attention (bf16:
// K7's; K4's and K6's bf16 paths attend in swin_hopper.cuh),
//   s = round(q k^T * 32^-0.5) + bias[head] (+ mask[window])   fp32
//   p = softmax(s) in fp32 (max, exp, divide), rounded
//   o = p v                                                  fp32 sum
// the rounding points of the Pallas kernels' _attention_stripe.  A Store
// functor takes each output pair or element, so each kernel puts the
// head's output where it needs it (a shared tile, a scratch buffer, the
// output map).  ops/_build.py hashes this header into every library.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace swin {

using bf16 = __nv_bfloat16;

constexpr int WIN = 7;
constexpr int N = WIN * WIN;  // tokens per window
constexpr int DH = 32;        // channels per head
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int LDQ = DH + 8;   // q, k rows (bf16)
constexpr int LDV = 64 + 8;   // v^T rows: 64 keys (bf16)
constexpr int FLD = DH + 1;   // fp32 q/k/v rows
constexpr int SLD = N + 1;    // fp32 score rows
constexpr float SCALE = 0.17677669529663687f;  // 32^-0.5

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t ldg32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ void st2(bf16* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

// D += A B, m16n8k16, bf16 inputs, fp32 accumulators
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of a row-major bf16 tile: rows ra and rb, columns k0..k0+15
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* A, int ld, int ra,
                                       int rb, int k0, int t) {
  a[0] = ld32(A + ra * ld + k0 + 2 * t);
  a[1] = ld32(A + rb * ld + k0 + 2 * t);
  a[2] = ld32(A + ra * ld + k0 + 8 + 2 * t);
  a[3] = ld32(A + rb * ld + k0 + 8 + 2 * t);
}

// The window (b, wr, wc) of block blockIdx.x over B maps of Hp x Wp, and
// its index wmap within its map (the mask's [window row, window col]).
struct Window {
  int b, wr, wc, wmap;
  __device__ Window(int Hp, int Wp) {
    const int nww = Wp / WIN, nwin_map = (Hp / WIN) * nww;
    b = blockIdx.x / nwin_map;
    wmap = blockIdx.x % nwin_map;
    wr = wmap / nww;
    wc = wmap % nww;
  }
  // token i of the window -> its element offset in a [B, Hp, Wp, C] map
  __device__ __forceinline__ size_t offset(int Hp, int Wp, int C, int i) const {
    const int row = wr * WIN + i / WIN, col = wc * WIN + i % WIN;
    return ((static_cast<size_t>(b) * Hp + row) * Wp + col) * C;
  }
};

// fp32 on the CUDA cores: q | k | v of head j into s_q, s_k, s_v [49 x
// FLD]; row(r) points at token r's C channels.  Each dot product over C is
// one warp, coalesced, with a shuffle sum.  Ends in a barrier.
template <class Row>
__device__ void project_head_f32(Row row, const float* wqkv, const float* bqkv, int C, int j,
                                 float* s_q, float* s_k, float* s_v) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int e = warp; e < N * 3 * DH; e += WARPS) {
    const int r = e / (3 * DH), cc = e % (3 * DH), part = cc / DH, d = cc % DH;
    const int wr_row = part * C + j * DH + d;
    const float* a = row(r);
    const float* wt = wqkv + static_cast<size_t>(wr_row) * C;
    float acc = 0.f;
    for (int k = lane; k < C; k += 32) acc = fmaf(a[k], wt[k], acc);
    acc = warp_sum(acc);
    if (lane == 0) {
      float* dst = part == 0 ? s_q : part == 1 ? s_k : s_v;
      dst[r * FLD + d] = acc + bqkv[wr_row];
    }
  }
  __syncthreads();
}

// bf16, one head, from s_q, s_k [64 x LDQ] (row-major) and s_vt [DH x
// LDV] (v transposed); rows past 48 may hold anything finite.  Warp w < 4
// owns query rows 16w..16w+15 and all 64 keys (keys past 48 get -inf):
// the scores stay in registers, softmax with quad shuffles, and the
// probabilities become the A fragments of P.V directly.  Each thread
// fetches its bias (bh [49, 49]) and mask (mk [49, 49] or null) values
// before the score products, so that their latency overlaps them.
// store(row, col, o0, o1) gets the fp32 outputs of columns col, col + 1
// (0..31) of each row < 49.  Warps 4..7 return at once.
template <class Store>
__device__ __forceinline__ void attend_head_bf16(const bf16* s_q, const bf16* s_k,
                                                 const bf16* s_vt, const float* bh,
                                                 const float* mk, Store store) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp >= 4) return;
  const int g = lane >> 2, t = lane & 3;
  const int qa = 16 * warp + g, qb = qa + 8;
  const int r0 = min(qa, N - 1), r1 = min(qb, N - 1);
  float bv[8][4], mv[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int cc = min(8 * nt + 2 * t + (e & 1), N - 1), r = e < 2 ? r0 : r1;
      bv[nt][e] = bh[r * N + cc];
      mv[nt][e] = mk ? mk[r * N + cc] : 0.f;
    }
  float s[8][4] = {};
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    uint32_t a[4];
    load_a(a, s_q, LDQ, qa, qb, 16 * ks, t);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const bf16* kr = s_k + (8 * nt + g) * LDQ + 16 * ks;
      mma16816(s[nt], a, ld32(kr + 2 * t), ld32(kr + 8 + 2 * t));
    }
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * nt + 2 * t + (e & 1);
      float v = round_bf16(s[nt][e] * SCALE);
      if (col < N) {
        v += bv[nt][e];
        if (mk) v += mv[nt][e];
      } else {
        v = -INFINITY;
      }
      s[nt][e] = v;
      if (e < 2) mx0 = fmaxf(mx0, v); else mx1 = fmaxf(mx1, v);
    }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
  }
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = expf(s[nt][e] - (e < 2 ? mx0 : mx1));
      s[nt][e] = v;
      if (e < 2) sum0 += v; else sum1 += v;
    }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, o);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, o);
  }
  // o = p v; the score accumulators of n-tiles 2kk, 2kk+1 are the A
  // fragment of keys 16kk..16kk+15
  float acc[4][4] = {};
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    a[0] = pack2(s[2 * kk][0] / sum0, s[2 * kk][1] / sum0);
    a[1] = pack2(s[2 * kk][2] / sum1, s[2 * kk][3] / sum1);
    a[2] = pack2(s[2 * kk + 1][0] / sum0, s[2 * kk + 1][1] / sum0);
    a[3] = pack2(s[2 * kk + 1][2] / sum1, s[2 * kk + 1][3] / sum1);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const bf16* vr = s_vt + (8 * nt + g) * LDV + 16 * kk;
      mma16816(acc[nt], a, ld32(vr + 2 * t), ld32(vr + 8 + 2 * t));
    }
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int c = 8 * nt + 2 * t;
    if (qa < N) store(qa, c, acc[nt][0], acc[nt][1]);
    if (qb < N) store(qb, c, acc[nt][2], acc[nt][3]);
  }
}

// fp32 on the CUDA cores, one head, from q/k/v [49 x FLD] in shared memory,
// the scores in s_s [49 x SLD]; store(row, col, o) gets each output
// element.  Every thread of the block calls it; it ends in a barrier.
template <class Store>
__device__ void attend_head_f32(const float* s_q, const float* s_k, const float* s_v,
                                float* s_s, const float* bh, const float* mk, Store store) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, tid = threadIdx.x;
  for (int e = tid; e < N * N; e += THREADS) {
    const int r = e / N, c = e % N;
    float acc = 0.f;
#pragma unroll
    for (int d = 0; d < DH; ++d) acc = fmaf(s_q[r * FLD + d], s_k[c * FLD + d], acc);
    float v = __fmul_rn(acc, SCALE) + bh[e];
    if (mk) v += mk[e];
    s_s[r * SLD + c] = v;
  }
  __syncthreads();
  for (int r = warp; r < N; r += WARPS) {
    float* row = s_s + r * SLD;
    const float v0 = row[lane], v1 = lane + 32 < N ? row[lane + 32] : -INFINITY;
    float mx = fmaxf(v0, v1);
#pragma unroll
    for (int o2 = 16; o2 > 0; o2 >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o2));
    const float e0 = expf(v0 - mx), e1 = lane + 32 < N ? expf(v1 - mx) : 0.f;
    const float sum = warp_sum(e0 + e1);
    row[lane] = e0 / sum;
    if (lane + 32 < N) row[lane + 32] = e1 / sum;
  }
  __syncthreads();
  for (int e = tid; e < N * DH; e += THREADS) {
    const int r = e / DH, d = e % DH;
    float acc = 0.f;
    for (int c = 0; c < N; ++c) acc = fmaf(s_s[r * SLD + c], s_v[c * FLD + d], acc);
    store(r, d, acc);
  }
  __syncthreads();
}

}  // namespace swin
