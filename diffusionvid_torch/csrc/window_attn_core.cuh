// The Swin window-attention core shared by K4 (swin_block_attn.cu) and by
// K6 and K7 (window_attn_qkv.cu): the fp32 qkv projection of one head of
// one window, 7x7 or 12x12 (the fp32 paths of K4 and K6), then its fp32
// attention (the fp32 paths of all three; their bf16 paths attend in
// swin_hopper.cuh),
//   s = round(q k^T * 32^-0.5) + bias[head] (+ mask[window])   fp32
//   p = softmax(s) in fp32 (max, exp, divide), rounded
//   o = p v                                                  fp32 sum
// the rounding points of the Pallas kernels' _attention_stripe.  A Store
// functor takes each output element, so each kernel puts the head's output
// where it needs it (a shared tile, a scratch buffer, the output map).
// ops/_build.py hashes this header into every library.

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

// shared bytes of the fp32 kernels at window w: q, k, v [w^2 x FLD] and
// the scores [w^2 x (w^2 + 1)], fp32 (29,204 at window 7, 140,544 at 12:
// dynamic shared memory, above 48 KB by the opt-in attribute)
constexpr int f32_smem(int w) { return 4 * (3 * w * w * FLD + w * w * (w * w + 1)); }

// fp32 on the CUDA cores: q | k | v of head j of a W x W window into s_q,
// s_k, s_v [W^2 x FLD]; row(r) points at token r's C channels.  Each dot
// product over C is one warp, coalesced, with a shuffle sum.  Ends in a
// barrier.
template <int W = WIN, class Row>
__device__ void project_head_f32(Row row, const float* wqkv, const float* bqkv, int C, int j,
                                 float* s_q, float* s_k, float* s_v) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int e = warp; e < W * W * 3 * DH; e += WARPS) {
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

// fp32 on the CUDA cores, one head of a W x W window (NN = W^2 tokens),
// from q/k/v [NN x FLD] in shared memory, the scores in s_s [NN x (NN +
// 1)]; store(row, col, o) gets each output element.  A warp takes a row's
// softmax, lane l its columns l, l + 32, ...  Every thread of the block
// calls it; it ends in a barrier.
template <int W = WIN, class Store>
__device__ void attend_head_f32(const float* s_q, const float* s_k, const float* s_v,
                                float* s_s, const float* bh, const float* mk, Store store) {
  constexpr int NN = W * W, LDS = NN + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, tid = threadIdx.x;
  for (int e = tid; e < NN * NN; e += THREADS) {
    const int r = e / NN, c = e % NN;
    float acc = 0.f;
#pragma unroll
    for (int d = 0; d < DH; ++d) acc = fmaf(s_q[r * FLD + d], s_k[c * FLD + d], acc);
    float v = __fmul_rn(acc, SCALE) + bh[e];
    if (mk) v += mk[e];
    s_s[r * LDS + c] = v;
  }
  __syncthreads();
  for (int r = warp; r < NN; r += WARPS) {
    float* row = s_s + r * LDS;
    float mx = -INFINITY, sum = 0.f;
    for (int c = lane; c < NN; c += 32) mx = fmaxf(mx, row[c]);
#pragma unroll
    for (int o2 = 16; o2 > 0; o2 >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o2));
    for (int c = lane; c < NN; c += 32) {
      const float e = expf(row[c] - mx);
      row[c] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int c = lane; c < NN; c += 32) row[c] /= sum;
  }
  __syncthreads();
  for (int e = tid; e < NN * DH; e += THREADS) {
    const int r = e / DH, d = e % DH;
    float acc = 0.f;
    for (int c = 0; c < NN; ++c) acc = fmaf(s_s[r * LDS + c], s_v[c * FLD + d], acc);
    store(r, d, acc);
  }
  __syncthreads();
}

}  // namespace swin
