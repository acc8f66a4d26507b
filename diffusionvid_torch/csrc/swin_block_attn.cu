// Fused Swin attention half-block (kernel K4).
//
// Replaces: diffusionvid_tpu/ops/swin_attention_pallas.py: fused_swin_block_attn
//   (the Pallas kernels _kernel_block_attn / _kernel_block_attn_masked).
//
// Contract, per 7x7 window of the (pre-rolled, window-padded) map
// x [B, Hp, Wp, C], C = 32 * heads, in the compute dtype T:
//   y   = LN1(x) in fp32 (eps, two-pass variance), times the 0/1 pad mask
//         ((row + shift) % Hp < hv) & ((col + shift) % Wp < wv), rounded to T
//   qkv = y @ wqkv^T + bqkv             fp32 sum, fp32 bias, rounded
//   s   = round(q k^T * 32^-0.5) + bias[head] (+ mask[window])   fp32
//   p   = softmax(s) in fp32 (max, exp, divide), rounded
//   o   = p v                            fp32 sum, rounded
//   out = x + round(o @ wproj^T + bproj) in T
// bias [heads, 49, 49] and mask [Hp/7, Wp/7, 49, 49] (0 or -100) are fp32;
// the LayerNorm weights and the biases are fp32.  These are the rounding
// points of the Pallas kernel; the pad region of x keeps its values.
//
// What bounds it on an H100: operations.  For Swin-B at 608x1024 over 4
//   frames (maps [4,154,259,128], [4,77,133,256], [4,42,70,512],
//   [4,21,35,1024]) the products are about 613 GFLOP per backbone pass
//   (24 launches), 0.62 ms at the bf16 tensor-core rate; a stage-2 launch
//   is 25.9 GFLOP (26 us) against 27 MB of traffic (8 us).  At stage 0 the
//   bytes (82 MB, 24 us) are as large as the operations (25 us).
//
// Design (bf16): one block of 8 warps per window, looping over the heads.
//   The block writes the window's LN'd tokens into shared memory as bf16
//   (49 rows; a 16-row tile that runs past row 48 reads row 48 again, and
//   those rows are never stored).  Per head, mma.sync m16n8k16 tiles form
//   q, k (row-major) and v (transposed) [64 x 32] from the LN'd tile and
//   the head's 96 rows of wqkv, read from L2 (six warps, two 8-column
//   n-tiles each).  Four warps then each hold 16 query rows of the 64-key
//   score tile in registers: scale, round, bias, mask, softmax (quad
//   shuffles), and the probabilities become the A fragments of P.V
//   directly.  The head's output goes into a second [49 x C] bf16 tile;
//   last, the out-projection streams wproj from L2 in 16-column chunks,
//   adds the bias and the residual and stores.  In both products a warp
//   applies each weight fragment to all four 16-row m-tiles.  Each thread
//   fetches its bias and mask values before the score products, so their
//   latency overlaps the products.  The kernel is held to 128 registers,
//   so that two blocks share an SM where shared memory allows (C <= 512;
//   ptxas spills 112 bytes a thread for it).  Rows are
//   padded by 16 bytes, so the 8 rows a fragment load touches fall on 8
//   distinct bank groups.
//   Shared memory, bf16: LN tile 98*(C+8) B + output tile 98*(C+8) B +
//   q, k 5120 B each + v^T 4608 B = 217,120 B at C = 1024 (under the
//   232,448 B opt-in limit), 41,504 B at C = 128.
//   Known limit: stage 3 of Swin-B at 608x1024 has 4 x 3 x 5 = 60 windows,
//   fewer blocks than the card's 132 SMs.  Weights are re-read from L2 by
//   every window; tiling several windows per block or wgmma with TMA is the
//   next step.
//
// Design (fp32, for the checks): the same phases on the CUDA cores, one
//   block per window; the LN'd tile and the head outputs live in a device
//   scratch buffer [2, windows, 49, C] that the wrapper allocates (an fp32
//   [49 x C] tile at C = 1024 takes 200 KB), q/k/v and the scores in shared
//   memory (29,204 B).  Each dot product over C is one warp with coalesced
//   loads and a shuffle sum.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

struct Params {
  const void* x;
  const float* ln_g;
  const float* ln_b;
  const void* wqkv;
  const float* bqkv;
  const float* bias;
  const float* mask;  // may be null
  const void* wproj;
  const float* bproj;
  void* out;
  float* scratch;     // fp32 path only
  int B, Hp, Wp, C, heads, hv, wv, shift;
  float eps;
};

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

// token i of window (b, wr, wc) -> its element offset in the map
__device__ __forceinline__ size_t token_offset(const Params& p, int b, int wr, int wc, int i) {
  const int row = wr * WIN + i / WIN, col = wc * WIN + i % WIN;
  return ((static_cast<size_t>(b) * p.Hp + row) * p.Wp + col) * p.C;
}

// LN1 and the pad mask over the window's 49 tokens -> y [49, ld] in T;
// one warp per token, lane owns channels lane + 32k
template <typename T>
__device__ void ln_window(const Params& p, T* y, int ld, int b, int wr, int wc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int C = p.C, nk = C / 32;
  const T* x = static_cast<const T*>(p.x);
  for (int i = warp; i < N; i += WARPS) {
    const T* src = x + token_offset(p, b, wr, wc, i);
    float v[32], s = 0.f;
#pragma unroll
    for (int k = 0; k < 32; ++k)
      if (k < nk) { v[k] = to_f(src[lane + 32 * k]); s += v[k]; }
    const float mu = warp_sum(s) / C;
    float q = 0.f;
#pragma unroll
    for (int k = 0; k < 32; ++k)
      if (k < nk) { v[k] -= mu; q += v[k] * v[k]; }
    const float inv = 1.f / sqrtf(warp_sum(q) / C + p.eps);
    const int row = wr * WIN + i / WIN, col = wc * WIN + i % WIN;
    const float keep = ((row + p.shift) % p.Hp < p.hv && (col + p.shift) % p.Wp < p.wv)
                           ? 1.f : 0.f;
#pragma unroll
    for (int k = 0; k < 32; ++k)
      if (k < nk) {
        const int c = lane + 32 * k;
        y[i * ld + c] = from_f<T>((v[k] * inv * p.ln_g[c] + p.ln_b[c]) * keep);
      }
  }
}

// ------------------------------------------------------------------ bf16

struct SmemBf16 {
  int ldx;
  size_t xn, o, q, k, vt, bytes;
  __host__ __device__ explicit SmemBf16(int C) {
    ldx = C + 8;
    xn = 0;
    o = xn + sizeof(bf16) * N * ldx;
    q = o + sizeof(bf16) * N * ldx;
    k = q + sizeof(bf16) * 64 * LDQ;
    vt = k + sizeof(bf16) * 64 * LDQ;
    bytes = vt + sizeof(bf16) * DH * LDV;
  }
};

__global__ void __launch_bounds__(THREADS, 2)
attn_bf16_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const SmemBf16 L(p.C);
  bf16* s_xn = reinterpret_cast<bf16*>(smem + L.xn);
  bf16* s_o = reinterpret_cast<bf16*>(smem + L.o);
  bf16* s_q = reinterpret_cast<bf16*>(smem + L.q);
  bf16* s_k = reinterpret_cast<bf16*>(smem + L.k);
  bf16* s_vt = reinterpret_cast<bf16*>(smem + L.vt);

  const int C = p.C, ldx = L.ldx;
  const int nww = p.Wp / WIN, nwin_map = (p.Hp / WIN) * nww;
  const int b = blockIdx.x / nwin_map, wmap = blockIdx.x % nwin_map;
  const int wr = wmap / nww, wc = wmap % nww;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bf16* wqkv = static_cast<const bf16*>(p.wqkv);
  const bf16* wproj = static_cast<const bf16*>(p.wproj);
  const float scale = 0.17677669529663687f;  // 32^-0.5

  ln_window<bf16>(p, s_xn, ldx, b, wr, wc);
  __syncthreads();

  // In both products a warp covers all four 16-row m-tiles (rows past 48
  // read row 48), so each weight fragment it reads from L2 serves 64 rows.
  int ra[4], rb[4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    ra[mt] = min(16 * mt + g, N - 1);
    rb[mt] = min(16 * mt + g + 8, N - 1);
  }

  for (int j = 0; j < p.heads; ++j) {
    // ---- q | k | v = y @ wqkv[head rows]^T + b: [64 x 96], 12 n-tiles,
    // warp w < 6 takes n-tiles 2w, 2w + 1
    if (warp < 6) {
      float acc[4][2][4] = {};
      const bf16* wrow[2];
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
        const int nt = 2 * warp + nn;
        wrow[nn] = wqkv + static_cast<size_t>((nt >> 2) * C + j * DH + (nt & 3) * 8 + g) * C;
      }
      for (int k0 = 0; k0 < C; k0 += 16) {
        uint32_t a[4][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) load_a(a[mt], s_xn, ldx, ra[mt], rb[mt], k0, t);
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
          const uint32_t b0 = ldg32(wrow[nn] + k0 + 2 * t);
          const uint32_t b1 = ldg32(wrow[nn] + k0 + 8 + 2 * t);
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) mma16816(acc[mt][nn], a[mt], b0, b1);
        }
      }
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
        const int nt = 2 * warp + nn, part = nt >> 2, d = (nt & 3) * 8 + 2 * t;
        const float bias0 = p.bqkv[part * C + j * DH + d];
        const float bias1 = p.bqkv[part * C + j * DH + d + 1];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * mt + g + 8 * h;  // 0..63
            const float v0 = acc[mt][nn][2 * h] + bias0, v1 = acc[mt][nn][2 * h + 1] + bias1;
            if (part == 0) {
              st2(s_q + r * LDQ + d, v0, v1);
            } else if (part == 1) {
              st2(s_k + r * LDQ + d, v0, v1);
            } else {
              s_vt[d * LDV + r] = __float2bfloat16_rn(v0);
              s_vt[(d + 1) * LDV + r] = __float2bfloat16_rn(v1);
            }
          }
      }
    }
    __syncthreads();

    // ---- attention: warp w < 4 owns query rows 16w..16w+15, all 64 keys
    if (warp < 4) {
      const int qa = 16 * warp + g, qb = qa + 8;
      const int r0 = min(qa, N - 1), r1 = min(qb, N - 1);
      const float* bh = p.bias + static_cast<size_t>(j) * N * N;
      const float* mk = p.mask ? p.mask + static_cast<size_t>(wmap) * N * N : nullptr;
      // this thread's bias and mask values, fetched before the products so
      // that their latency overlaps them
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
          float v = round_bf16(s[nt][e] * scale);
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
        const int c = j * DH + 8 * nt + 2 * t;
        if (qa < N) st2(s_o + qa * ldx + c, acc[nt][0], acc[nt][1]);
        if (qb < N) st2(s_o + qb * ldx + c, acc[nt][2], acc[nt][3]);
      }
    }
    __syncthreads();
  }

  // ---- out = x + round(o @ wproj^T + bproj): 16-column chunks, chunk ci
  // to warp ci % 8
  const bf16* x = static_cast<const bf16*>(p.x);
  bf16* out = static_cast<bf16*>(p.out);
  for (int ci = warp; ci < C / 16; ci += WARPS) {
    float acc[4][2][4] = {};
    const bf16* wrow[2];
#pragma unroll
    for (int nn = 0; nn < 2; ++nn)
      wrow[nn] = wproj + static_cast<size_t>(16 * ci + 8 * nn + g) * C;
    for (int k0 = 0; k0 < C; k0 += 16) {
      uint32_t a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) load_a(a[mt], s_o, ldx, ra[mt], rb[mt], k0, t);
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
        const uint32_t b0 = ldg32(wrow[nn] + k0 + 2 * t);
        const uint32_t b1 = ldg32(wrow[nn] + k0 + 8 + 2 * t);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) mma16816(acc[mt][nn], a[mt], b0, b1);
      }
    }
#pragma unroll
    for (int nn = 0; nn < 2; ++nn) {
      const int c = 16 * ci + 8 * nn + 2 * t;
      const float bias0 = p.bproj[c], bias1 = p.bproj[c + 1];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * mt + g + 8 * h;
          if (r >= N) continue;
          const size_t off = token_offset(p, b, wr, wc, r) + c;
          const float2 res = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + off));
          st2(out + off, res.x + round_bf16(acc[mt][nn][2 * h] + bias0),
              res.y + round_bf16(acc[mt][nn][2 * h + 1] + bias1));
        }
    }
  }
}

// ------------------------------------------------------------------ fp32

__global__ void __launch_bounds__(THREADS)
attn_f32_kernel(Params p) {
  __shared__ float s_q[N * FLD], s_k[N * FLD], s_v[N * FLD], s_s[N * SLD];
  const int C = p.C;
  const int nww = p.Wp / WIN, nwin_map = (p.Hp / WIN) * nww, nwin = p.B * nwin_map;
  const int b = blockIdx.x / nwin_map, wmap = blockIdx.x % nwin_map;
  const int wr = wmap / nww, wc = wmap % nww;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, tid = threadIdx.x;
  const float* wqkv = static_cast<const float*>(p.wqkv);
  const float* wproj = static_cast<const float*>(p.wproj);
  float* xn = p.scratch + static_cast<size_t>(blockIdx.x) * N * C;
  float* o = p.scratch + static_cast<size_t>(nwin + blockIdx.x) * N * C;
  const float scale = 0.17677669529663687f;

  ln_window<float>(p, xn, C, b, wr, wc);
  __syncthreads();  // also orders the block's device-memory writes

  for (int j = 0; j < p.heads; ++j) {
    for (int e = warp; e < N * 3 * DH; e += WARPS) {
      const int r = e / (3 * DH), cc = e % (3 * DH), part = cc / DH, d = cc % DH;
      const int wr_row = part * C + j * DH + d;
      const float* a = xn + r * C;
      const float* w = wqkv + static_cast<size_t>(wr_row) * C;
      float acc = 0.f;
      for (int k = lane; k < C; k += 32) acc = fmaf(a[k], w[k], acc);
      acc = warp_sum(acc);
      if (lane == 0) {
        float* dst = part == 0 ? s_q : part == 1 ? s_k : s_v;
        dst[r * FLD + d] = acc + p.bqkv[wr_row];
      }
    }
    __syncthreads();
    const float* bh = p.bias + static_cast<size_t>(j) * N * N;
    const float* mk = p.mask ? p.mask + static_cast<size_t>(wmap) * N * N : nullptr;
    for (int e = tid; e < N * N; e += THREADS) {
      const int r = e / N, c = e % N;
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc = fmaf(s_q[r * FLD + d], s_k[c * FLD + d], acc);
      float v = __fmul_rn(acc, scale) + bh[e];
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
      o[r * C + j * DH + d] = acc;
    }
    __syncthreads();
  }

  const float* x = static_cast<const float*>(p.x);
  float* out = static_cast<float*>(p.out);
  for (int e = warp; e < N * C; e += WARPS) {
    const int r = e / C, c = e % C;
    const float* a = o + r * C;
    const float* w = wproj + static_cast<size_t>(c) * C;
    float acc = 0.f;
    for (int k = lane; k < C; k += 32) acc = fmaf(a[k], w[k], acc);
    acc = warp_sum(acc);
    if (lane == 0) {
      const size_t off = token_offset(p, b, wr, wc, r) + c;
      out[off] = x[off] + (acc + p.bproj[c]);
    }
  }
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32 (needs scratch: 2 * windows * 49 * C floats),
// 1 = bfloat16.  Launches on `stream`; returns the launch's
// cudaGetLastError().
extern "C" int swin_block_attn_fwd(const void* x, const void* ln_g, const void* ln_b,
                                   const void* wqkv, const void* bqkv, const void* bias,
                                   const void* mask, const void* wproj, const void* bproj,
                                   void* out, void* scratch, int B, int Hp, int Wp, int C,
                                   int heads, int hv, int wv, int shift, float eps,
                                   int dtype, void* stream) {
  Params p{x, static_cast<const float*>(ln_g), static_cast<const float*>(ln_b), wqkv,
           static_cast<const float*>(bqkv), static_cast<const float*>(bias),
           static_cast<const float*>(mask), wproj, static_cast<const float*>(bproj), out,
           static_cast<float*>(scratch), B, Hp, Wp, C, heads, hv, wv, shift, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = B * (Hp / WIN) * (Wp / WIN);
  if (dtype == 1) {
    const size_t bytes = SmemBf16(C).bytes;
    cudaError_t err = cudaFuncSetAttribute(
        attn_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    attn_bf16_kernel<<<blocks, THREADS, bytes, st>>>(p);
  } else {
    attn_f32_kernel<<<blocks, THREADS, 0, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
