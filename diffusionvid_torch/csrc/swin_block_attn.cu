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
//   directly (the core shared with K6/K7, window_attn_core.cuh).  The
//   head's output goes into a second [49 x C] bf16 tile;
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

#include "window_attn_core.cuh"

namespace {

using namespace swin;

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

// LN1 and the pad mask over the window's 49 tokens -> y [49, ld] in T;
// one warp per token, lane owns channels lane + 32k
template <typename T>
__device__ void ln_window(const Params& p, const Window& w, T* y, int ld) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int C = p.C, nk = C / 32;
  const T* x = static_cast<const T*>(p.x);
  for (int i = warp; i < N; i += WARPS) {
    const T* src = x + w.offset(p.Hp, p.Wp, C, i);
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
    const int row = w.wr * WIN + i / WIN, col = w.wc * WIN + i % WIN;
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

  const Window w(p.Hp, p.Wp);
  const int C = p.C, ldx = L.ldx;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bf16* wqkv = static_cast<const bf16*>(p.wqkv);
  const bf16* wproj = static_cast<const bf16*>(p.wproj);

  ln_window<bf16>(p, w, s_xn, ldx);
  __syncthreads();

  // In the out-projection, as in the qkv projection, a warp covers all
  // four 16-row m-tiles (rows past 48 read row 48), so each weight
  // fragment it reads from L2 serves 64 rows.
  int ra[4], rb[4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    ra[mt] = min(16 * mt + g, N - 1);
    rb[mt] = min(16 * mt + g + 8, N - 1);
  }

  for (int j = 0; j < p.heads; ++j) {
    project_head_bf16(s_xn, ldx, wqkv, p.bqkv, C, j, s_q, s_k, s_vt);
    __syncthreads();

    // ---- attention, head j's output into columns 32j.. of the o tile
    attend_head_bf16(s_q, s_k, s_vt, p.bias + static_cast<size_t>(j) * N * N,
                     p.mask ? p.mask + static_cast<size_t>(w.wmap) * N * N : nullptr,
                     [&](int r, int c, float o0, float o1) {
                       st2(s_o + r * ldx + j * DH + c, o0, o1);
                     });
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
          const size_t off = w.offset(p.Hp, p.Wp, C, r) + c;
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
  const int nwin = p.B * (p.Hp / WIN) * (p.Wp / WIN);
  const Window w(p.Hp, p.Wp);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* wqkv = static_cast<const float*>(p.wqkv);
  const float* wproj = static_cast<const float*>(p.wproj);
  float* xn = p.scratch + static_cast<size_t>(blockIdx.x) * N * C;
  float* o = p.scratch + static_cast<size_t>(nwin + blockIdx.x) * N * C;

  ln_window<float>(p, w, xn, C);
  __syncthreads();  // also orders the block's device-memory writes

  for (int j = 0; j < p.heads; ++j) {
    project_head_f32([&](int r) { return xn + r * C; }, wqkv, p.bqkv, C, j, s_q, s_k, s_v);
    attend_head_f32(s_q, s_k, s_v, s_s, p.bias + static_cast<size_t>(j) * N * N,
                    p.mask ? p.mask + static_cast<size_t>(w.wmap) * N * N : nullptr,
                    [&](int r, int d, float v) { o[r * C + j * DH + d] = v; });
  }

  const float* x = static_cast<const float*>(p.x);
  float* out = static_cast<float*>(p.out);
  for (int e = warp; e < N * C; e += WARPS) {
    const int r = e / C, c = e % C;
    const float* a = o + r * C;
    const float* wt = wproj + static_cast<size_t>(c) * C;
    float acc = 0.f;
    for (int k = lane; k < C; k += 32) acc = fmaf(a[k], wt[k], acc);
    acc = warp_sum(acc);
    if (lane == 0) {
      const size_t off = w.offset(p.Hp, p.Wp, C, r) + c;
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
