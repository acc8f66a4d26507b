// Swin window attention with the qkv projection inside (kernel K6) and over
// pre-projected q/k/v maps (kernel K7).
//
// Replaces: diffusionvid_tpu/ops/swin_attention_pallas.py:
//   K6 fused_window_attention_qkv (the Pallas kernels _kernel_qkv_nomask /
//      _kernel_qkv_masked), also the forward of
//      fused_window_attention_qkv_trainable;
//   K7 fused_window_attention (the Pallas kernels _kernel / _kernel_masked).
//
// Contract, per 7x7 window of a window-padded, pre-rolled map [B, Hp, Wp, C],
// C = 32 * heads, in the compute dtype T:
//   K6: q | k | v = x @ wqkv^T + bqkv      fp32 sum, fp32 bias, rounded to T
//   K7: q, k, v read from three maps in T
//   s = round(q k^T * 32^-0.5) + bias[head] (+ mask[window row, window col])  fp32
//   p = softmax(s) in fp32 (max, exp, divide), rounded
//   o = p v                                 fp32 sum, rounded, stored at the
//                                           window's tokens in map layout
// bias [heads, 49, 49] and mask [Hp/7, Wp/7, 49, 49] (0 or -100) are fp32,
// bqkv is fp32.  These are the rounding points of the Pallas kernels.
//
// What bounds them on an H100.  K6: operations at the low-res stages, bytes
//   at stage 0.  For Swin-B at 608x1024 over 5 frames (the train step's
//   maps [5,154,259,128], [5,77,133,256], [5,42,70,512], [5,21,35,1024]) a
//   stage-2 launch is 24.6 GFLOP (25 us at the bf16 tensor-core rate)
//   against 31 MB of traffic (9 us); at stage 0 the 102 MB of x and out
//   (30 us) outweigh the 24.6 GFLOP.  K7 does only the attention, 24.5
//   flops per byte of q, k, v and out: bytes bound at every stage.
//
// Design (bf16), K4's (csrc/swin_block_attn.cu) without LN1, the pad mask,
//   the out-projection and the residual: one block of 8 warps per window,
//   looping over the heads.  K6 copies the window's [49, C] tile of x into
//   shared memory in 16-byte pieces; per head, mma.sync m16n8k16 tiles form
//   q, k (row-major) and v (transposed) [64 x 32] from the tile and the
//   head's 96 rows of wqkv, read from L2 (six warps, two 8-column n-tiles
//   each, every weight fragment applied to all four 16-row m-tiles; rows
//   past 48 repeat row 48 and are never stored).  K7 instead copies the
//   head's 32 columns of q, k and v of the window's 49 tokens (rows past 48
//   repeat row 48).  The attention core is K4's (window_attn_core.cuh):
//   four warps each hold 16 query rows of the 64-key score tile in
//   registers (scale, round, bias, mask, softmax with quad shuffles; keys
//   past 48 get -inf), the probabilities become the A fragments of P.V
//   directly, and each head's 32 output columns go straight to the output
//   map.  Rows are padded by 16 bytes, so the 8 rows a fragment load
//   touches fall on 8 distinct bank groups.
//   Shared memory, K6: x tile 98*(C+8) B + q, k 5120 B each + v^T 4608 B
//   = 115,984 B at C = 1024, 25,040 B at C = 96; K7: 14,848 B.
//   Known limits: warps 6-7 idle in the projection and warps 4-7 in the
//   attention; the weights are re-read from L2 by every window.  Several
//   windows per block, overlapping a head's projection with the previous
//   head's attention, or wgmma with TMA are the next steps.
//
// Design (fp32, for the checks): the same phases on the CUDA cores, one
//   block per window; x is read from device memory (each dot product over C
//   is one warp, coalesced, with a shuffle sum), q/k/v and the scores live
//   in shared memory (29,204 B).

#include "window_attn_core.cuh"

namespace {

using namespace swin;

struct Params {
  const void* x;      // K6: the map; K7: q
  const void* k;      // K7 only
  const void* v;      // K7 only
  const void* wqkv;   // K6 only
  const float* bqkv;  // K6 only
  const float* bias;
  const float* mask;  // may be null
  void* out;
  int B, Hp, Wp, C, heads;
};

__device__ __forceinline__ void cp16(bf16* dst, const bf16* src) {
  *reinterpret_cast<uint4*>(dst) = __ldg(reinterpret_cast<const uint4*>(src));
}

__device__ __forceinline__ const float* head_bias(const Params& p, int j) {
  return p.bias + static_cast<size_t>(j) * N * N;
}
__device__ __forceinline__ const float* window_mask(const Params& p, const Window& w) {
  return p.mask ? p.mask + static_cast<size_t>(w.wmap) * N * N : nullptr;
}

// ------------------------------------------------------------------ bf16

// head j's attention into columns 32j.. of the output map
__device__ __forceinline__ void attend_bf16(const Params& p, const Window& w, const bf16* s_q,
                                            const bf16* s_k, const bf16* s_vt, int j) {
  bf16* out = static_cast<bf16*>(p.out);
  attend_head_bf16(s_q, s_k, s_vt, head_bias(p, j), window_mask(p, w),
                   [&](int r, int c, float o0, float o1) {
                     st2(out + w.offset(p.Hp, p.Wp, p.C, r) + j * DH + c, o0, o1);
                   });
}

struct SmemQkv {
  int ldx;
  size_t x, q, k, vt, bytes;
  __host__ __device__ explicit SmemQkv(int C) {
    ldx = C + 8;
    x = 0;
    q = x + sizeof(bf16) * N * ldx;
    k = q + sizeof(bf16) * 64 * LDQ;
    vt = k + sizeof(bf16) * 64 * LDQ;
    bytes = vt + sizeof(bf16) * DH * LDV;
  }
};

// K6, bf16
__global__ void __launch_bounds__(THREADS, 2)
attn_qkv_bf16_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const SmemQkv L(p.C);
  bf16* s_x = reinterpret_cast<bf16*>(smem + L.x);
  bf16* s_q = reinterpret_cast<bf16*>(smem + L.q);
  bf16* s_k = reinterpret_cast<bf16*>(smem + L.k);
  bf16* s_vt = reinterpret_cast<bf16*>(smem + L.vt);

  const Window w(p.Hp, p.Wp);
  const int C = p.C, ldx = L.ldx;
  const bf16* x = static_cast<const bf16*>(p.x);
  const bf16* wqkv = static_cast<const bf16*>(p.wqkv);

  // the window's [49, C] tile of x, in 16-byte pieces
  const int pieces = C / 8;
  for (int e = threadIdx.x; e < N * pieces; e += THREADS) {
    const int i = e / pieces, c8 = (e % pieces) * 8;
    cp16(s_x + i * ldx + c8, x + w.offset(p.Hp, p.Wp, C, i) + c8);
  }
  __syncthreads();

  for (int j = 0; j < p.heads; ++j) {
    project_head_bf16(s_x, ldx, wqkv, p.bqkv, C, j, s_q, s_k, s_vt);
    __syncthreads();
    attend_bf16(p, w, s_q, s_k, s_vt, j);
    __syncthreads();
  }
}

// K7, bf16
__global__ void __launch_bounds__(THREADS)
attn_bf16_kernel(Params p) {
  __shared__ __align__(16) bf16 s_q[64 * LDQ];
  __shared__ __align__(16) bf16 s_k[64 * LDQ];
  __shared__ __align__(16) bf16 s_vt[DH * LDV];
  const Window w(p.Hp, p.Wp);
  const bf16* q = static_cast<const bf16*>(p.x);
  const bf16* k = static_cast<const bf16*>(p.k);
  const bf16* v = static_cast<const bf16*>(p.v);
  for (int j = 0; j < p.heads; ++j) {
    // head j's 32 columns of the 64 rows (rows past 48 repeat row 48), one
    // 16-byte piece of q, k and v per thread
    {
      const int r = threadIdx.x >> 2, d8 = (threadIdx.x & 3) * 8;
      const size_t off = w.offset(p.Hp, p.Wp, p.C, min(r, N - 1)) + j * DH + d8;
      cp16(s_q + r * LDQ + d8, q + off);
      cp16(s_k + r * LDQ + d8, k + off);
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(v + off));
      const bf16* vv = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int u = 0; u < 8; ++u) s_vt[(d8 + u) * LDV + r] = vv[u];
    }
    __syncthreads();
    attend_bf16(p, w, s_q, s_k, s_vt, j);
    __syncthreads();
  }
}

// ------------------------------------------------------------------ fp32

// head j's attention into columns 32j.. of the output map; ends in a barrier
__device__ void attend_f32(const Params& p, const Window& w, const float* s_q,
                           const float* s_k, const float* s_v, float* s_s, int j) {
  float* out = static_cast<float*>(p.out);
  attend_head_f32(s_q, s_k, s_v, s_s, head_bias(p, j), window_mask(p, w),
                  [&](int r, int d, float o) {
                    out[w.offset(p.Hp, p.Wp, p.C, r) + j * DH + d] = o;
                  });
}

// K6, fp32
__global__ void __launch_bounds__(THREADS)
attn_qkv_f32_kernel(Params p) {
  __shared__ float s_q[N * FLD], s_k[N * FLD], s_v[N * FLD], s_s[N * SLD];
  const Window w(p.Hp, p.Wp);
  const int C = p.C;
  const float* x = static_cast<const float*>(p.x);
  const float* wqkv = static_cast<const float*>(p.wqkv);
  for (int j = 0; j < p.heads; ++j) {
    project_head_f32([&](int r) { return x + w.offset(p.Hp, p.Wp, C, r); }, wqkv, p.bqkv, C,
                     j, s_q, s_k, s_v);
    attend_f32(p, w, s_q, s_k, s_v, s_s, j);
  }
}

// K7, fp32
__global__ void __launch_bounds__(THREADS)
attn_f32_kernel(Params p) {
  __shared__ float s_q[N * FLD], s_k[N * FLD], s_v[N * FLD], s_s[N * SLD];
  const Window w(p.Hp, p.Wp);
  const float* q = static_cast<const float*>(p.x);
  const float* k = static_cast<const float*>(p.k);
  const float* v = static_cast<const float*>(p.v);
  for (int j = 0; j < p.heads; ++j) {
    for (int e = threadIdx.x; e < N * DH; e += THREADS) {
      const int r = e / DH, d = e % DH;
      const size_t off = w.offset(p.Hp, p.Wp, p.C, r) + j * DH + d;
      s_q[r * FLD + d] = q[off];
      s_k[r * FLD + d] = k[off];
      s_v[r * FLD + d] = v[off];
    }
    __syncthreads();
    attend_f32(p, w, s_q, s_k, s_v, s_s, j);
  }
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K6.  dtype: 0 = float32, 1 = bfloat16.  Launches on `stream`; returns the
// launch's cudaGetLastError().
extern "C" int window_attn_qkv_fwd(const void* x, const void* wqkv, const void* bqkv,
                                   const void* bias, const void* mask, void* out, int B,
                                   int Hp, int Wp, int C, int heads, int dtype,
                                   void* stream) {
  Params p{x, nullptr, nullptr, wqkv, static_cast<const float*>(bqkv),
           static_cast<const float*>(bias), static_cast<const float*>(mask), out,
           B, Hp, Wp, C, heads};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = B * (Hp / WIN) * (Wp / WIN);
  if (dtype == 1) {
    const size_t bytes = SmemQkv(C).bytes;
    cudaError_t err = cudaFuncSetAttribute(
        attn_qkv_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    attn_qkv_bf16_kernel<<<blocks, THREADS, bytes, st>>>(p);
  } else {
    attn_qkv_f32_kernel<<<blocks, THREADS, 0, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

// K7.  dtype as above.
extern "C" int window_attn_fwd(const void* q, const void* k, const void* v, const void* bias,
                               const void* mask, void* out, int B, int Hp, int Wp, int C,
                               int heads, int dtype, void* stream) {
  Params p{q, k, v, nullptr, nullptr, static_cast<const float*>(bias),
           static_cast<const float*>(mask), out, B, Hp, Wp, C, heads};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = B * (Hp / WIN) * (Wp / WIN);
  if (dtype == 1) {
    attn_bf16_kernel<<<blocks, THREADS, 0, st>>>(p);
  } else {
    attn_f32_kernel<<<blocks, THREADS, 0, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
