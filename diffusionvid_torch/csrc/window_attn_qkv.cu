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
// Design (bf16), K6: K4's Hopper kernel (csrc/swin_block_attn.cu, its
//   pieces shared through swin_hopper.cuh) without LN1, the pad mask, the
//   out-projection and the residual.  A block is two consumer warpgroups
//   and one producer warp (288 threads).
//   - The prologue copies the block's windows' [49, C] tiles of x (rows
//     padded by 16 bytes) and their masks into shared memory by cp.async.
//   - The ring: the producer warp streams each head's q, k and v rows of
//     wqkv (one 4D TMA box of 3 x 32 rows of kc channels) through `stages`
//     swizzled slots with full/empty mbarriers, so the next head's chunks
//     land while this head's attention runs, and copies each round's fp32
//     attention biases into one of two buffers.
//   - The products: wgmma m64n96k16 on both warpgroups, A from the tile by
//     ldmatrix (rows past 48 read row 48), B from the slot by a swizzled
//     descriptor; from C = 192 on a chunk's products stay in flight while
//     the next chunk's are issued.  split_qkv adds the fp32 bias to the
//     fp32 product and rounds once; q stays in registers.
//   - The attention: each warpgroup's 4 warps, 16 query rows each against
//     all 64 keys, scores and softmax in registers, the quotient as the
//     reciprocal's product plus one Newton step; each head's o [49 x 32]
//     goes straight to the output map at the window's tokens (rows past 48
//     are never stored).
//   - The launch plan (ops/window_attention.py: qkv_plan, checked by the
//     entry point against SmemBf16): wpb windows a block and, unlike K4, a
//     share 1 / hsplit of the heads (hsplit 1, 2 or 4): heads write
//     disjoint output columns and there is no out-projection, so no block
//     needs another's o and no cluster is needed.  wpb 2: warpgroup g takes
//     window 2b + g and both walk the block's heads, each weight tile
//     serving two windows; wpb 1: the two warpgroups take the even and the
//     odd heads of the block's share (a slot holds two heads' rows).  Block
//     blockIdx.x takes window group blockIdx.x / hsplit and head share
//     blockIdx.x % hsplit.  The plan minimises waves x work a block, so
//     that Swin-B's stage 2 (300 windows over 5 frames) does not run a
//     pair-mode second wave 14% full.
//   Shared memory is K4's layout (SmemBf16): the ring stages x 192 kc (wpb
//   1) or 96 kc (wpb 2) bytes, wpb tiles 98 (C + 8) bytes, k and v^T 2 x
//   9,728, masks wpb x 9,616, two biases 19,232, 256 of barriers.
//   The numbers' source: chip_smoke.py (the K6 rows and the ptxas phase)
//   and diffusionvid_torch/utils/k6_bench.py.
//
// Design (bf16), K7: one block of 8 warps per window, looping over the
//   heads; per head it copies the head's 32 columns of q, k and v of the
//   window's 49 tokens (rows past 48 repeat row 48; v transposed), then runs
//   the attention core of window_attn_core.cuh (attend_head_bf16): four
//   warps each hold 16 query rows of the 64-key score tile in registers, the
//   probabilities become the A fragments of P.V directly, and the head's 32
//   output columns go straight to the output map.  Rows are padded by 16
//   bytes, so the 8 rows a fragment load touches fall on 8 distinct bank
//   groups.  Shared memory 14,848 B.
//
// Design (fp32, for the checks): the same phases on the CUDA cores, one
//   block per window; x is read from device memory (each dot product over C
//   is one warp, coalesced, with a shuffle sum), q/k/v and the scores live
//   in shared memory (29,204 B).

#include "swin_hopper.cuh"

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
  int hsplit, kc, stages;  // K6 bf16: the launch plan's head split and ring
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

// K6, bf16 (the design above): block blockIdx.x takes windows win0 ..
// win0 + WPB - 1 and heads head0 .. head0 + heads / hsplit - 1
template <int C, int WPB>
__global__ void __launch_bounds__(RING_THREADS, C <= 128 ? 2 : 1)
attn_qkv_bf16_kernel(Params p, const __grid_constant__ CUtensorMap tm_q) {
  constexpr int SPL = 3 - WPB;   // heads a ring slot holds: the warpgroups take different heads
  constexpr int NB = 2 / SPL;    // attention bias buffers, SPL heads each
  extern __shared__ __align__(1024) unsigned char smem[];
  const int stages = p.stages, kc = p.kc, nk = C / kc;
  const SmemBf16 L(C, WPB, kc, stages);
  const int lda = L.lda;
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int windows = p.B * (p.Hp / WIN) * (p.Wp / WIN);
  const int hpb = p.heads / p.hsplit, rounds = hpb / SPL;
  const int win0 = (blockIdx.x / p.hsplit) * WPB, head0 = (blockIdx.x % p.hsplit) * hpb;
  bf16* s_ring = reinterpret_cast<bf16*>(smem + L.ring);
  bf16* s_a0 = reinterpret_cast<bf16*>(smem + L.a);
  float* s_mask0 = reinterpret_cast<float*>(smem + L.mask);
  float* s_bias = reinterpret_cast<float*>(smem + L.bias);
  Bars* bars = reinterpret_cast<Bars*>(smem + L.bars);
  const int slot_elems = static_cast<int>(L.slot / sizeof(bf16));

  ring_prologue<C, WPB>(smem, bars, stages, static_cast<const bf16*>(p.x), p.mask, p.Hp, p.Wp,
                        win0, windows, s_a0, lda, s_mask0);
  if (tid >= THREADS) {
    ring_producer<SPL, 1, 0>(bars, s_ring, static_cast<int>(L.slot), s_bias, p.bias, &tm_q,
                             nullptr, head0, 0, rounds, 0, kc, nk, stages);
    return;
  }

  // the consumers: this warpgroup's window (wpb 2: the second may not
  // exist, then it repeats the first and stores nothing), tile and heads
  const int my_idx = win0 + (WPB == 2 ? wg : 0);
  const bool mine = my_idx < windows;
  const WindowAt w(min(my_idx, windows - 1), p.Hp, p.Wp);
  const int tile = WPB == 2 ? wg : 0, half = SPL == 2 ? wg : 0;
  const bf16* s_a = s_a0 + tile * N * lda;
  bf16* s_k = reinterpret_cast<bf16*>(smem + L.kv + wg * KV_BYTES);
  bf16* s_vt = s_k + 64 * LDQ;

  // the ring's chunks in order (as K4's): take() waits until the next has
  // landed, release() tells the producer that this warp has read the oldest
  int t_slot = 0, t_phase = 0, r_slot = 0;
  auto take = [&]() {
    mbar_wait(&bars->full[t_slot], t_phase);
    const bf16* slot = s_ring + t_slot * slot_elems;
    if (++t_slot == stages) { t_slot = 0; t_phase ^= 1; }
    return slot;
  };
  auto release = [&]() {
    __syncwarp();
    if (lane == 0) mbar_arrive(&bars->empty[r_slot]);
    if (++r_slot == stages) r_slot = 0;
  };
  constexpr bool ASYNC = C > 128;  // two A register sets fit

  bf16* out = static_cast<bf16*>(p.out);
  for (int j = 0; j < rounds; ++j) {
    float acc[48];  // the warpgroup's head: q | k | v [64 x 96]
    zero(acc);
    products<96, ASYNC>(acc, s_a, lda, kc, nk, 96 * half, take, release);
    const int hl = j * SPL + half, b = j % NB;  // the block's local head, its bias buffer
    uint32_t qa[2][4];
    wg_sync(wg);  // the warpgroup's last attention has read k, v
    split_qkv(acc, p.bqkv + head0 * DH, C, hl, qa, s_k, s_vt);
    wg_sync(wg);
    mbar_wait(&bars->bias_full[b], (j / NB) & 1);
    // the head's 32 columns of token r of the window in the output map
    bf16* o = out + (head0 + hl) * DH;
    attend_head_wg(qa, s_k, s_vt, s_bias + (b * SPL + half) * NN_FLOATS,
                   p.mask ? s_mask0 + tile * NN_FLOATS : nullptr,
                   [&](int r) { return o + w.offset(p.Hp, p.Wp, C, r); }, mine);
    __syncwarp();
    if (lane == 0) mbar_arrive(&bars->bias_empty[b]);
  }
}

// The launch plan's checks: the head split, the ring and its shared bytes.
template <int C, int WPB>
bool qkv_plan_ok(int heads, int hsplit, int kc, int stages, int smem_bytes) {
  return (hsplit == 1 || hsplit == 2 || hsplit == 4) && heads % (hsplit * (3 - WPB)) == 0 &&
         (kc == 32 || kc == 64) && C % kc == 0 && stages >= 3 && stages <= MAX_STAGES &&
         SmemBf16(C, WPB, kc, stages).bytes == static_cast<size_t>(smem_bytes);
}

template <int C, int WPB>
cudaError_t run_qkv_bf16(const Params& p, int windows, int smem_bytes, cudaStream_t st) {
  if (!qkv_plan_ok<C, WPB>(p.heads, p.hsplit, p.kc, p.stages, smem_bytes))
    return cudaErrorInvalidValue;
  CUtensorMap tm_q;
  if (!weight_map(&tm_q, p.wqkv, true, C, p.kc, 0)) return cudaErrorNotSupported;
  cudaError_t err = cudaFuncSetAttribute(attn_qkv_bf16_kernel<C, WPB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  const int blocks = (windows + WPB - 1) / WPB * p.hsplit;
  attn_qkv_bf16_kernel<C, WPB><<<blocks, RING_THREADS, smem_bytes, st>>>(p, tm_q);
  return cudaGetLastError();
}

// wpb 2 at C = 1024 is never planned: two [49, C] tiles and the rest do not
// fit in a block's shared memory
template <int C>
cudaError_t run_qkv_width(const Params& p, int windows, int wpb, int smem_bytes,
                          cudaStream_t st) {
  if (wpb == 1) return run_qkv_bf16<C, 1>(p, windows, smem_bytes, st);
  if constexpr (C < 1024) {
    if (wpb == 2) return run_qkv_bf16<C, 2>(p, windows, smem_bytes, st);
  }
  return cudaErrorInvalidValue;
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

// K6.  dtype: 0 = float32 (the plan is not read), 1 = bfloat16 with the
// launch plan of ops/window_attention.py: qkv_plan (wpb windows a block,
// 1 or 2; the heads split over hsplit blocks, 1, 2 or 4; ring chunk kc of
// 32 or 64 channels; 3 to 5 ring slots; smem_bytes its shared memory,
// which must equal SmemBf16's sum: cudaErrorInvalidValue otherwise).
// Launches on `stream`; returns the launch's error.
extern "C" int window_attn_qkv_fwd(const void* x, const void* wqkv, const void* bqkv,
                                   const void* bias, const void* mask, void* out, int B,
                                   int Hp, int Wp, int C, int heads, int dtype, int wpb,
                                   int hsplit, int kc, int stages, int smem_bytes,
                                   void* stream) {
  Params p{x, nullptr, nullptr, wqkv, static_cast<const float*>(bqkv),
           static_cast<const float*>(bias), static_cast<const float*>(mask), out,
           B, Hp, Wp, C, heads, hsplit, kc, stages};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int windows = B * (Hp / WIN) * (Wp / WIN);
  if (dtype == 1) {
    cudaError_t err;
    switch (C) {
      case 96: err = run_qkv_width<96>(p, windows, wpb, smem_bytes, st); break;
      case 128: err = run_qkv_width<128>(p, windows, wpb, smem_bytes, st); break;
      case 192: err = run_qkv_width<192>(p, windows, wpb, smem_bytes, st); break;
      case 256: err = run_qkv_width<256>(p, windows, wpb, smem_bytes, st); break;
      case 384: err = run_qkv_width<384>(p, windows, wpb, smem_bytes, st); break;
      case 512: err = run_qkv_width<512>(p, windows, wpb, smem_bytes, st); break;
      case 768: err = run_qkv_width<768>(p, windows, wpb, smem_bytes, st); break;
      case 1024: err = run_qkv_width<1024>(p, windows, wpb, smem_bytes, st); break;
      default: err = cudaErrorInvalidValue;
    }
    return static_cast<int>(err);
  }
  attn_qkv_f32_kernel<<<windows, THREADS, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// K7.  dtype as above.
extern "C" int window_attn_fwd(const void* q, const void* k, const void* v, const void* bias,
                               const void* mask, void* out, int B, int Hp, int Wp, int C,
                               int heads, int dtype, void* stream) {
  Params p{q, k, v, nullptr, nullptr, static_cast<const float*>(bias),
           static_cast<const float*>(mask), out, B, Hp, Wp, C, heads, 0, 0, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = B * (Hp / WIN) * (Wp / WIN);
  if (dtype == 1) {
    attn_bf16_kernel<<<blocks, THREADS, 0, st>>>(p);
  } else {
    attn_f32_kernel<<<blocks, THREADS, 0, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
