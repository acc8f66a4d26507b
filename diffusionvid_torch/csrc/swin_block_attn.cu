// Fused Swin attention half-block (kernel K4).
//
// Replaces: diffusionvid_tpu/ops/swin_attention_pallas.py: fused_swin_block_attn
//   (the Pallas kernels _kernel_block_attn / _kernel_block_attn_masked).
//
// Contract, per w x w window (w = 7 or 12) of the (pre-rolled,
// window-padded) map x [B, Hp, Wp, C], C = 32 * heads, in the compute
// dtype T:
//   y   = LN1(x) in fp32 (eps, two-pass variance), times the 0/1 pad mask
//         ((row + shift) % Hp < hv) & ((col + shift) % Wp < wv), rounded to T
//   qkv = y @ wqkv^T + bqkv             fp32 sum, fp32 bias, rounded
//   s   = round(q k^T * 32^-0.5) + bias[head] (+ mask[window])   fp32
//   p   = softmax(s) in fp32 (max, exp, divide), rounded
//   o   = p v                            fp32 sum, rounded
//   out = x + round(o @ wproj^T + bproj) in T
// bias [heads, w^2, w^2] and mask [Hp/w, Wp/w, w^2, w^2] (0 or -100) are fp32;
// the LayerNorm weights and the biases are fp32.  These are the rounding
// points of the Pallas kernel; the pad region of x keeps its values.
//
// What bounds it on an H100: operations.  For Swin-B at 608x1024 over 4
//   frames (maps [4,154,259,128], [4,77,133,256], [4,42,70,512],
//   [4,21,35,1024]) the products are about 613 GFLOP per backbone pass
//   (24 launches), 0.62 ms at the bf16 tensor-core rate; a stage-2 launch
//   is 25.9 GFLOP (26 us) against 27 MB of traffic (8 us).  At stage 0 the
//   bytes (82 MB, 24 us) are as large as the operations (25 us).  What
//   the kernel moves besides: every window's products need all 4C^2
//   weights, from L2, so the weights' L2 traffic per launch is windows x
//   8C^2 bytes (427-503 MB at the four stages) unless a block shares them.
//   Swin-L-22k-384 (window 12) at the same frames: maps [4,156,264,192],
//   [4,84,132,384], [4,48,72,768], [4,24,36,1536], 8 M C^2 + 4 M 144 C
//   FLOP, about 1.68 TFLOP per backbone pass (24 launches), 1.70 ms.
//
// What held the first bf16 design back (one block of 8 warps a window),
//   numbered as the parts below that answer it: (1) every weight fragment
//   came from L2 four bytes at a time, nothing in flight; (2) warps idle:
//   6 of 8 in the projection, 4 in the attention, two block barriers a
//   head; (3) each window's 49 rows padded to 64 in both products; (4) the
//   bias and mask gathered from L2 per head; (5) too few blocks: 60 on 132
//   SMs at Swin-B's stage 3, one block an SM from C = 512 on.
//
// Design (bf16, window 7 and C <= 1024: Swin-T/S/B, L-22k's stages 0-2).
//   A block is two consumer warpgroups and one producer warp
//   (288 threads); its plan comes from ops/swin_attention.py: attn_plan,
//   which mirrors SmemBf16 below.
//   - The modes (5).  C <= 512, pair mode: a block takes two windows,
//     warpgroup g window 2b + g, and walks all heads; both warpgroups
//     multiply their own LN tile by the same weight tile, so each weight
//     byte read from L2 serves two windows (half the L2 traffic), and
//     stage 2's 240 windows are 120 blocks, one wave.  C >= 768, split
//     mode (two LN tiles would not fit): a cluster of 2 blocks takes one
//     window, block r heads [r h/2, (r+1) h/2) and out-projection columns
//     [r C/2, (r+1) C/2), and warpgroup g the even or the odd heads and
//     half of each out-projection pass: stage 3's 60 windows are 120 blocks.
//   - The ring (1).  The weights stream through `stages` (3-5) slots of shared
//     memory, filled by TMA: the producer warp's lane 0 copies a round's rows
//     (per head one 4D box, its q, k and v rows of kc channels; later a 2D box
//     of an out-projection pass's wproj rows) with the 128-byte (kc 64) or
//     64-byte (kc 32) swizzle, completing on the slot's full mbarrier, as soon
//     as the 8 consumer warps have released the slot (its empty mbarrier).
//     The ring walks one sequence of chunks, so the next head's first chunks
//     land while this head's attention runs, and the first wproj chunks during
//     the last head's.
//   - The products (2).  Both are wgmma m64nNk16 on each warpgroup, all 8
//     warps: A (the warpgroup's 64 padded rows; rows past 48 read row 48) from
//     registers through ldmatrix, B from the slot by a swizzled descriptor,
//     fp32 accumulators; N = 96 for a head's q | k | v, 64 or 96 per
//     out-projection pass.  From C = 192 on a chunk's products stay in flight
//     while the next chunk's are issued. No block-wide barrier per chunk: the
//     full/empty mbarriers order the ring.
//   - The attention (2).  Each warpgroup runs its head's attention on its 4
//     warps: warp l holds query rows 16l .. 16l + 15 against all 64 keys (keys
//     past 48 get -inf), scores and softmax in registers; q goes from the
//     projection's accumulators straight into the score product's A fragments
//     (a warp's attention rows are its own projection rows), and the
//     probabilities serve as A fragments of P.V.  p = e / sum is the
//     reciprocal's product plus one Newton step (the correctly rounded
//     quotient of normal values, without the division routine's slow path that
//     the masked scores' tiny e took).
//   - Bias and mask (4).  The window's mask [49, 49] is copied into shared
//     memory once and serves every head; the producer copies each round's fp32
//     bias [49, 49] into one of two buffers while the round before runs (a
//     bias mbarrier pair per buffer).
//   - Each head's o [49 x 32] goes to a bf16 scratch map [windows, 49, C]
//     in device memory (L2).  After the last head the consumers of the
//     block (of the cluster, in split mode) sync and read their windows'
//     whole o rows into the LN tiles, dead by then, for the
//     out-projection; bias and residual are added in the epilogue.
//   (3) stays: a warpgroup's wgmma tile is 64 rows, one window.
//   Shared memory: the ring stages x 192 spl kc bytes (spl = 2 in split
//   mode, else 1), then the LN tiles wpb x 98 (C + 8) bytes, k and v^T
//   2 x 9,728, masks wpb x 9,616, two biases 19,232, 256 of barriers:
//   115,552 B at C = 128 (two blocks an SM; kc 32, 5 stages), 221,536 B at
//   C = 512 (kc 64, 5 stages), 223,424 B at C = 1024 (kc 64, 3 stages).
//   ptxas (sm_90a, 288 threads): 168 registers at C = 1024, 166 at 768,
//   142-163 at 192-512, no spill; at C = 96 and 128, two blocks an SM hold
//   96 registers a thread (18 warps, five on one SM quarter), which spills
//   340 and 44 bytes.
//   The numbers' source: chip_smoke.py (the K4 rows and the ptxas phase).
//   The ring, its producer and prologue, the products and the attention
//   live in swin_hopper.cuh, shared with K6 (window_attn_qkv.cu).
//
// Design (bf16, staged: window 12 at every width, and C = 1536 at window
//   7), which the design above cannot take: at window 12 a window's LN
//   tile [144, C + 8] is 57-444 KB at C = 192-1536, a head's fp32 bias
//   [144, 144] 82,944 B, and a window is three wgmma M-tiles; at C = 1536
//   and window 7 the sum is 236,736 B with the smallest ring.  attn_plan
//   takes it where the sum above does not fit a block.  Four launches on
//   the caller's stream, each stored map a rounding point of the contract:
//   1. attn_ln_kernel: y = round(LN1(x)), zero in the padding (rolled
//      coordinates), into a bf16 map [M, C], M = B Hp Wp, in map order;
//   2. attn_gemm_kernel<BN, QKV>: qkv = round(y wqkv^T + bqkv) [M, 3C];
//   3. attn_win_kernel<w>: swin_hopper.cuh's window_core, which K6's and
//      K7's staged designs run too: a block a (window, head), its q, k, v
//      rows gathered into shared memory, the attention core of the design
//      above (attend_head<w>, mma.sync in registers, query rows 16 a warp,
//      all keys; at window 12 nine warps, 72 score registers a thread),
//      the bias and the mask read from device memory (L2) instead of
//      staged, o into the map of step 1, whose y the product has read;
//   4. attn_gemm_kernel<BN, FC2>: out = x + round(o wproj^T + bproj).
//   The products are K5's TMA-fed wgmma product (swin_gemm.cuh), with its
//   plan (ops/swin_attention.py: mlp_gemm_plans).  Every token's row is in
//   one window, so the LN, the products and the residual are per token in
//   map order; only step 3 needs the windows.  What it costs over the
//   design above: y, qkv and o written and read, x read twice, 22 C bytes
//   a token more (at Swin-L's stage 0, 696 MB, 208 us at 3.35 TB/s).
//   Known limit: each (window, head) block reads its head's bias and, when
//   shifted, its window's mask from L2 (82,944 B each at window 12), and
//   attn_win_kernel is about half of the design's time at Swin-L's maps.
//   ptxas (sm_90a): attn_win_kernel<12> 102 registers, 34,816 B static
//   shared, <7> 63; attn_ln_kernel 40-106 registers (106 at C = 1536; 6
//   bytes spilled at C = 384); attn_gemm_kernel 58-168, no spill; the fp32
//   kernel 79-80.  Source: chip_smoke.py (the ptxas phase, the K4 rows).
//
// Design (fp32, for the checks): the same phases on the CUDA cores, one
//   block per window; the LN'd tile and the head outputs live in a device
//   scratch buffer [2, windows, w^2, C] that the wrapper allocates (an fp32
//   [49 x C] tile at C = 1024 takes 200 KB), q/k/v and the scores in shared
//   memory (29,204 B at window 7, 140,544 B at 12).  Each dot product over C
//   is one warp with coalesced loads and a shuffle sum.

#include <cooperative_groups.h>

#include "swin_hopper.cuh"
#include "swin_gemm.cuh"

namespace {

using namespace swin;
namespace cg = cooperative_groups;

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
  void* scratch;      // fp32: LN'd tiles and outputs; bf16: the o map
  int B, Hp, Wp, C, heads, hv, wv, shift;
  float eps;
  int kc, stages;     // bf16 path: the ring of the launch plan
};

// LN1 and the pad mask over the W x W window's tokens -> y [W^2, ld] in
// T; one warp per token, lane owns channels lane + 32k (C <= 32 MAXK)
constexpr int MAXK = 48;
template <typename T, int W>
__device__ void ln_window(const Params& p, const WindowOf<W>& w, T* y, int ld) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int C = p.C, nk = C / 32;
  const T* x = static_cast<const T*>(p.x);
  for (int i = warp; i < W * W; i += WARPS) {
    const T* src = x + w.offset(p.Hp, p.Wp, C, i);
    float v[MAXK], s = 0.f;
#pragma unroll
    for (int k = 0; k < MAXK; ++k)
      if (k < nk) { v[k] = to_f(src[lane + 32 * k]); s += v[k]; }
    const float mu = warp_sum(s) / C;
    float q = 0.f;
#pragma unroll
    for (int k = 0; k < MAXK; ++k)
      if (k < nk) { v[k] -= mu; q += v[k] * v[k]; }
    const float inv = 1.f / sqrtf(warp_sum(q) / C + p.eps);
    const int row = w.wr * W + i / W, col = w.wc * W + i % W;
    const float keep = ((row + p.shift) % p.Hp < p.hv && (col + p.shift) % p.Wp < p.wv)
                           ? 1.f : 0.f;
#pragma unroll
    for (int k = 0; k < MAXK; ++k)
      if (k < nk) {
        const int c = lane + 32 * k;
        y[i * ld + c] = from_f<T>((v[k] * inv * p.ln_g[c] + p.ln_b[c]) * keep);
      }
  }
}

// ------------------------------------------------------------------ bf16

// The launch mode of width C: windows a block (pair mode 2, split mode 1),
// blocks a cluster, and the out-projection's columns a warpgroup takes
// per pass (each pass covers NO * spl columns of the block's own).
template <int C>
struct Mode {
  static constexpr int WPB = C <= 512 ? 2 : 1;
  static constexpr int SPL = 3 - WPB;  // split: the warpgroups take different heads
  static constexpr int CL = WPB == 2 ? 1 : 2;
  static constexpr int OWN = C / CL;   // the block's heads' channels
  static constexpr int ROUNDS = OWN / DH / SPL;
  static constexpr int NO = OWN % (96 * SPL) == 0 ? 96 : 64;
  static constexpr int PASSES = OWN / (NO * SPL);
  static_assert(OWN % (NO * SPL) == 0 && (OWN / DH) % SPL == 0, "K4 mode");
};

// LN1 and the pad mask in place over the block's `rows` tokens (tiles of
// windows win0 and win0 + 1 [49 x lda], already in shared memory): a warp
// takes two rows at a time, so that their reduction chains overlap; lane
// owns channels lane + 32k.  An odd last row is done twice.  1 / sqrt is
// rsqrtf, as the plain version's torch.rsqrt.
template <int C>
__device__ __forceinline__ void ln_tiles(const Params& p, int win0, int windows, int rows,
                                         bf16* a0, int lda) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int NK = C / 32;
  const WindowAt w0(min(win0, windows - 1), p.Hp, p.Wp), w1(min(win0 + 1, windows - 1), p.Hp, p.Wp);
  for (int i0 = 2 * warp; i0 < rows; i0 += 2 * WARPS) {
    bf16* y[2];
    float v[2][NK], s[2] = {0.f, 0.f}, q[2] = {0.f, 0.f}, inv[2], keep[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = min(i0 + u, rows - 1), t = i / N, tok = i - t * N;
      y[u] = a0 + i * lda;
      // the token's place in the rolled map, rolled back (shift < 7 <= Hp, Wp)
      int row = (t ? w1.wr : w0.wr) * WIN + tok / WIN + p.shift;
      int col = (t ? w1.wc : w0.wc) * WIN + tok % WIN + p.shift;
      if (row >= p.Hp) row -= p.Hp;
      if (col >= p.Wp) col -= p.Wp;
      keep[u] = row < p.hv && col < p.wv ? 1.f : 0.f;
#pragma unroll
      for (int k = 0; k < NK; ++k) { v[u][k] = to_f(y[u][lane + 32 * k]); s[u] += v[u][k]; }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s[0] += __shfl_xor_sync(0xffffffffu, s[0], o);
      s[1] += __shfl_xor_sync(0xffffffffu, s[1], o);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float mu = s[u] * (1.f / C);
#pragma unroll
      for (int k = 0; k < NK; ++k) { v[u][k] -= mu; q[u] += v[u][k] * v[u][k]; }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      q[0] += __shfl_xor_sync(0xffffffffu, q[0], o);
      q[1] += __shfl_xor_sync(0xffffffffu, q[1], o);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) inv[u] = rsqrtf(q[u] * (1.f / C) + p.eps);
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      const int c = lane + 32 * k;
      const float g = __ldg(p.ln_g + c), b = __ldg(p.ln_b + c);
#pragma unroll
      for (int u = 0; u < 2; ++u)
        y[u][c] = __float2bfloat16_rn((v[u][k] * inv[u] * g + b) * keep[u]);
    }
  }
}

// the residual x (bf16 pairs) of the warpgroup's NC columns at column c0
// of its window's rows (rows past 48: not loaded)
template <int NC>
__device__ __forceinline__ void load_res(const Params& p, const WindowAt& w, int c0,
                                         uint32_t (&res)[NC / 8][2]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const bf16* x = static_cast<const bf16*>(p.x);
#pragma unroll
  for (int n = 0; n < NC / 8; ++n)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 16 * (warp & 3) + g + 8 * hh;
      res[n][hh] = r < N ? ldg32(x + w.offset(p.Hp, p.Wp, p.C, r) + c0 + 8 * n + 2 * t) : 0u;
    }
}

// out = x + round(acc + bproj) for the warpgroup's NC columns at column
// c0; res the residual (load_res), bp bproj
template <int NC>
__device__ __forceinline__ void store_out(const Params& p, const WindowAt& w,
                                          const float (&acc)[NC / 2],
                                          const uint32_t (&res)[NC / 8][2], const float* bp,
                                          int c0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  bf16* out = static_cast<bf16*>(p.out);
#pragma unroll
  for (int n = 0; n < NC / 8; ++n) {
    const int c = c0 + 8 * n + 2 * t;
    const float bias0 = __ldg(bp + c), bias1 = __ldg(bp + c + 1);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 16 * (warp & 3) + g + 8 * hh;
      if (r >= N) continue;
      const uint32_t xr = res[n][hh];
      const float2 x2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr));
      st2(out + w.offset(p.Hp, p.Wp, p.C, r) + c, x2.x + round_bf16(acc[4 * n + 2 * hh] + bias0),
          x2.y + round_bf16(acc[4 * n + 2 * hh + 1] + bias1));
    }
  }
}

template <int C>
__global__ void __launch_bounds__(RING_THREADS, C <= 128 ? 2 : 1)
attn_bf16_kernel(Params p, const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_o) {
  using M = Mode<C>;
  constexpr int WPB = M::WPB, SPL = M::SPL, CL = M::CL, OWN = M::OWN, NO = M::NO;
  constexpr int NB = 2 / SPL;  // attention bias buffers, SPL heads each
  extern __shared__ __align__(1024) unsigned char smem[];
  const int stages = p.stages, kc = p.kc, nk = C / kc;
  const SmemBf16 L(C, WPB, kc, stages);
  const int lda = L.lda;
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const bool producer = tid >= THREADS;
  const int rank = CL > 1 ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const int windows = p.B * (p.Hp / WIN) * (p.Wp / WIN);
  const int win0 = (blockIdx.x / CL) * WPB;
  bf16* s_ring = reinterpret_cast<bf16*>(smem + L.ring);
  bf16* s_a0 = reinterpret_cast<bf16*>(smem + L.a);
  float* s_mask0 = reinterpret_cast<float*>(smem + L.mask);
  float* s_bias = reinterpret_cast<float*>(smem + L.bias);
  Bars* bars = reinterpret_cast<Bars*>(smem + L.bars);
  const int head0 = rank * (OWN / DH), col0 = rank * OWN;
  const int slot_elems = static_cast<int>(L.slot / sizeof(bf16));

  // prologue: the barriers; the windows' tiles of x and their masks
  ring_prologue<C, WPB>(smem, bars, stages, static_cast<const bf16*>(p.x), p.mask, p.Hp, p.Wp,
                        win0, windows, s_a0, lda, s_mask0);

  if (producer) {
    ring_producer<SPL, CL, NO>(bars, s_ring, static_cast<int>(L.slot), s_bias, p.bias, &tm_q,
                               &tm_o, head0, col0, M::ROUNDS, M::PASSES, kc, nk, stages);
    return;
  }

  // the consumers: this warpgroup's window (pair mode: the second may not
  // exist, then it repeats the first and stores nothing), tiles and head
  const int my_idx = win0 + (WPB == 2 ? wg : 0);
  const bool mine = my_idx < windows;
  const WindowAt w(min(my_idx, windows - 1), p.Hp, p.Wp);
  const int tile = WPB == 2 ? wg : 0, half = SPL == 2 ? wg : 0;
  bf16* s_a = s_a0 + tile * N * lda;
  bf16* s_k = reinterpret_cast<bf16*>(smem + L.kv + wg * KV_BYTES);
  bf16* s_vt = s_k + 64 * LDQ;
  ln_tiles<C>(p, win0, windows, WPB * N, s_a0, lda);
  consumers_sync();

  // the ring's chunks in order: take() waits until the next has landed,
  // release() tells the producer (one arrival a warp) that this warp's
  // products have read the oldest chunk taken
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

  bf16* o_map = static_cast<bf16*>(p.scratch);
  bf16* o_win = o_map + static_cast<size_t>(min(my_idx, windows - 1)) * N * C;
  for (int j = 0; j < M::ROUNDS; ++j) {
    float acc[48];  // the warpgroup's head: q | k | v [64 x 96]
    zero(acc);
    products<96, ASYNC>(acc, s_a, lda, kc, nk, 96 * half, take, release);
    const int hl = j * SPL + half, b = j % NB;  // the block's local head, its bias buffer
    uint32_t qa[2][4];
    wg_sync(wg);  // the warpgroup's last attention has read k, v
    split_qkv(acc, p.bqkv + col0, C, hl, qa, s_k, s_vt);
    wg_sync(wg);
    mbar_wait(&bars->bias_full[b], (j / NB) & 1);
    bf16* o = o_win + (head0 + hl) * DH;
    attend_head_wg(qa, s_k, s_vt, s_bias + (b * SPL + half) * NN_FLOATS,
                   p.mask ? s_mask0 + tile * NN_FLOATS : nullptr,
                   [o](int r) { return o + r * C; }, mine);
    __syncwarp();
    if (lane == 0) mbar_arrive(&bars->bias_empty[b]);
  }
  // every head's o of the block's windows is in the o map: read the whole
  // rows back into the LN tiles (dead by then), past L1
  __threadfence();
  if constexpr (CL > 1) {
    asm volatile("barrier.cluster.arrive.release.aligned;\n"
                 "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  } else {
    consumers_sync();
  }
  for (int i = tid; i < WPB * N * (C / 8); i += THREADS) {
    const int t = i / (N * (C / 8)), r = (i / (C / 8)) % N, piece = i % (C / 8);
    const uint4* src = reinterpret_cast<const uint4*>(
        o_map + (static_cast<size_t>(min(win0 + t, windows - 1)) * N + r) * C + 8 * piece);
    *reinterpret_cast<uint4*>(s_a0 + (t * N + r) * lda + 8 * piece) = __ldcg(src);
  }
  consumers_sync();
  for (int pass = 0; pass < M::PASSES; ++pass) {
    const int c0 = col0 + (pass * SPL + half) * NO;  // the warpgroup's columns
    uint32_t res[NO / 8][2];
    if constexpr (ASYNC) load_res<NO>(p, w, c0, res);  // in flight during the products
    float acc[NO / 2];
    zero(acc);
    products<NO, ASYNC>(acc, s_a, lda, kc, nk, NO * half, take, release);
    if constexpr (!ASYNC) load_res<NO>(p, w, c0, res);
    if (mine) store_out<NO>(p, w, acc, res, p.bproj, c0);
  }
}

template <int C>
cudaError_t launch_bf16(const Params& p, int windows, size_t bytes, cudaStream_t st) {
  using M = Mode<C>;
  CUtensorMap tm_q, tm_o;
  if (!weight_map(&tm_q, p.wqkv, true, C, p.kc, 0) ||
      !weight_map(&tm_o, p.wproj, false, C, p.kc, M::NO * M::SPL))
    return cudaErrorNotSupported;
  cudaError_t err = cudaFuncSetAttribute(
      attn_bf16_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = M::CL;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((windows + M::WPB - 1) / M::WPB * M::CL);
  cfg.blockDim = dim3(RING_THREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, attn_bf16_kernel<C>, p, tm_q, tm_o);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The launch plan's checks: the mode of C, the ring and its shared bytes.
template <int C>
bool plan_ok(int wpb, int cluster, int kc, int stages, int smem_bytes) {
  using M = Mode<C>;
  return wpb == M::WPB && cluster == M::CL && (kc == 32 || kc == 64) && C % kc == 0 &&
         stages >= 3 && stages <= MAX_STAGES &&
         SmemBf16(C, wpb, kc, stages).bytes == static_cast<size_t>(smem_bytes);
}

template <int C>
cudaError_t run_bf16(const Params& p, int windows, int wpb, int cluster, int smem_bytes,
                     cudaStream_t st) {
  if (!plan_ok<C>(wpb, cluster, p.kc, p.stages, smem_bytes)) return cudaErrorInvalidValue;
  return launch_bf16<C>(p, windows, smem_bytes, st);
}

// ------------------------------------------------------------------ fp32

template <int W>
__global__ void __launch_bounds__(THREADS)
attn_f32_kernel(Params p) {
  constexpr int NN = W * W;
  extern __shared__ __align__(16) float s_f32[];
  float* s_q = s_f32;
  float* s_k = s_q + NN * FLD;
  float* s_v = s_k + NN * FLD;
  float* s_s = s_v + NN * FLD;
  const int C = p.C;
  const int nwin = p.B * (p.Hp / W) * (p.Wp / W);
  const WindowOf<W> w(blockIdx.x, p.Hp, p.Wp);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* wqkv = static_cast<const float*>(p.wqkv);
  const float* wproj = static_cast<const float*>(p.wproj);
  float* scratch = static_cast<float*>(p.scratch);
  float* xn = scratch + static_cast<size_t>(blockIdx.x) * NN * C;
  float* o = scratch + static_cast<size_t>(nwin + blockIdx.x) * NN * C;

  ln_window<float, W>(p, w, xn, C);
  __syncthreads();  // also orders the block's device-memory writes

  for (int j = 0; j < p.heads; ++j) {
    project_head_f32<W>([&](int r) { return xn + r * C; }, wqkv, p.bqkv, C, j, s_q, s_k, s_v);
    attend_head_f32<W>(s_q, s_k, s_v, s_s, p.bias + static_cast<size_t>(j) * NN * NN,
                       p.mask ? p.mask + static_cast<size_t>(w.wmap) * NN * NN : nullptr,
                       [&](int r, int d, float v) { o[r * C + j * DH + d] = v; });
  }

  const float* x = static_cast<const float*>(p.x);
  float* out = static_cast<float*>(p.out);
  for (int e = warp; e < NN * C; e += WARPS) {
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

template <int W>
cudaError_t launch_f32(const Params& p, cudaStream_t st) {
  constexpr int bytes = f32_smem(W);
  cudaError_t err = cudaFuncSetAttribute(attn_f32_kernel<W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  attn_f32_kernel<W><<<p.B * (p.Hp / W) * (p.Wp / W), THREADS, bytes, st>>>(p);
  return cudaGetLastError();
}

// ------------------------------------------------------------ bf16, staged

// LN1 and the pad mask: y[m] = round(LN1(x[m])), or 0 where token m, rolled
// back by the shift, lies in the window padding (swin::ln_rows_pass)
template <int C>
__global__ void __launch_bounds__(THREADS)
attn_ln_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_g,
               const float* __restrict__ ln_b, bf16* __restrict__ y, int M, int Hp, int Wp,
               int hv, int wv, int shift, float eps) {
  ln_rows_pass<C>(x, ln_g, ln_b, y, M, eps, [=](int m) {
    const int q = m % (Hp * Wp), row = q / Wp, col = q % Wp;
    return (row + shift) % Hp < hv && (col + shift) % Wp < wv;
  });
}

// the products (swin::gemm_tile): QKV for qkv = round(y wqkv^T + bqkv), FC2
// for out = x + round(o wproj^T + bproj)
template <int BN, int EPI>
__global__ void __launch_bounds__(RING_THREADS, BN <= 128 ? 2 : 1)
attn_gemm_kernel(const __grid_constant__ CUtensorMap tm_a,
                 const __grid_constant__ CUtensorMap tm_w, const float* __restrict__ bias,
                 const bf16* __restrict__ res, const bf16* __restrict__ gelu_tbl,
                 bf16* __restrict__ out, int M, int N, int K, int stages) {
  gemm_tile<BN, EPI>(&tm_a, &tm_w, bias, res, gelu_tbl, out, M, N, K, stages);
}

// The window attention (swin_hopper.cuh: window_core) over the qkv map
// [M, 3C]: q, k and v are its column blocks, row stride 3C.
template <int W>
__global__ void __launch_bounds__(WIN_THREADS<W>)
attn_win_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, int ld, const float* __restrict__ bias,
                const float* __restrict__ mask, bf16* __restrict__ o, int Hp, int Wp, int C) {
  window_core<W>(q, k, v, ld, bias, mask, o, Hp, Wp, C);
}

template <int C>
cudaError_t launch_ln(const void* x, const void* g, const void* b, void* y, int M, int Hp,
                      int Wp, int hv, int wv, int shift, float eps, cudaStream_t st) {
  attn_ln_kernel<C><<<(M + LN_ROWS - 1) / LN_ROWS, THREADS, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(g), static_cast<const float*>(b),
      static_cast<bf16*>(y), M, Hp, Wp, hv, wv, shift, eps);
  return cudaGetLastError();
}

template <int EPI>
cudaError_t launch_gemm(const void* a, const void* w, const void* bias, const void* res,
                        void* out, int M, int N, int K, int bn, int stages, int smem_bytes,
                        cudaStream_t st) {
  auto kernel = bn == 256 ? attn_gemm_kernel<256, EPI>
                : bn == 128 ? attn_gemm_kernel<128, EPI> : attn_gemm_kernel<64, EPI>;
  return launch_gemm_kernel(kernel, a, w, static_cast<const float*>(bias),
                            static_cast<const bf16*>(res), nullptr, static_cast<bf16*>(out), M,
                            N, K, bn, smem_bytes, stages, st);
}

template <int W>
cudaError_t launch_win(const void* qkv, const void* bias, const void* mask, void* o, int B,
                       int Hp, int Wp, int C, int heads, cudaStream_t st) {
  const bf16* m = static_cast<const bf16*>(qkv);
  return launch_window_core<W>(attn_win_kernel<W>, m, m + C, m + 2 * C, 3 * C, bias, mask, o,
                               B, Hp, Wp, C, heads, st);
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32 at window 7 or 12 (scratch: 2 * windows * window^2 * C
// floats, C <= 1536; the plan is not read), 1 = bfloat16 at window 7, C <=
// 1024 (scratch: the o map, windows * 49 * C bf16) with the launch plan of
// ops/swin_attention.py: attn_plan (wpb windows a block and cluster blocks
// a window, which must be C's mode; ring chunk kc of 32 or 64 channels; 3
// to 5 ring slots; smem_bytes its shared memory, which must equal
// SmemBf16's sum: cudaErrorInvalidValue otherwise).  Launches on `stream`;
// returns the launch's error.
extern "C" int swin_block_attn_fwd(const void* x, const void* ln_g, const void* ln_b,
                                   const void* wqkv, const void* bqkv, const void* bias,
                                   const void* mask, const void* wproj, const void* bproj,
                                   void* out, void* scratch, int B, int Hp, int Wp, int C,
                                   int heads, int hv, int wv, int shift, int window, float eps,
                                   int dtype, int wpb, int cluster, int kc, int stages,
                                   int smem_bytes, void* stream) {
  Params p{x, static_cast<const float*>(ln_g), static_cast<const float*>(ln_b), wqkv,
           static_cast<const float*>(bqkv), static_cast<const float*>(bias),
           static_cast<const float*>(mask), wproj, static_cast<const float*>(bproj), out,
           scratch, B, Hp, Wp, C, heads, hv, wv, shift, eps, kc, stages};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (window != WIN) return static_cast<int>(cudaErrorInvalidValue);
    const int windows = B * (Hp / WIN) * (Wp / WIN);
    cudaError_t err;
    switch (C) {
      case 96: err = run_bf16<96>(p, windows, wpb, cluster, smem_bytes, st); break;
      case 128: err = run_bf16<128>(p, windows, wpb, cluster, smem_bytes, st); break;
      case 192: err = run_bf16<192>(p, windows, wpb, cluster, smem_bytes, st); break;
      case 256: err = run_bf16<256>(p, windows, wpb, cluster, smem_bytes, st); break;
      case 384: err = run_bf16<384>(p, windows, wpb, cluster, smem_bytes, st); break;
      case 512: err = run_bf16<512>(p, windows, wpb, cluster, smem_bytes, st); break;
      case 768: err = run_bf16<768>(p, windows, wpb, cluster, smem_bytes, st); break;
      case 1024: err = run_bf16<1024>(p, windows, wpb, cluster, smem_bytes, st); break;
      default: err = cudaErrorInvalidValue;
    }
    return static_cast<int>(err);
  }
  if (C % DH || C > 32 * MAXK) return static_cast<int>(cudaErrorInvalidValue);
  if (window == 12) return static_cast<int>(launch_f32<12>(p, st));
  if (window == WIN) return static_cast<int>(launch_f32<WIN>(p, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The staged bf16 design, at window 7 or 12 and C = 32 heads, a multiple of
// 64 up to 1536: y [M, C] (the LN map, then the o map) and qkv [M, 3C],
// M = B Hp Wp, are bf16 scratch; (bn1, stages1, smem1) and (bn2, stages2,
// smem2) are the plans of the qkv and out-projection products
// (ops/swin_attention.py: attn_plan), checked against the layout
// (cudaErrorInvalidValue otherwise).  Four launches on `stream`; returns
// the first error.
extern "C" int swin_block_attn_staged(const void* x, const void* ln_g, const void* ln_b,
                                      const void* wqkv, const void* bqkv, const void* bias,
                                      const void* mask, const void* wproj, const void* bproj,
                                      void* out, void* y, void* qkv, int B, int Hp, int Wp,
                                      int C, int heads, int hv, int wv, int shift, int window,
                                      float eps, int bn1, int stages1, int smem1, int bn2,
                                      int stages2, int smem2, void* stream) {
  if (C != heads * DH || (window != WIN && window != 12) || Hp % window || Wp % window ||
      !gemm_plan_ok<QKV>(3 * C, C, bn1, stages1, smem1) ||
      !gemm_plan_ok<FC2>(C, C, bn2, stages2, smem2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * Hp * Wp;
  cudaError_t err;
  switch (C) {
    case 64: err = launch_ln<64>(x, ln_g, ln_b, y, M, Hp, Wp, hv, wv, shift, eps, st); break;
    case 128: err = launch_ln<128>(x, ln_g, ln_b, y, M, Hp, Wp, hv, wv, shift, eps, st); break;
    case 192: err = launch_ln<192>(x, ln_g, ln_b, y, M, Hp, Wp, hv, wv, shift, eps, st); break;
    case 256: err = launch_ln<256>(x, ln_g, ln_b, y, M, Hp, Wp, hv, wv, shift, eps, st); break;
    case 384: err = launch_ln<384>(x, ln_g, ln_b, y, M, Hp, Wp, hv, wv, shift, eps, st); break;
    case 512: err = launch_ln<512>(x, ln_g, ln_b, y, M, Hp, Wp, hv, wv, shift, eps, st); break;
    case 768: err = launch_ln<768>(x, ln_g, ln_b, y, M, Hp, Wp, hv, wv, shift, eps, st); break;
    case 1024: err = launch_ln<1024>(x, ln_g, ln_b, y, M, Hp, Wp, hv, wv, shift, eps, st); break;
    case 1536: err = launch_ln<1536>(x, ln_g, ln_b, y, M, Hp, Wp, hv, wv, shift, eps, st); break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_gemm<QKV>(y, wqkv, bqkv, nullptr, qkv, M, 3 * C, C, bn1, stages1, smem1, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the o map overwrites the LN map, which the qkv product has read
  err = window == 12 ? launch_win<12>(qkv, bias, mask, y, B, Hp, Wp, C, heads, st)
                     : launch_win<WIN>(qkv, bias, mask, y, B, Hp, Wp, C, heads, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      launch_gemm<FC2>(y, wproj, bproj, x, out, M, C, C, bn2, stages2, smem2, st));
}
