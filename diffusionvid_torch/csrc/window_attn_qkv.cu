// Swin window attention with the qkv projection inside (kernel K6) and over
// pre-projected q/k/v maps (kernel K7).
//
// Replaces: diffusionvid_tpu/ops/swin_attention_pallas.py:
//   K6 fused_window_attention_qkv (the Pallas kernels _kernel_qkv_nomask /
//      _kernel_qkv_masked), also the forward of
//      fused_window_attention_qkv_trainable;
//   K7 fused_window_attention (the Pallas kernels _kernel / _kernel_masked).
//
// Contract, per w x w window (w = 7 or 12) of a window-padded, pre-rolled
// map [B, Hp, Wp, C], C = 32 * heads, in the compute dtype T:
//   K6: q | k | v = x @ wqkv^T + bqkv      fp32 sum, fp32 bias, rounded to T
//   K7: q, k, v read from three maps in T
//   s = round(q k^T * 32^-0.5) + bias[head] (+ mask[window row, window col])  fp32
//   p = softmax(s) in fp32 (max, exp, divide), rounded
//   o = p v                                 fp32 sum, rounded, stored at the
//                                           window's tokens in map layout
// bias [heads, w^2, w^2] and mask [Hp/w, Wp/w, w^2, w^2] (0 or -100) are
// fp32, bqkv is fp32.  These are the rounding points of the Pallas kernels.
//
// What bounds them on an H100.  K6: operations at the low-res stages, bytes
//   at stage 0.  For Swin-B at 608x1024 over 5 frames (the train step's
//   maps [5,154,259,128], [5,77,133,256], [5,42,70,512], [5,21,35,1024]) a
//   stage-2 launch is 24.6 GFLOP (25 us at the bf16 tensor-core rate)
//   against 31 MB of traffic (9 us); at stage 0 the 102 MB of x and out
//   (30 us) outweigh the 24.6 GFLOP.  K7 does only the attention, 24.5
//   flops per byte of q, k, v and out at window 7: bytes bound at every
//   Swin-B stage.  Swin-L-22k-384 (window 12, maps [5,156,264,192],
//   [5,84,132,384], [5,48,72,768], [5,24,36,1536]): K6 6 M C^2 + 4 M 144 C
//   FLOP, operations at every stage; K7's 4 M 144 C FLOP against 8 M C
//   bytes of q, k, v and out, 72 flops a byte: bytes at every stage.
//
// Design (bf16, window 7, C <= 1024), K6: K4's Hopper kernel
//   (csrc/swin_block_attn.cu, its pieces shared through swin_hopper.cuh)
//   without LN1, the pad mask, the
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
// Design (bf16, window 7, C <= 1024), K7: bytes bound (24.5 flops a byte
//   of q, k, v and out), so the design keeps device memory busy at every
//   stage.
//   - Work: a block takes a head group (`group` heads, dividing the heads)
//     and a run of `wpb` consecutive windows, and walks the run's
//     (window, head) items window by window, heads inner.  Heads write
//     disjoint output columns, so no block needs another's result and no
//     cluster is needed (K6's hsplit argument).  The launch plan
//     (ops/window_attention.py: window_plan) picks group and wpb by SM time
//     on the card's SMs, so that Swin-B's stages 2 and 3 (240 and 60
//     windows of 16 and 32 heads over 4 frames) run about two blocks an SM
//     instead of one block a window.  The group's fp32 biases are copied
//     into shared memory once and serve every window of the run.
//   - The ring: a producer warp streams each item's q, k and v tiles of the
//     head (one TMA box [32 ch, 1 head, 7 cols, 7 rows, 1 map] of a 5D map
//     over [B, Hp, Wp, heads, 32] each, 64-byte swizzle) through `stages`
//     slots with full/empty mbarriers, so that the next items land while
//     this one attends: stages - 2 items, 9.4 KB each, in flight a block.
//   - The attention: the two consumer warpgroups take the even and the odd
//     items, so every warp attends; each runs attend_head of swin_hopper.cuh
//     over SwizzledKV, q's A fragments and k's B fragments by ldmatrix and
//     v's by ldmatrix.trans from the row-major tile (no transpose), the
//     mask through L1 from device memory.
//   - The output: each warp writes its 16 rows of o over its own q rows of
//     the slot, and the producer sends the head's [49 x 32] box to the map
//     by one TMA store before it refills the slot.
//   Shared memory (WinSmem): stages x 10,752 (three 3,584-byte tiles), the
//   group's biases group x 9,616, 256 of barriers; the entry point checks
//   the plan's bytes against it.  Tensor maps are cached by (pointer,
//   shape), so a repeated call encodes none.
//   What holds it at about 45% of its bytes bound on an H100: the
//   consumers' register softmax (instruction rate and latency), not the
//   loads: a deeper ring, larger head groups, 16-byte stores by the
//   consumers in place of the TMA store and a third block an SM did not
//   make it faster.  A masked launch pays 10-20% more, for the mask's
//   loads through L1.
//   The numbers' source: chip_smoke.py (the K7 rows and the ptxas phase)
//   and diffusionvid_torch/utils/k7_bench.py.
//
// Design (bf16, staged: window 12 at every width, and C = 1536 at window
//   7), which the designs above cannot take: a window's [144, C] tile and
//   its fp32 bias [144, 144] (82,944 B) a head, or a [49, 1536] tile beside
//   the ring, exceed a block's shared memory.  K4's staged design
//   (swin_block_attn.cu) without the LN pass and the out-projection:
//   K6 two launches on the caller's stream, the product qkv_gemm_kernel
//   (swin_gemm.cuh: gemm_tile, the QKV epilogue: qkv = round(x wqkv^T +
//   bqkv) into a bf16 scratch map [M, 3C], M = B Hp Wp, its plan
//   ops/swin_attention.py: staged_plan's "qkv") and qkv_win_kernel; K7 one,
//   win_attn_kernel over its three maps.  Both attention kernels are
//   swin_hopper.cuh's window_core, K4's attn_win_kernel: a block a
//   (window, head), its q, k, v rows gathered into shared memory, attend_
//   head<w> in registers, the bias and mask from L2, o into the output map.
//   Every token's row is in one window, so the product runs in map order.
//   What it costs over a fused kernel: K6 writes and reads the qkv map, 12 C
//   bytes a token more (at Swin-L's stage 0 over 5 frames 474 MB, 142 us at
//   3.35 TB/s); each (window, head) block reads its head's bias, and when
//   shifted its window's mask, from L2.
//   The numbers' source: chip_smoke.py (the K6 and K7 rows).
//
// Design (fp32, for the checks): the same phases on the CUDA cores, one
//   block per window, at window 7 or 12; x is read from device memory
//   (each dot product over C is one warp, coalesced, with a shuffle sum),
//   q/k/v and the scores live in dynamic shared memory (f32_smem: 29,204 B
//   at window 7, 140,544 B at 12).

#include <mutex>

#include "swin_gemm.cuh"

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

// ------------------------------------------------------------------ bf16

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

// ------------------------------------------------------------------ K7, bf16

constexpr int TILE7 = 3584;                   // a head's [49 x 32] bf16 tile (3,136
                                              // bytes), 512-byte aligned (the swizzle)
constexpr int TILE7_ELEMS = TILE7 / 2;
constexpr int BOX7 = N * DH * 2;              // the bytes TMA moves a tile
constexpr int SLOT7 = 3 * TILE7;              // q | k | v of one (window, head)
constexpr int MAX_STAGES7 = 8;
constexpr int SMEM_LIMIT7 = 232448;           // a block's shared memory on sm_90

// K7's shared memory (byte offsets): the ring, the head group's biases, the
// mbarriers.  ops/window_attention.py: window_plans computes the same sum.
struct WinSmem {
  size_t ring, bias, bars, bytes;
  __host__ __device__ WinSmem(int group, int stages) {
    ring = 0;
    bias = ring + static_cast<size_t>(stages) * SLOT7;
    bars = bias + static_cast<size_t>(group) * NN_BYTES;
    bytes = bars + 256;
  }
};

// per ring slot: full (the producer's arrival with the slot's TMA bytes)
// and empty (the 4 warps of the warpgroup that attended it, once o is in
// the slot)
struct Bars7 {
  uint64_t full[MAX_STAGES7], empty[MAX_STAGES7];
};
static_assert(sizeof(Bars7) <= 256, "K7 barriers");

struct WinParams {
  const float* bias;
  const float* mask;  // may be null
  int Hp, Wp, heads, windows;
  int group, wpb, stages;  // the launch plan
};

// the 5D box (c0 .. c4) of tensor map tm into shared memory, its bytes
// counted on bar; and from shared memory to device memory
__device__ __forceinline__ void tma_5d(void* dst, const CUtensorMap* tm, int c1, int c2, int c3,
                                       int c4, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(tm)), "r"(0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4), "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void tma_store_5d(const CUtensorMap* tm, const void* src, int c1,
                                             int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5, %6}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(tm)), "r"(smem_u32(src)), "r"(0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4) : "memory");
}

// K7 (the design above): block blockIdx.x takes head group blockIdx.x %
// (heads / group) and window run blockIdx.x / (heads / group); its item i
// is window win0 + i / group, head head0 + i % group.
__global__ void __launch_bounds__(RING_THREADS, 2)
attn_bf16_kernel(WinParams p, const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_o) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int stages = p.stages, group = p.group;
  const WinSmem L(group, stages);
  const int tid = threadIdx.x, lane = tid & 31;
  const int ngroups = p.heads / group;
  const int head0 = (blockIdx.x % ngroups) * group, win0 = (blockIdx.x / ngroups) * p.wpb;
  const int items = min(p.wpb, p.windows - win0) * group;
  bf16* ring = reinterpret_cast<bf16*>(smem + L.ring);
  float* s_bias = reinterpret_cast<float*>(smem + L.bias);
  Bars7* bars = reinterpret_cast<Bars7*>(smem + L.bars);

  // the prologue: the barriers, and the group's biases by cp.async
  if (tid >= THREADS) {
    if (tid == THREADS) {
      if (smem_u32(smem) & 1023) __trap();
      for (int s = 0; s < stages; ++s) {
        mbar_init(&bars->full[s], 1);
        mbar_init(&bars->empty[s], 4);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  } else {
    const float* src = p.bias + static_cast<size_t>(head0) * N * N;
    for (int i = tid; i < group * N * N; i += THREADS)
      cp_async4(s_bias + (i / (N * N)) * NN_FLOATS + i % (N * N), src + i);
    cp_async_commit();
    cp_async_wait_all();
  }
  __syncthreads();

  // the item's box coordinates: (channel 0,) head, column, row, map
  auto box = [&](int i, int& h, int& col, int& row, int& b) {
    const WindowAt w(win0 + i / group, p.Hp, p.Wp);
    h = head0 + i % group;
    col = w.wc * WIN;
    row = w.wr * WIN;
    b = w.b;
  };

  if (tid >= THREADS) {
    // the producer: lane 0 fills slot i % stages with item i once the
    // slot's last item has left by its TMA store
    if (lane != 0) return;
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_q)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_k)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_v)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_o)) : "memory");
    auto store = [&](int i) {  // item i's o, in its slot's q tile
      int h, col, row, b;
      box(i, h, col, row, b);
      mbar_wait(&bars->empty[i % stages], (i / stages) & 1);
      tma_store_5d(&tm_o, ring + (i % stages) * (SLOT7 / 2), h, col, row, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    };
    for (int i = 0; i < items; ++i) {
      if (i >= stages) {
        store(i - stages);
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      }
      int h, col, row, b;
      box(i, h, col, row, b);
      uint64_t* full = &bars->full[i % stages];
      bf16* slot = ring + (i % stages) * (SLOT7 / 2);
      mbar_expect(full, 3 * BOX7);
      tma_5d(slot, &tm_q, h, col, row, b, full);
      tma_5d(slot + TILE7_ELEMS, &tm_k, h, col, row, b, full);
      tma_5d(slot + 2 * TILE7_ELEMS, &tm_v, h, col, row, b, full);
    }
    for (int i = max(items - stages, 0); i < items; ++i) store(i);
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    return;
  }

  // the consumers: warpgroup wg attends items wg, wg + 2, ...
  const int wg = tid >> 7, lw = (tid >> 5) & 3, t = lane & 3;
  for (int i = wg; i < items; i += 2) {
    const int slot = i % stages;
    mbar_wait(&bars->full[slot], (i / stages) & 1);
    bf16* s_q = ring + slot * (SLOT7 / 2);
    const WindowAt w(win0 + i / group, p.Hp, p.Wp);
    // q's A fragments of this warp's rows 16 lw .. + 15 (past 48: row 48)
    uint32_t qa[2][4];
    {
      const int r = min(16 * lw + (lane & 7) + 8 * ((lane >> 3) & 1), N - 1);
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) ldsm_x4(qa[ks], s_q + swz64(r, 2 * ks + (lane >> 4)));
    }
    attend_head(qa, SwizzledKV{s_q + TILE7_ELEMS, s_q + 2 * TILE7_ELEMS}, lw,
                s_bias + (i % group) * NN_FLOATS,
                p.mask ? p.mask + static_cast<size_t>(w.wmap) * N * N : nullptr,
                [&](const float (&acc)[4][4], int ra, int rb) {
                  // o over this warp's own q rows, which only it has read
#pragma unroll
                  for (int n = 0; n < 4; ++n) {
                    if (ra < N)
                      *reinterpret_cast<uint32_t*>(s_q + swz64(ra, n) + 2 * t) =
                          pack2(acc[n][0], acc[n][1]);
                    if (rb < N)
                      *reinterpret_cast<uint32_t*>(s_q + swz64(rb, n) + 2 * t) =
                          pack2(acc[n][2], acc[n][3]);
                  }
                });
    // the TMA store reads o through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) mbar_arrive(&bars->empty[slot]);
  }
}

// K7's plan against its layout (ops/window_attention.py: window_plan)
bool window_plan_ok(int heads, int group, int wpb, int stages, int smem_bytes) {
  return group >= 1 && heads % group == 0 && wpb >= 1 && stages >= 3 &&
         stages <= MAX_STAGES7 && smem_bytes <= SMEM_LIMIT7 &&
         WinSmem(group, stages).bytes == static_cast<size_t>(smem_bytes);
}

// A [B, Hp, Wp, C] bf16 map as the 5D tensor [B, Hp, Wp, heads, 32] (dims
// innermost first), boxes of one head's 32 channels of a 7 x 7 window,
// 64-byte swizzle.  Cached by (pointer, shape): the same arguments give
// the same map, so a hit is always right.
bool head_tile_map(CUtensorMap* tm, const void* p, int B, int Hp, int Wp, int C) {
  struct Entry {
    const void* p;
    int B, Hp, Wp, C;
    CUtensorMap tm;
  };
  static Entry cache[64];
  static int used = 0, next = 0;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  for (int e = 0; e < used; ++e) {
    const Entry& c = cache[e];
    if (c.p == p && c.B == B && c.Hp == Hp && c.Wp == Wp && c.C == C) {
      *tm = c.tm;
      return true;
    }
  }
  EncodeFn encode = encode_fn();
  if (!encode) return false;
  const cuuint64_t row = static_cast<cuuint64_t>(C) * sizeof(bf16);
  const cuuint64_t dims[5] = {DH, static_cast<cuuint64_t>(C / DH), static_cast<cuuint64_t>(Wp),
                              static_cast<cuuint64_t>(Hp), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[4] = {DH * sizeof(bf16), row, row * Wp, row * Wp * Hp};
  const cuuint32_t box[5] = {DH, 1, WIN, WIN, 1};
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  if (encode(tm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(p), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) !=
      CUDA_SUCCESS)
    return false;
  Entry& e = cache[next];
  e = Entry{p, B, Hp, Wp, C, *tm};
  next = (next + 1) % 64;
  if (used < 64) ++used;
  return true;
}

cudaError_t run_window_bf16(const void* q, const void* k, const void* v, void* out,
                            const WinParams& p, int B, int C, int smem_bytes, cudaStream_t st) {
  if (!window_plan_ok(p.heads, p.group, p.wpb, p.stages, smem_bytes))
    return cudaErrorInvalidValue;
  CUtensorMap tm[4];
  const void* maps[4] = {q, k, v, out};
  for (int m = 0; m < 4; ++m)
    if (!head_tile_map(&tm[m], maps[m], B, p.Hp, p.Wp, C)) return cudaErrorNotSupported;
  cudaError_t err = cudaFuncSetAttribute(attn_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  const int blocks = (p.heads / p.group) * ((p.windows + p.wpb - 1) / p.wpb);
  attn_bf16_kernel<<<blocks, RING_THREADS, smem_bytes, st>>>(p, tm[0], tm[1], tm[2], tm[3]);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ fp32

// head j's attention over the W x W window w from q/k/v [W^2 x FLD] in
// shared memory into columns 32j.. of the output map; ends in a barrier
template <int W>
__device__ void attend_f32(const Params& p, const WindowOf<W>& w, const float* s_q,
                           const float* s_k, const float* s_v, float* s_s, int j) {
  constexpr int NN = W * W;
  float* out = static_cast<float*>(p.out);
  attend_head_f32<W>(s_q, s_k, s_v, s_s, p.bias + static_cast<size_t>(j) * NN * NN,
                     p.mask ? p.mask + static_cast<size_t>(w.wmap) * NN * NN : nullptr,
                     [&](int r, int d, float o) {
                       out[w.offset(p.Hp, p.Wp, p.C, r) + j * DH + d] = o;
                     });
}

// K6, fp32: one block a W x W window, every head in turn; q, k, v and the
// scores in dynamic shared memory (f32_smem)
template <int W>
__global__ void __launch_bounds__(THREADS)
attn_qkv_f32_kernel(Params p) {
  constexpr int NN = W * W;
  extern __shared__ __align__(16) float s_f32[];
  float* s_q = s_f32;
  float* s_k = s_q + NN * FLD;
  float* s_v = s_k + NN * FLD;
  float* s_s = s_v + NN * FLD;
  const WindowOf<W> w(blockIdx.x, p.Hp, p.Wp);
  const int C = p.C;
  const float* x = static_cast<const float*>(p.x);
  const float* wqkv = static_cast<const float*>(p.wqkv);
  for (int j = 0; j < p.heads; ++j) {
    project_head_f32<W>([&](int r) { return x + w.offset(p.Hp, p.Wp, C, r); }, wqkv, p.bqkv,
                        C, j, s_q, s_k, s_v);
    attend_f32<W>(p, w, s_q, s_k, s_v, s_s, j);
  }
}

// K7, fp32: as K6's, q, k and v read from their maps
template <int W>
__global__ void __launch_bounds__(THREADS)
attn_f32_kernel(Params p) {
  constexpr int NN = W * W;
  extern __shared__ __align__(16) float s_f32[];
  float* s_q = s_f32;
  float* s_k = s_q + NN * FLD;
  float* s_v = s_k + NN * FLD;
  float* s_s = s_v + NN * FLD;
  const WindowOf<W> w(blockIdx.x, p.Hp, p.Wp);
  const float* q = static_cast<const float*>(p.x);
  const float* k = static_cast<const float*>(p.k);
  const float* v = static_cast<const float*>(p.v);
  for (int j = 0; j < p.heads; ++j) {
    for (int e = threadIdx.x; e < NN * DH; e += THREADS) {
      const int r = e / DH, d = e % DH;
      const size_t off = w.offset(p.Hp, p.Wp, p.C, r) + j * DH + d;
      s_q[r * FLD + d] = q[off];
      s_k[r * FLD + d] = k[off];
      s_v[r * FLD + d] = v[off];
    }
    __syncthreads();
    attend_f32<W>(p, w, s_q, s_k, s_v, s_s, j);
  }
}

// an fp32 kernel (attn_qkv_f32_kernel<W> or attn_f32_kernel<W>) over every
// window, with its shared memory
template <int W, class Kernel>
cudaError_t launch_f32(Kernel kernel, const Params& p, cudaStream_t st) {
  constexpr int bytes = f32_smem(W);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         bytes);
  if (err != cudaSuccess) return err;
  kernel<<<p.B * (p.Hp / W) * (p.Wp / W), THREADS, bytes, st>>>(p);
  return cudaGetLastError();
}

// ------------------------------------------------------------ bf16, staged

// K6's qkv product (swin::gemm_tile): qkv = round(x wqkv^T + bqkv) [M, 3C]
template <int BN>
__global__ void __launch_bounds__(RING_THREADS, BN <= 128 ? 2 : 1)
qkv_gemm_kernel(const __grid_constant__ CUtensorMap tm_a,
                const __grid_constant__ CUtensorMap tm_w, const float* __restrict__ bias,
                const bf16* __restrict__ res, const bf16* __restrict__ gelu_tbl,
                bf16* __restrict__ out, int M, int N, int K, int stages) {
  gemm_tile<BN, QKV>(&tm_a, &tm_w, bias, res, gelu_tbl, out, M, N, K, stages);
}

// K6's window attention over its qkv map, and K7's over its three maps
// (swin_hopper.cuh: window_core)
template <int W>
__global__ void __launch_bounds__(WIN_THREADS<W>)
qkv_win_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, int ld, const float* __restrict__ bias,
               const float* __restrict__ mask, bf16* __restrict__ o, int Hp, int Wp, int C) {
  window_core<W>(q, k, v, ld, bias, mask, o, Hp, Wp, C);
}
template <int W>
__global__ void __launch_bounds__(WIN_THREADS<W>)
win_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, int ld, const float* __restrict__ bias,
                const float* __restrict__ mask, bf16* __restrict__ o, int Hp, int Wp, int C) {
  window_core<W>(q, k, v, ld, bias, mask, o, Hp, Wp, C);
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
  return static_cast<int>(launch_f32<WIN>(attn_qkv_f32_kernel<WIN>, p, st));
}

// K7.  dtype: 0 = float32 (the first design, one block a window; the plan
// is not read), 1 = bfloat16 with the launch plan of ops/window_attention.py:
// window_plan (group heads a block, dividing the heads; wpb windows a
// block; 3 to 8 ring slots; smem_bytes its shared memory, which must equal
// WinSmem's sum: cudaErrorInvalidValue otherwise).  q, k, v and out 16-byte
// aligned.  Launches on `stream`; returns the launch's error.
extern "C" int window_attn_fwd(const void* q, const void* k, const void* v, const void* bias,
                               const void* mask, void* out, int B, int Hp, int Wp, int C,
                               int heads, int dtype, int group, int wpb, int stages,
                               int smem_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int windows = B * (Hp / WIN) * (Wp / WIN);
  if (dtype == 1) {
    const WinParams p{static_cast<const float*>(bias), static_cast<const float*>(mask),
                      Hp, Wp, heads, windows, group, wpb, stages};
    return static_cast<int>(run_window_bf16(q, k, v, out, p, B, C, smem_bytes, st));
  }
  Params p{q, k, v, nullptr, nullptr, static_cast<const float*>(bias),
           static_cast<const float*>(mask), out, B, Hp, Wp, C, heads, 0, 0, 0};
  return static_cast<int>(launch_f32<WIN>(attn_f32_kernel<WIN>, p, st));
}

// The staged designs of K6 and K7, at window 7 or 12 over a map padded to
// its multiples, C = 32 heads up to 1536 (ops/window_attention.py:
// window_path takes them at window 12 and at C = 1536; the fused designs
// above elsewhere); dtype 0 = float32 (the fp32 kernel at this window, no
// plan or scratch read), 1 = bfloat16.  Launches on `stream`; returns the
// first error; cudaErrorInvalidValue on a shape or plan they do not take.
//
// K6: qkv [M, 3C] bf16 scratch, M = B Hp Wp; (bn, stages, smem_bytes) the
// qkv product's plan (ops/swin_attention.py: staged_plan's "qkv", checked
// against gemm_smem); C a multiple of 64 (the product's k-chunk).  Two
// launches: the product, then the window attention over qkv into out.
extern "C" int window_attn_qkv_staged(const void* x, const void* wqkv, const void* bqkv,
                                      const void* bias, const void* mask, void* out, void* qkv,
                                      int B, int Hp, int Wp, int C, int heads, int window,
                                      int dtype, int bn, int stages, int smem_bytes,
                                      void* stream) {
  if (C != heads * DH || C > 1536 || (window != WIN && window != 12) || Hp % window ||
      Wp % window)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const Params p{x, nullptr, nullptr, wqkv, static_cast<const float*>(bqkv),
                   static_cast<const float*>(bias), static_cast<const float*>(mask), out,
                   B, Hp, Wp, C, heads, 0, 0, 0};
    return static_cast<int>(window == 12 ? launch_f32<12>(attn_qkv_f32_kernel<12>, p, st)
                                         : launch_f32<WIN>(attn_qkv_f32_kernel<WIN>, p, st));
  }
  if (!gemm_plan_ok<QKV>(3 * C, C, bn, stages, smem_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  auto gemm = bn == 256 ? qkv_gemm_kernel<256> : bn == 128 ? qkv_gemm_kernel<128>
                                                            : qkv_gemm_kernel<64>;
  bf16* m = static_cast<bf16*>(qkv);
  cudaError_t err = launch_gemm_kernel(gemm, x, wqkv, static_cast<const float*>(bqkv), nullptr,
                                       nullptr, m, B * Hp * Wp, 3 * C, C, bn, smem_bytes,
                                       stages, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = window == 12
            ? launch_window_core<12>(qkv_win_kernel<12>, m, m + C, m + 2 * C, 3 * C, bias, mask,
                                     out, B, Hp, Wp, C, heads, st)
            : launch_window_core<WIN>(qkv_win_kernel<WIN>, m, m + C, m + 2 * C, 3 * C, bias,
                                      mask, out, B, Hp, Wp, C, heads, st);
  return static_cast<int>(err);
}

// K7: one launch of the window attention over the three maps q, k, v
// [M, C] (16-byte aligned) into out.
extern "C" int window_attn_staged(const void* q, const void* k, const void* v, const void* bias,
                                  const void* mask, void* out, int B, int Hp, int Wp, int C,
                                  int heads, int window, int dtype, void* stream) {
  if (C != heads * DH || C > 1536 || (window != WIN && window != 12) || Hp % window ||
      Wp % window)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const Params p{q, k, v, nullptr, nullptr, static_cast<const float*>(bias),
                   static_cast<const float*>(mask), out, B, Hp, Wp, C, heads, 0, 0, 0};
    return static_cast<int>(window == 12 ? launch_f32<12>(attn_f32_kernel<12>, p, st)
                                         : launch_f32<WIN>(attn_f32_kernel<WIN>, p, st));
  }
  const bf16 *bq = static_cast<const bf16*>(q), *bk = static_cast<const bf16*>(k),
             *bv = static_cast<const bf16*>(v);
  return static_cast<int>(
      window == 12 ? launch_window_core<12>(win_attn_kernel<12>, bq, bk, bv, C, bias, mask, out,
                                            B, Hp, Wp, C, heads, st)
                   : launch_window_core<WIN>(win_attn_kernel<WIN>, bq, bk, bv, C, bias, mask,
                                             out, B, Hp, Wp, C, heads, st));
}
