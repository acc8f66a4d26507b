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
//   bytes (82 MB, 24 us) are as large as the operations (25 us).  What
//   the kernel moves besides: every window's products need all 4C^2
//   weights, from L2, so the weights' L2 traffic per launch is windows x
//   8C^2 bytes (427-503 MB at the four stages) unless a block shares them.
//
// What held the first bf16 design back (one block of 8 warps a window),
//   numbered as the parts below that answer it: (1) every weight fragment
//   came from L2 four bytes at a time, nothing in flight; (2) warps idle:
//   6 of 8 in the projection, 4 in the attention, two block barriers a
//   head; (3) each window's 49 rows padded to 64 in both products; (4) the
//   bias and mask gathered from L2 per head; (5) too few blocks: 60 on 132
//   SMs at Swin-B's stage 3, one block an SM from C = 512 on.
//
// Design (bf16).  A block is two consumer warpgroups and one producer warp
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
//
// Design (fp32, for the checks): the same phases on the CUDA cores, one
//   block per window; the LN'd tile and the head outputs live in a device
//   scratch buffer [2, windows, 49, C] that the wrapper allocates (an fp32
//   [49 x C] tile at C = 1024 takes 200 KB), q/k/v and the scores in shared
//   memory (29,204 B).  Each dot product over C is one warp with coalesced
//   loads and a shuffle sum.

#include <cooperative_groups.h>
#include <cuda.h>

#include "window_attn_core.cuh"

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

constexpr int NN_BYTES = 9616;     // an fp32 [49, 49] tile, padded to 16 bytes
constexpr int NN_FLOATS = NN_BYTES / 4;
// a warpgroup's k [64 x LDQ] and v^T [DH x LDV], bf16
constexpr int KV_BYTES = 2 * (64 * LDQ + DH * LDV);

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

// The window of index `idx` over B maps of Hp x Wp.
struct WindowAt {
  int b, wr, wc, wmap;
  __device__ WindowAt(int idx, int Hp, int Wp) {
    const int nww = Wp / WIN, nwin_map = (Hp / WIN) * nww;
    b = idx / nwin_map;
    wmap = idx % nwin_map;
    wr = wmap / nww;
    wc = wmap % nww;
  }
  __device__ __forceinline__ size_t offset(int Hp, int Wp, int C, int i) const {
    const int row = wr * WIN + i / WIN, col = wc * WIN + i % WIN;
    return ((static_cast<size_t>(b) * Hp + row) * Wp + col) * C;
  }
};

// Shared memory of the bf16 kernel (byte offsets); attn_plan in
// ops/swin_attention.py computes the same sum.
struct SmemBf16 {
  int lda;
  size_t ring, slot, a, kv, mask, bias, bars, bytes;
  __host__ __device__ SmemBf16(int C, int wpb, int kc, int stages) {
    const int spl = 3 - wpb;
    lda = C + 8;                                  // LN / o tiles [49 x C], bf16
    ring = 0;                                     // 1024-byte aligned (the swizzle)
    slot = sizeof(bf16) * 96 * spl * kc;          // a multiple of 1024 bytes
    a = ring + stages * slot;
    kv = a + sizeof(bf16) * N * lda * wpb;
    mask = kv + 2 * KV_BYTES;                     // per warpgroup
    bias = mask + wpb * NN_BYTES;                 // per window
    bars = bias + 2 * NN_BYTES;                   // two heads' attention biases
    bytes = bars + 256;                           // the mbarriers (Bars below)
  }
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// the 256 threads of the two consumer warpgroups (barrier 1), and the 128
// of warpgroup g (barrier 2 + g)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}
__device__ __forceinline__ void wg_sync(int g) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + g) : "memory");
}
// four 8x8 bf16 matrices; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// arrives on bar once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes) : "memory");
}
// wait for the phase of bar with this parity to complete; a phase that
// never completes (a copy that never lands) traps after about 2^31 cycles
// instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  long long t0 = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (done) return;
    if (!t0) t0 = clock64();
    else if (clock64() - t0 > (1ll << 31)) __trap();
  }
}
// the box of tensor map tm at coordinates (c0, c1, c2, c3) (2D maps: c0,
// c1) into shared memory, its bytes counted on bar
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* tm, int c0, int c1,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(tm)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void tma_4d(void* dst, const CUtensorMap* tm, int c0, int c1, int c2,
                                       int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(tm)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar)) : "memory");
}
// descriptor of a K-major bf16 tile whose rows of kc channels TMA wrote
// with the 128-byte (kc 64) or 64-byte (kc 32) swizzle: 8-row groups 16 kc
// bytes apart; a k-step of 16 channels adds 32 bytes to the address
__device__ __forceinline__ uint64_t swz_desc(const bf16* p, int kc) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(kc) << 32) | ((kc == 64 ? 1ull : 2ull) << 62);
}
// D[64 x N] += A B^T: A in registers (each warp of the warpgroup its 16
// rows, the m16n8k16 A fragment), B [N x 16] in shared memory, K-major
// without swizzle (descriptor b); fp32 accumulators in the m16n8 layout
// per 8 columns
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, {%32,%33,%34,%35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_n96(float (&d)[48], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47}, {%48,%49,%50,%51}, %52, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

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

// the compiler keeps these registers as they are up to here (the products
// read or write them asynchronously)
template <int R>
__device__ __forceinline__ void keep(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
    asm volatile("" : "+r"(a[i][0]), "+r"(a[i][1]), "+r"(a[i][2]), "+r"(a[i][3]) :: "memory");
}
template <int R>
__device__ __forceinline__ void keep(float (&acc)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(acc[i]) :: "memory");
}

// acc += A [64 rows, C columns] W^T on this warpgroup, over the nk ring
// chunks of a round or pass: take() gives chunk kk's slot, whose rows n0
// .. n0 + NC - 1 (swizzled rows of kc channels, see swz_desc) are W's
// columns kk kc .. + kc; release() frees the oldest slot taken.  Each warp
// feeds its 16 rows of A from registers (ldmatrix; rows past 48 read row
// 48).  With ASYNC, a chunk's products stay in flight while the next
// chunk's are issued (A fragments in two register sets); a slot is freed
// once its products have completed.
template <int NC, bool ASYNC, class Take, class Release>
__device__ __forceinline__ void products(float (&acc)[NC / 2], const bf16* A, int lda, int kc,
                                         int nk, int n0, Take take, Release release) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bf16* arow = A + min(16 * (warp & 3) + (lane & 15), N - 1) * lda + 8 * (lane >> 4);
  const int nks = kc / 16;
  uint32_t a0[4][4], a1[4][4];
  auto chunk = [&](uint32_t (&a)[4][4], uint32_t (&prev)[4][4], int kk) {
    const bf16* slot = take();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      if (ks < nks) ldsm_x4(a[ks], arow + kk * kc + 16 * ks);
    const uint64_t b0 = swz_desc(slot + n0 * kc, kc);  // row n0 starts an 8-row group
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      if (ks >= nks) break;
      if constexpr (NC == 96) wgmma_n96(acc, a[ks], b0 + 2 * ks);
      else wgmma_n64(acc, a[ks], b0 + 2 * ks);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if constexpr (ASYNC) {
      if (kk > 0) {
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        keep(prev);
        release();
      }
    } else {
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      keep(a);
      keep(acc);
      release();
    }
  };
  if constexpr (ASYNC) {
    int kk = 0;
    for (; kk + 1 < nk; kk += 2) {
      chunk(a0, a1, kk);
      chunk(a1, a0, kk + 1);
    }
    if (kk < nk) chunk(a0, a1, kk);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    keep(a0);
    keep(a1);
    keep(acc);
    release();
  } else {
    for (int kk = 0; kk < nk; ++kk) chunk(a0, a0, kk);
  }
}

// q | k | v of local head hl from the warpgroup's [64 x 96] accumulators,
// plus the fp32 bias (bq: the block's first head's bqkv, parts C apart),
// rounded: k row-major into s_k [64 x LDQ], v transposed into s_vt [DH x
// LDV]; q, which only this warp's attention reads (its own 16 rows), stays
// in registers as the A fragments of the score product's two k-steps
__device__ __forceinline__ void split_qkv(const float (&acc)[48], const float* bq, int C, int hl,
                                          uint32_t (&qa)[2][4], bf16* s_k, bf16* s_vt) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (warp & 3) + g;
#pragma unroll
  for (int n = 0; n < 12; ++n) {
    const int part = n / 4, d = 8 * (n % 4) + 2 * t;
    const float* b = bq + part * C + hl * DH + d;
    const float bias0 = __ldg(b), bias1 = __ldg(b + 1);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + 8 * hh;  // 0..63
      const float v0 = acc[4 * n + 2 * hh] + bias0, v1 = acc[4 * n + 2 * hh + 1] + bias1;
      if (part == 0) {
        qa[n / 2][2 * (n % 2) + hh] = pack2(v0, v1);
      } else if (part == 1) {
        st2(s_k + r * LDQ + d, v0, v1);
      } else {
        s_vt[d * LDV + r] = __float2bfloat16_rn(v0);
        s_vt[(d + 1) * LDV + r] = __float2bfloat16_rn(v1);
      }
    }
  }
}

// One head's attention on the 4 warps of a warpgroup, from q in registers
// (split_qkv), s_k [64 x LDQ] and s_vt [DH x LDV]: warp l owns query rows
// 16l .. 16l + 15
// and all 64 keys (keys past 48 get -inf); the scores stay in registers,
// softmax with quad shuffles, and the probabilities become the A
// fragments of P.V directly.  bh and mk (or null) are the head's bias and
// the window's mask, [49, 49] fp32 in shared memory.  The head's 32
// output columns of rows < 49 go to o [49 x ldo] when `store`.
__device__ __forceinline__ void attend_head_wg(const uint32_t (&a)[2][4], const bf16* s_k,
                                               const bf16* s_vt,
                                               const float* bh, const float* mk, bf16* o, int ldo,
                                               bool store) {
  const int lane = threadIdx.x & 31, lw = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int qa = 16 * lw + g, qb = qa + 8;
  const int r0 = min(qa, N - 1), r1 = min(qb, N - 1);
  float s[8][4] = {};
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    uint32_t b[4];
    ldsm_x4(b, s_k + (8 * n + (lane & 7)) * LDQ + 8 * (lane >> 3));
    mma16816(s[n], a[0], b[0], b[1]);
    mma16816(s[n], a[1], b[2], b[3]);
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * n + 2 * t + (e & 1), r = e < 2 ? r0 : r1;
      float v = round_bf16(s[n][e] * SCALE);
      if (col < N) {
        v += bh[r * N + col];
        if (mk) v += mk[r * N + col];
      } else {
        v = -INFINITY;
      }
      s[n][e] = v;
      if (e < 2) mx0 = fmaxf(mx0, v); else mx1 = fmaxf(mx1, v);
    }
#pragma unroll
  for (int sh = 1; sh < 4; sh <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, sh));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, sh));
  }
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = expf(s[n][e] - (e < 2 ? mx0 : mx1));
      s[n][e] = v;
      if (e < 2) sum0 += v; else sum1 += v;
    }
#pragma unroll
  for (int sh = 1; sh < 4; sh <<= 1) {
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, sh);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, sh);
  }
  // p = e / sum as the reciprocal's product and one Newton step: the
  // correctly rounded quotient of normal values, without the division
  // routine (whose slow path the masked scores' tiny e reach)
  const float i0 = 1.f / sum0, i1 = 1.f / sum1;
  auto div = [](float e, float sum, float inv) {
    const float q = e * inv;
    return fmaf(fmaf(-q, sum, e), inv, q);
  };
  // the score accumulators of n-tiles 2kk, 2kk + 1 are the A fragment of
  // keys 16kk .. 16kk + 15
  float acc[4][4] = {};
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t pa[4];
    pa[0] = pack2(div(s[2 * kk][0], sum0, i0), div(s[2 * kk][1], sum0, i0));
    pa[1] = pack2(div(s[2 * kk][2], sum1, i1), div(s[2 * kk][3], sum1, i1));
    pa[2] = pack2(div(s[2 * kk + 1][0], sum0, i0), div(s[2 * kk + 1][1], sum0, i0));
    pa[3] = pack2(div(s[2 * kk + 1][2], sum1, i1), div(s[2 * kk + 1][3], sum1, i1));
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t b[4];  // b0, b1 of channel n-tiles 2np and 2np + 1
      ldsm_x4(b, s_vt + (16 * np + 8 * (lane >> 4) + (lane & 7)) * LDV + 16 * kk +
                     8 * ((lane >> 3) & 1));
      mma16816(acc[2 * np], pa, b[0], b[1]);
      mma16816(acc[2 * np + 1], pa, b[2], b[3]);
    }
  }
  if (!store) return;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int c = 8 * n + 2 * t;
    if (qa < N) st2(o + qa * ldo + c, acc[n][0], acc[n][1]);
    if (qb < N) st2(o + qb * ldo + c, acc[n][2], acc[n][3]);
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

template <int R>
__device__ __forceinline__ void zero(float (&acc)[R]) {
#pragma unroll
  for (int e = 0; e < R; ++e) acc[e] = 0.f;
}

// the block: two consumer warpgroups and one producer warp
constexpr int K4_THREADS = THREADS + 32;
constexpr int MAX_STAGES = 5;

// The mbarriers of the bf16 kernel: per ring slot full (the producer's
// arrival with the slot's TMA bytes) and empty (the 8 consumer warps'
// arrivals once their products have read it); per attention bias buffer
// full (the producer lanes' copies) and empty (the consumer warps, after
// the round's attention).
struct Bars {
  uint64_t full[MAX_STAGES], empty[MAX_STAGES], bias_full[2], bias_empty[2];
};
static_assert(sizeof(Bars) <= 256, "K4 barriers");

template <int C>
__global__ void __launch_bounds__(K4_THREADS, C <= 128 ? 2 : 1)
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
  const int n_chunks = (M::ROUNDS + M::PASSES) * nk;

  // prologue: the barriers; the windows' tiles of x and their masks
  if (producer) {
    if (lane == 0) {
      if (smem_u32(smem) & 1023) __trap();  // the swizzled boxes need 1024-byte alignment
      for (int s = 0; s < stages; ++s) {
        mbar_init(&bars->full[s], 1);
        mbar_init(&bars->empty[s], WARPS);
      }
      for (int b = 0; b < 2; ++b) {
        mbar_init(&bars->bias_full[b], 32);
        mbar_init(&bars->bias_empty[b], WARPS);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  } else {
    const bf16* x = static_cast<const bf16*>(p.x);
    for (int i = tid; i < WPB * N * (C / 8); i += THREADS) {
      const int t = i / (N * (C / 8)), r = (i / (C / 8)) % N, piece = i % (C / 8);
      const WindowAt wt(min(win0 + t, windows - 1), p.Hp, p.Wp);
      cp_async16(s_a0 + (t * N + r) * lda + 8 * piece,
                 x + wt.offset(p.Hp, p.Wp, C, r) + 8 * piece);
    }
    if (p.mask)
      for (int t = 0; t < WPB; ++t) {
        const WindowAt wt(min(win0 + t, windows - 1), p.Hp, p.Wp);
        const float* src = p.mask + static_cast<size_t>(wt.wmap) * N * N;
        for (int i = tid; i < N * N; i += THREADS) cp_async4(s_mask0 + t * NN_FLOATS + i, src + i);
      }
    cp_async_commit();
    cp_async_wait_all();
  }
  __syncthreads();

  if (producer) {
    // The ring's producer.  Chunk c = (pj, pk) is k-chunk pk of round pj's
    // rows of wqkv (per local head pj SPL + s its q, k and v rows, one TMA
    // box of 3 x 32 rows) or, for pj >= ROUNDS, of the NO SPL rows of wproj of
    // out-projection pass pj - ROUNDS (one box); lane 0 puts it in slot c %
    // stages, rows in that order, once the consumers have released the
    // slot's previous chunk.  The warp copies round pj's attention biases
    // (SPL heads) into bias buffer pj % NB once round pj - NB has released
    // it: in pair mode (two buffers) with the round's first chunk, in split
    // mode (one buffer of two heads) with its chunk min(stages, nk - 1),
    // when the consumers are past round pj - 1.  Before the first wproj
    // chunk it arrives on the cluster barrier that the consumers wait on
    // before the out-projection.
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_q)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_o)) : "memory");
    }
    for (int c = 0; c < n_chunks; ++c) {
      const int pj = c / nk, pk = c % nk, slot = c % stages;
      if (pj < M::ROUNDS && pk == (NB == 2 ? 0 : min(stages, nk - 1))) {
        const int b = pj % NB;
        if (pj >= NB) mbar_wait(&bars->bias_empty[b], (pj / NB - 1) & 1);
#pragma unroll
        for (int s = 0; s < SPL; ++s) {
          const float* src = p.bias + static_cast<size_t>(head0 + pj * SPL + s) * N * N;
          float* dst = s_bias + (b * SPL + s) * NN_FLOATS;
          for (int i = lane; i < N * N; i += 32) cp_async4(dst + i, src + i);
        }
        mbar_arrive_cp_async(&bars->bias_full[b]);
      }
      if (CL > 1 && pj == M::ROUNDS && pk == 0)
        asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
      if (c >= stages) mbar_wait(&bars->empty[slot], (c / stages - 1) & 1);
      if (lane == 0) {
        bf16* dst = s_ring + slot * slot_elems;
        uint64_t* full = &bars->full[slot];
        const int k0 = pk * kc;
        if (pj < M::ROUNDS) {
          mbar_expect(full, static_cast<int>(L.slot));
#pragma unroll
          for (int s = 0; s < SPL; ++s)
            tma_4d(dst + 96 * s * kc, &tm_q, k0, 0, head0 + pj * SPL + s, 0, full);
        } else {
          mbar_expect(full, static_cast<int>(sizeof(bf16)) * NO * SPL * kc);
          tma_2d(dst, &tm_o, k0, col0 + (pj - M::ROUNDS) * NO * SPL, full);
        }
      }
      __syncwarp();
    }
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
    attend_head_wg(qa, s_k, s_vt, s_bias + (b * SPL + half) * NN_FLOATS,
                   p.mask ? s_mask0 + tile * NN_FLOATS : nullptr, o_win + (head0 + hl) * DH, C,
                   mine);
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

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query (no link to libcuda)
using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeFn encode_fn() {
  static EncodeFn fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    return cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q) ==
                       cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeFn>(f) : nullptr;
  }();
  return fn;
}

// A bf16 weight matrix as boxes of kc channels, swizzled as swz_desc reads
// them.  wproj [C, C]: 2D, boxes of box_rows rows.  wqkv [3C, C], seen as
// [3 (part), C/32 (head), 32, C]: 4D, a box (kc, 32, 1, 3) is one head's
// 96 rows q | k | v.
bool weight_map(CUtensorMap* tm, const void* w, bool qkv, int C, int kc, int box_rows) {
  EncodeFn encode = encode_fn();
  if (!encode) return false;
  const cuuint64_t row = static_cast<cuuint64_t>(C) * sizeof(bf16);
  const cuuint64_t dims_o[2] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(C)};
  const cuuint64_t dims_q[4] = {static_cast<cuuint64_t>(C), DH, static_cast<cuuint64_t>(C / DH), 3};
  const cuuint64_t strides[3] = {row, DH * row, C * row};
  const cuuint32_t box_o[2] = {static_cast<cuuint32_t>(kc), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t box_q[4] = {static_cast<cuuint32_t>(kc), DH, 1, 3};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(tm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, qkv ? 4 : 2, const_cast<void*>(w),
                qkv ? dims_q : dims_o, strides, qkv ? box_q : box_o,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                kc == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
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
  cfg.blockDim = dim3(K4_THREADS);
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

__global__ void __launch_bounds__(THREADS)
attn_f32_kernel(Params p) {
  __shared__ float s_q[N * FLD], s_k[N * FLD], s_v[N * FLD], s_s[N * SLD];
  const int C = p.C;
  const int nwin = p.B * (p.Hp / WIN) * (p.Wp / WIN);
  const Window w(p.Hp, p.Wp);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* wqkv = static_cast<const float*>(p.wqkv);
  const float* wproj = static_cast<const float*>(p.wproj);
  float* scratch = static_cast<float*>(p.scratch);
  float* xn = scratch + static_cast<size_t>(blockIdx.x) * N * C;
  float* o = scratch + static_cast<size_t>(nwin + blockIdx.x) * N * C;

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

// dtype: 0 = float32 (scratch: 2 * windows * 49 * C floats; the plan is not
// read), 1 = bfloat16 (scratch: the o map, windows * 49 * C bf16) with the
// launch plan of ops/swin_attention.py: attn_plan (wpb windows a block and
// cluster blocks a window, which must be C's mode; ring chunk kc of 32 or
// 64 channels; 3 to 5 ring slots; smem_bytes its shared memory, which must
// equal SmemBf16's sum: cudaErrorInvalidValue otherwise).  Launches on
// `stream`; returns the launch's error.
extern "C" int swin_block_attn_fwd(const void* x, const void* ln_g, const void* ln_b,
                                   const void* wqkv, const void* bqkv, const void* bias,
                                   const void* mask, const void* wproj, const void* bproj,
                                   void* out, void* scratch, int B, int Hp, int Wp, int C,
                                   int heads, int hv, int wv, int shift, float eps, int dtype,
                                   int wpb, int cluster, int kc, int stages, int smem_bytes,
                                   void* stream) {
  Params p{x, static_cast<const float*>(ln_g), static_cast<const float*>(ln_b), wqkv,
           static_cast<const float*>(bqkv), static_cast<const float*>(bias),
           static_cast<const float*>(mask), wproj, static_cast<const float*>(bproj), out,
           scratch, B, Hp, Wp, C, heads, hv, wv, shift, eps, kc, stages};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int windows = B * (Hp / WIN) * (Wp / WIN);
  if (dtype == 1) {
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
  attn_f32_kernel<<<windows, THREADS, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
