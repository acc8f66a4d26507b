// The Hopper pieces of the Swin kernels that stream their operands
// through a TMA ring: K4 (swin_block_attn.cu), K6's bf16 path
// (window_attn_qkv.cu) and K5's products from C = 512 on
// (swin_block_mlp.cu: the mbarriers, TMA, swz_desc, the SS wgmma forms and
// tile_map_2d).  A block is two consumer warpgroups and one
// producer warp (RING_THREADS); the producer (ring_producer) streams each
// head's q, k and v rows of wqkv, and for K4 the out-projection's rows of
// wproj, through `stages` swizzled shared-memory slots by TMA, with
// full/empty mbarriers, and copies each round's attention bias; the
// consumers multiply by wgmma (products), split a head's q | k | v
// (split_qkv) and run its attention in registers (attend_head_wg).  The
// design and its reasons are in swin_block_attn.cu's header.  K7's bf16
// path (window_attn_qkv.cu) runs the same attention core (attend_head)
// over q, k and v tiles that TMA wrote row-major (SwizzledKV), and the
// staged designs of K4, K6 and K7 (window 12, C = 1536) over rows gathered
// from device memory (window_core).
// ops/_build.py hashes this header into every library.

#pragma once

#include <cuda.h>

#include "window_attn_core.cuh"

namespace swin {

constexpr int NN_BYTES = 9616;     // an fp32 [49, 49] tile, padded to 16 bytes
constexpr int NN_FLOATS = NN_BYTES / 4;
// a warpgroup's k [64 x LDQ] and v^T [DH x LDV], bf16
constexpr int KV_BYTES = 2 * (64 * LDQ + DH * LDV);

// The W x W window of index `idx` over B maps of Hp x Wp: its map b, its
// row and column of windows, its index wmap in its map (the mask's), and
// token i's element offset in a [B, Hp, Wp, C] map.
template <int W>
struct WindowOf {
  int b, wr, wc, wmap;
  __device__ WindowOf(int idx, int Hp, int Wp) {
    const int nww = Wp / W, nwin_map = (Hp / W) * nww;
    b = idx / nwin_map;
    wmap = idx % nwin_map;
    wr = wmap / nww;
    wc = wmap % nww;
  }
  __device__ __forceinline__ size_t offset(int Hp, int Wp, int C, int i) const {
    const int row = wr * W + i / W, col = wc * W + i % W;
    return ((static_cast<size_t>(b) * Hp + row) * Wp + col) * C;
  }
};
using WindowAt = WindowOf<WIN>;

// Shared memory of the ring kernels (byte offsets) for wpb windows a block;
// attn_plan in ops/swin_attention.py (K4) and qkv_plan in
// ops/window_attention.py (K6) compute the same sum.
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

// D[64 x N] += A B^T with both operands in shared memory (K5's products):
// A [64 x 16] and B [N x 16], K-major, each by a swizzled descriptor
// (swz_desc); fp32 accumulators laid out as in the forms above
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_n256(float (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95,%96,%97,%98,%99,%100,%101,%102,%103,%104,%105,%106,%107,%108,%109,%110,%111,%112,%113,%114,%115,%116,%117,%118,%119,%120,%121,%122,%123,%124,%125,%126,%127}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
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

// The k and v tiles the attention core reads, as the B fragments of its
// two products.  K4's and K6's: k row-major [64 x LDQ] and v transposed
// [DH x LDV] (split_qkv writes them; rows past 48 hold finite values).
struct PaddedKV {
  const bf16* k;
  const bf16* vt;
  // keys 8n .. 8n + 7 against channels 0..31: the b0, b1 of k-steps 0 and 1
  __device__ __forceinline__ void k_frag(uint32_t (&b)[4], int n, int lane) const {
    ldsm_x4(b, k + (8 * n + (lane & 7)) * LDQ + 8 * (lane >> 3));
  }
  // keys 16kk .. 16kk + 15 against channels 16np .. 16np + 15: b0, b1 of
  // channel n-tiles 2np and 2np + 1
  __device__ __forceinline__ void v_frag(uint32_t (&b)[4], int np, int kk, int lane) const {
    ldsm_x4(b, vt + (16 * np + 8 * (lane >> 4) + (lane & 7)) * LDV + 16 * kk +
                   8 * ((lane >> 3) & 1));
  }
};

// the same fragments of row-major v (rows keys, columns channels): ldmatrix
// with .trans gives each thread the column pairs of the B layout
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// K7's tiles: one head's [49 x 32] q, k or v as TMA writes it, 64-byte
// rows with the 64-byte swizzle (16-byte chunk c of row r at chunk c ^ ((r
// >> 1) & 3)), each tile 512-byte aligned.  Rows past 48 are never read:
// a fragment row past 48 reads row 48 (a query row there is not stored, a
// key there gets -inf, and its p = 0 meets row 48's finite v).
__device__ __forceinline__ int swz64(int r, int chunk) {
  return r * DH + ((chunk ^ ((r >> 1) & 3)) << 3);
}
struct SwizzledKV {
  const bf16* k;
  const bf16* v;
  __device__ __forceinline__ void k_frag(uint32_t (&b)[4], int n, int lane) const {
    ldsm_x4(b, k + swz64(min(8 * n + (lane & 7), N - 1), lane >> 3));
  }
  __device__ __forceinline__ void v_frag(uint32_t (&b)[4], int np, int kk, int lane) const {
    ldsm_x4_t(b, v + swz64(min(16 * kk + 8 * ((lane >> 3) & 1) + (lane & 7), N - 1),
                           2 * np + (lane >> 4)));
  }
};

// K4's staged tiles (swin_block_attn.cu: attn_win_kernel): k and v
// row-major [16 ceil(W^2 / 16) x LDQ] in shared memory, rows past W^2 zero.
struct RowKV {
  const bf16* k;
  const bf16* v;
  __device__ __forceinline__ void k_frag(uint32_t (&b)[4], int n, int lane) const {
    ldsm_x4(b, k + (8 * n + (lane & 7)) * LDQ + 8 * (lane >> 3));
  }
  __device__ __forceinline__ void v_frag(uint32_t (&b)[4], int np, int kk, int lane) const {
    ldsm_x4_t(b, v + (16 * kk + 8 * ((lane >> 3) & 1) + (lane & 7)) * LDQ +
                     8 * (2 * np + (lane >> 4)));
  }
};

// the score n-tiles of a window of W x W keys (m16n8 tiles, keys in steps
// of 16)
template <int W>
constexpr int SCORE_TILES = 2 * ((W * W + 15) / 16);

// s[n][e] += m[row][col] for the m16n8 accumulator layout (rows r0 and r1,
// columns 8n + 2t + (e & 1)), m [W^2, W^2] fp32 in shared or device memory
// (LDG: read through the read-only cache); columns past W^2 are left as
// they are.  Where every column is a key (window 12) the loads carry no
// per-element branch and go by pairs, so that they issue together.
template <int W, bool LDG>
__device__ __forceinline__ void add_rows(float (&s)[SCORE_TILES<W>][4], const float* m,
                                         int r0, int r1, int t) {
  constexpr int NN = W * W, NT = SCORE_TILES<W>;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* row = m + (h ? r1 : r0) * NN + 8 * n + 2 * t;
      if constexpr (8 * NT == NN) {
        const float2 v = LDG ? __ldg(reinterpret_cast<const float2*>(row))
                             : *reinterpret_cast<const float2*>(row);
        s[n][2 * h] += v.x;
        s[n][2 * h + 1] += v.y;
      } else {
        const int col = 8 * n + 2 * t;
        if (col < NN) s[n][2 * h] += LDG ? __ldg(row) : row[0];
        if (col + 1 < NN) s[n][2 * h + 1] += LDG ? __ldg(row + 1) : row[1];
      }
    }
}

// One head's attention over a W x W window on the tensor cores (mma.sync
// m16n8k16), from q in registers (the A fragments of the score product's
// two k-steps) and the k and v tiles of `kv` (PaddedKV, SwizzledKV or
// RowKV): warp lw owns query rows 16lw .. 16lw + 15 and every key (keys
// past W^2 get -inf); the scores stay in registers, softmax with quad
// shuffles, and the probabilities become the A fragments of P.V directly.
// bh and mk (or null) are the head's bias and the window's mask, [W^2, W^2]
// fp32 (add_rows).  out(acc, qa, qb) gets the fp32 sums of the thread's
// rows qa and qb (qa + 8): acc[n][0..1] of row qa and acc[n][2..3] of row
// qb at columns 8n + 2t, + 1 (t = lane & 3).
template <int W = WIN, bool LDG = false, class KV, class Out>
__device__ __forceinline__ void attend_head(const uint32_t (&a)[2][4], const KV& kv, int lw,
                                            const float* bh, const float* mk, Out out) {
  constexpr int NN = W * W, NT = SCORE_TILES<W>;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qa = 16 * lw + g, qb = qa + 8;
  const int r0 = min(qa, NN - 1), r1 = min(qb, NN - 1);
  float s[NT][4] = {};
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    uint32_t b[4];
    kv.k_frag(b, n, lane);
    mma16816(s[n], a[0], b[0], b[1]);
    mma16816(s[n], a[1], b[2], b[3]);
  }
  // s = round(q k^T * scale) + bias (+ mask), in that order
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = round_bf16(s[n][e] * SCALE);
  add_rows<W, LDG>(s, bh, r0, r1, t);
  if (mk) add_rows<W, LDG>(s, mk, r0, r1, t);
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (8 * NT > NN && 8 * n + 2 * t + (e & 1) >= NN) s[n][e] = -INFINITY;
      if (e < 2) mx0 = fmaxf(mx0, s[n][e]); else mx1 = fmaxf(mx1, s[n][e]);
    }
#pragma unroll
  for (int sh = 1; sh < 4; sh <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, sh));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, sh));
  }
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int n = 0; n < NT; ++n)
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
  for (int kk = 0; kk < NT / 2; ++kk) {
    uint32_t pa[4];
    pa[0] = pack2(div(s[2 * kk][0], sum0, i0), div(s[2 * kk][1], sum0, i0));
    pa[1] = pack2(div(s[2 * kk][2], sum1, i1), div(s[2 * kk][3], sum1, i1));
    pa[2] = pack2(div(s[2 * kk + 1][0], sum0, i0), div(s[2 * kk + 1][1], sum0, i0));
    pa[3] = pack2(div(s[2 * kk + 1][2], sum1, i1), div(s[2 * kk + 1][3], sum1, i1));
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t b[4];  // b0, b1 of channel n-tiles 2np and 2np + 1
      kv.v_frag(b, np, kk, lane);
      mma16816(acc[2 * np], pa, b[0], b[1]);
      mma16816(acc[2 * np + 1], pa, b[2], b[3]);
    }
  }
  out(acc, qa, qb);
}

// K4's and K6's attention: attend_head over PaddedKV (s_k, s_vt in shared
// memory), bh and mk in shared memory; the head's 32 output columns of
// each row r < 49 go to row(r) (a bf16 pointer) when `store`.
template <class Row>
__device__ __forceinline__ void attend_head_wg(const uint32_t (&a)[2][4], const bf16* s_k,
                                               const bf16* s_vt,
                                               const float* bh, const float* mk, Row row,
                                               bool store) {
  attend_head(a, PaddedKV{s_k, s_vt}, (threadIdx.x >> 5) & 3, bh, mk,
              [&](const float (&acc)[4][4], int qa, int qb) {
                if (!store) return;
                const int t = threadIdx.x & 3;
#pragma unroll
                for (int n = 0; n < 4; ++n) {
                  const int c = 8 * n + 2 * t;
                  if (qa < N) st2(row(qa) + c, acc[n][0], acc[n][1]);
                  if (qb < N) st2(row(qb) + c, acc[n][2], acc[n][3]);
                }
              });
}

// The staged designs' window attention: K4's at window 12 and C = 1536
// (swin_block_attn.cu), K6's and K7's there too (window_attn_qkv.cu).
// Block (blockIdx.x, blockIdx.y) = (window, head) copies the head's q, k
// and v rows of its W^2 tokens into shared memory (rows past W^2 zero) from
// three maps of row stride ld, token m's head channels at q + m ld + 32
// head (likewise k, v): the [M, 3C] qkv map of K4's and K6's product is
// (qkv, qkv + C, qkv + 2C, 3C), K7's three [M, C] maps (q, k, v, C).  Warp
// i takes query rows 16i .. 16i + 15 against every key (attend_head), the
// bias and the mask read from device memory (L2); the head's o goes to the
// output map [M, C].  Each source wraps it in a kernel of its own name
// (launch_window_core), so that a profile tells K4's time from K6's and
// K7's.  q, k, v 16-byte aligned, ld a multiple of 8.
template <int W>
constexpr int WIN_THREADS = 32 * ((W * W + 15) / 16);

template <int W>
__device__ __forceinline__ void window_core(const bf16* __restrict__ q,
                                            const bf16* __restrict__ k,
                                            const bf16* __restrict__ v, int ld,
                                            const float* __restrict__ bias,
                                            const float* __restrict__ mask,
                                            bf16* __restrict__ o, int Hp, int Wp, int C) {
  constexpr int NN = W * W, MT = (NN + 15) / 16, NP = 16 * MT;
  __shared__ __align__(16) bf16 s_qkv[3][NP * LDQ];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, head = blockIdx.y;
  const WindowOf<W> w(blockIdx.x, Hp, Wp);
  for (int i = tid; i < NP * 12; i += 32 * MT) {
    const int r = i / 12, part = i % 12 / 4, piece = i % 4;
    const bf16* src = part == 0 ? q : part == 1 ? k : v;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < NN)
      val = __ldg(reinterpret_cast<const uint4*>(src + w.offset(Hp, Wp, ld, r) + head * DH) +
                  piece);
    *reinterpret_cast<uint4*>(s_qkv[part] + r * LDQ + 8 * piece) = val;
  }
  __syncthreads();

  uint32_t a[2][4];  // q's rows, the A fragments of the score product's two k-steps
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
    ldsm_x4(a[ks], s_qkv[0] + (16 * warp + (lane & 15)) * LDQ + 8 * (lane >> 4) + 16 * ks);
  attend_head<W, true>(a, RowKV{s_qkv[1], s_qkv[2]}, warp,
                       bias + static_cast<size_t>(head) * NN * NN,
                       mask ? mask + static_cast<size_t>(w.wmap) * NN * NN : nullptr,
                       [&](const float (&acc)[4][4], int qa, int qb) {
                         const int t = lane & 3;
#pragma unroll
                         for (int n = 0; n < 4; ++n) {
                           const int c = head * DH + 8 * n + 2 * t;
                           if (qa < NN) st2(o + w.offset(Hp, Wp, C, qa) + c, acc[n][0], acc[n][1]);
                           if (qb < NN) st2(o + w.offset(Hp, Wp, C, qb) + c, acc[n][2], acc[n][3]);
                         }
                       });
}

// One launch of window_core<W> by `kernel`, a __global__ wrapper of it
// taking (q, k, v, ld, bias, mask, o, Hp, Wp, C): a block a (window, head)
// over B maps of Hp x Wp
template <int W, class Kernel>
cudaError_t launch_window_core(Kernel kernel, const bf16* q, const bf16* k, const bf16* v,
                               int ld, const void* bias, const void* mask, void* o, int B,
                               int Hp, int Wp, int C, int heads, cudaStream_t st) {
  const dim3 grid(B * (Hp / W) * (Wp / W), heads);
  kernel<<<grid, WIN_THREADS<W>, 0, st>>>(q, k, v, ld, static_cast<const float*>(bias),
                                          static_cast<const float*>(mask),
                                          static_cast<bf16*>(o), Hp, Wp, C);
  return cudaGetLastError();
}

template <int R>
__device__ __forceinline__ void zero(float (&acc)[R]) {
#pragma unroll
  for (int e = 0; e < R; ++e) acc[e] = 0.f;
}

// the block: two consumer warpgroups and one producer warp
constexpr int RING_THREADS = THREADS + 32;
constexpr int MAX_STAGES = 5;

// The mbarriers of the ring kernels: per ring slot full (the producer's
// arrival with the slot's TMA bytes) and empty (the 8 consumer warps'
// arrivals once their products have read it); per attention bias buffer
// full (the producer lanes' copies) and empty (the consumer warps, after
// the round's attention).
struct Bars {
  uint64_t full[MAX_STAGES], empty[MAX_STAGES], bias_full[2], bias_empty[2];
};
static_assert(sizeof(Bars) <= 256, "ring barriers");

// The prologue of a ring kernel: the producer warp's lane 0 initialises
// the mbarriers (and traps unless shared memory starts on 1024 bytes, as
// the swizzled boxes need); the consumers copy the WPB windows' [49, C]
// tiles of x from window win0 on (a window past the last repeats the last)
// into s_a0 [WPB x 49 x lda] and, when mask is given, their masks into
// s_mask0, by cp.async.  Ends in a block barrier.
template <int C, int WPB>
__device__ __forceinline__ void ring_prologue(const unsigned char* smem, Bars* bars, int stages,
                                              const bf16* x, const float* mask, int Hp, int Wp,
                                              int win0, int windows, bf16* s_a0, int lda,
                                              float* s_mask0) {
  const int tid = threadIdx.x;
  if (tid >= THREADS) {
    if (tid == THREADS) {
      if (smem_u32(smem) & 1023) __trap();
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
    for (int i = tid; i < WPB * N * (C / 8); i += THREADS) {
      const int t = i / (N * (C / 8)), r = (i / (C / 8)) % N, piece = i % (C / 8);
      const WindowAt wt(min(win0 + t, windows - 1), Hp, Wp);
      cp_async16(s_a0 + (t * N + r) * lda + 8 * piece, x + wt.offset(Hp, Wp, C, r) + 8 * piece);
    }
    if (mask)
      for (int t = 0; t < WPB; ++t) {
        const WindowAt wt(min(win0 + t, windows - 1), Hp, Wp);
        const float* src = mask + static_cast<size_t>(wt.wmap) * N * N;
        for (int i = tid; i < N * N; i += THREADS) cp_async4(s_mask0 + t * NN_FLOATS + i, src + i);
      }
    cp_async_commit();
    cp_async_wait_all();
  }
  __syncthreads();
}

// The ring's producer, the block's last warp.  Chunk c = (pj, pk) is
// k-chunk pk of round pj's rows of wqkv (per head head0 + pj SPL + s of
// the block, s < SPL, its q, k and v rows: one TMA box of 3 x 32 rows) or,
// for pj >= rounds (K4's out-projection passes, NO > 0 only), of the NO
// SPL rows of wproj of pass pj - rounds from row col0 on (one box); lane 0
// puts it in slot c % stages, rows in that order, once the consumers have
// released the slot's previous chunk.  The warp copies round pj's
// attention biases (SPL heads) into bias buffer pj % NB once round pj -
// NB has released it: with two buffers (SPL 1) with the round's first
// chunk, with one buffer of two heads (SPL 2) with its chunk min(stages,
// nk - 1), when the consumers are past round pj - 1.  With a cluster (CL >
// 1), before the first wproj chunk it arrives on the cluster barrier that
// the consumers wait on before the out-projection.
template <int SPL, int CL, int NO>
__device__ __forceinline__ void ring_producer(Bars* bars, bf16* s_ring, int slot_bytes,
                                              float* s_bias, const float* bias,
                                              const CUtensorMap* tm_q, const CUtensorMap* tm_o,
                                              int head0, int col0, int rounds, int passes,
                                              int kc, int nk, int stages) {
  constexpr int NB = 2 / SPL;  // attention bias buffers, SPL heads each
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(tm_q)) : "memory");
    if constexpr (NO > 0)
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(tm_o)) : "memory");
  }
  const int slot_elems = slot_bytes / static_cast<int>(sizeof(bf16));
  const int n_chunks = (rounds + passes) * nk;
  for (int c = 0; c < n_chunks; ++c) {
    const int pj = c / nk, pk = c % nk, slot = c % stages;
    if (pj < rounds && pk == (NB == 2 ? 0 : min(stages, nk - 1))) {
      const int b = pj % NB;
      if (pj >= NB) mbar_wait(&bars->bias_empty[b], (pj / NB - 1) & 1);
#pragma unroll
      for (int s = 0; s < SPL; ++s) {
        const float* src = bias + static_cast<size_t>(head0 + pj * SPL + s) * N * N;
        float* dst = s_bias + (b * SPL + s) * NN_FLOATS;
        for (int i = lane; i < N * N; i += 32) cp_async4(dst + i, src + i);
      }
      mbar_arrive_cp_async(&bars->bias_full[b]);
    }
    if (CL > 1 && pj == rounds && pk == 0)
      asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    if (c >= stages) mbar_wait(&bars->empty[slot], (c / stages - 1) & 1);
    if (lane == 0) {
      bf16* dst = s_ring + slot * slot_elems;
      uint64_t* full = &bars->full[slot];
      const int k0 = pk * kc;
      if (pj < rounds) {
        mbar_expect(full, slot_bytes);
#pragma unroll
        for (int s = 0; s < SPL; ++s)
          tma_4d(dst + 96 * s * kc, tm_q, k0, 0, head0 + pj * SPL + s, 0, full);
      } else if constexpr (NO > 0) {
        mbar_expect(full, static_cast<int>(sizeof(bf16)) * NO * SPL * kc);
        tma_2d(dst, tm_o, k0, col0 + (pj - rounds) * NO * SPL, full);
      }
    }
    __syncwarp();
  }
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query (no link to libcuda)
using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
inline EncodeFn encode_fn() {
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
inline bool weight_map(CUtensorMap* tm, const void* w, bool qkv, int C, int kc, int box_rows) {
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

// A row-major bf16 matrix [rows, cols] (cols a multiple of 64) as boxes of
// box_rows rows of 64 channels, swizzled by 128 bytes as swz_desc reads
// them; rows past the last read as zeros
inline bool tile_map_2d(CUtensorMap* tm, const void* p, int cols, int rows, int box_rows) {
  EncodeFn encode = encode_fn();
  if (!encode) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * sizeof(bf16)};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(tm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

}  // namespace swin
