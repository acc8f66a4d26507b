// Fused DynamicConv instance interaction (kernel K2).
//
// Replaces: diffusionvid_tpu/ops/dynamic_conv_pallas.py: dynamic_conv_fused
//   (the Pallas kernel _kernel).
//
// Contract, per proposal s of S:
//   a   = roi[s] @ p1t[s]^T             [49, 256] x [64, 256]^T -> [49, 64]
//   x1  = relu(LN64(round(a)))          rounded to the compute dtype
//   c   = x1 @ p2e[s]                   [49, 64] x [64, 256]   -> [49, 256]
//   out = relu(LN256(round(c)))         in the compute dtype
// roi [S, 49, 256], p1t and p2e [S, 64, 256] (e-major), float32 or bfloat16;
// LayerNorm weights and biases float32; products accumulate in fp32 and are
// rounded to the compute dtype before each fp32 LayerNorm, as in
// models/heads.py: DynamicConv and the Pallas kernel.
//
// What bounds it on an H100: bytes.  At the flagship shape (S = 2400 = 8
//   frames x 300 proposals, bf16) the least traffic is one read of roi, p1t,
//   p2e and one write of the output, 278 MB or 83 us at 3.35 TB/s; the two
//   products are 7.7 GFLOP, 8 us at the bf16 tensor-core rate.
//
// Design "ring" (bf16, the main path): one launch a call, persistent
//   blocks, whole proposals streamed through a ring.  A block is one
//   producer warp and two consumer warpgroups (swin::RING_THREADS); the grid
//   is about one block an SM, and block b takes proposals b, b + grid, ...,
//   its warpgroup g every other one of them from its g-th on.  The ring
//   holds `stages` proposals (two: 96 KB each), each in two parts with
//   their own full/empty mbarriers: A, roi's four boxes of 49 rows x 64
//   channels (each in a slot of 64 rows; rows 49-63 pad the m64 product and
//   are never stored) and p1t's four boxes of 64 x 64; B, p2e's four boxes
//   of 64 x 64.  The producer's lane 0 loads the A parts and lane 1 the B
//   parts by TMA with the 128-byte swizzle, each as soon as its slot is
//   free.  A warpgroup frees A after the first product, so the next
//   proposal's roi and p1t land while it finishes this one, and B after
//   the output has left it.  Per proposal, on the warpgroup's 64 rows:
//   a = roi p1t^T by wgmma m64n64k16 with both operands in shared memory
//   (16 k-steps); LN64, ReLU and the roundings on the accumulators, a
//   row's 64 columns in the 4 lanes of a quad (two shuffles a sum); x1's
//   registers are then the A fragments of c = x1 p2e, wgmma m64n256k16
//   with B read MN-major (p2e is e-major: N contiguous) through its own
//   descriptor (mn_desc); LN256, ReLU and the roundings on the 128
//   accumulators a thread holds; the 49 valid rows go back over p2e's
//   slot, in the swizzled layout of the output's TMA boxes (conflict-free:
//   the 8 rows of a fragment store hit 8 different 16-byte chunks), and
//   leave by four TMA stores.  Each product sums in fp32 and is rounded to
//   bf16; the LayerNorms are two-pass fp32 with 1 / sqrtf(var + eps), as
//   in the first design.  The launch plan (ops/dynamic_conv.py:
//   dynconv_plan, checked below against the layout) gives the grid, the
//   ring's depth and the shared bytes: stages x 96 KB of ring, 2,560 of
//   LayerNorm weights and 256 of mbarriers.  Known limit: at 288 threads
//   ptxas gives a thread 168 registers; the 128 accumulators of the second
//   product and x1's 16 fragment registers then leave too few, so ptxas
//   serialises the wgmma instructions and spills about 100 bytes.  Staging
//   x1 in shared memory for an SS product spilled more and ran slower.
//   The numbers' source: chip_smoke.py (the K2 rows) and utils/k2_bench.py.
//
// Design "v1" (fp32, and bf16 only where utils/k2_bench.py asks for it):
//   one block of 256 threads per proposal.  The block stages roi, p1t
//   and p2e in dynamic shared memory (103 KB in bf16, 194 KB in fp32), so
//   device memory sees each input once and the output once.  The first
//   product gives each thread one e column and every fourth pooled row
//   (13 accumulators); p1t's rows are padded by one 4-byte word so the 32
//   lanes of a warp, which read 32 different rows, hit 32 banks.  The
//   64-wide LayerNorm runs one warp per row with shuffle reductions.  The
//   second product gives each thread one output channel and all 49 rows in
//   registers; its rounded result is staged in shared memory over the
//   roi/p1t region, which is dead by then, for the 256-wide LayerNorm.  The
//   products run on the fp32 CUDA cores (tf32 wgmma would round the inputs
//   and takes K-major operands only), bound by shared-memory reads and fp32
//   issue rather than by device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "swin_hopper.cuh"

namespace {

constexpr int P = 49;         // pooled positions
constexpr int E = 64;         // dynamic dim
constexpr int D = 256;        // hidden dim
constexpr int THREADS = 256;  // == D
constexpr int ROWS1 = (P + 3) / 4;  // first-product rows per thread

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// round an fp32 value to the compute dtype and back
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float2 load2(const float* p) { return make_float2(p[0], p[1]); }
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
struct Smem {
  static constexpr int PAD = 4 / sizeof(T);  // one 4-byte word per p1t row
  static constexpr int LD1 = D + PAD;
  static constexpr size_t ROI = 0;
  static constexpr size_t P1 = ROI + sizeof(T) * P * D;
  static constexpr size_t P2 = P1 + sizeof(T) * E * LD1;
  static constexpr size_t X1 = P2 + sizeof(T) * E * D;
  static constexpr size_t BYTES = X1 + sizeof(float) * P * E;
  static_assert(sizeof(float) * P * D <= P2, "staged output must fit over roi/p1t");
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
dynamic_conv_kernel(const T* __restrict__ roi, const T* __restrict__ p1t,
                    const T* __restrict__ p2e, const float* __restrict__ g1,
                    const float* __restrict__ b1, const float* __restrict__ g2,
                    const float* __restrict__ b2, T* __restrict__ out, float eps) {
  using L = Smem<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_roi = reinterpret_cast<T*>(smem + L::ROI);
  T* s_p1 = reinterpret_cast<T*>(smem + L::P1);
  T* s_p2 = reinterpret_cast<T*>(smem + L::P2);
  float* s_x1 = reinterpret_cast<float*>(smem + L::X1);
  float* s_out = reinterpret_cast<float*>(smem + L::ROI);  // over roi/p1t

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t s = blockIdx.x;

  // ---- stage the proposal's operands (16-byte copies; p1t by 4-byte words
  // into padded rows)
  {
    const uint4* src = reinterpret_cast<const uint4*>(roi + s * P * D);
    uint4* dst = reinterpret_cast<uint4*>(s_roi);
    for (int i = tid; i < (int)(sizeof(T) * P * D / 16); i += THREADS) dst[i] = src[i];
    src = reinterpret_cast<const uint4*>(p2e + s * E * D);
    dst = reinterpret_cast<uint4*>(s_p2);
    for (int i = tid; i < (int)(sizeof(T) * E * D / 16); i += THREADS) dst[i] = src[i];
    constexpr int WD = sizeof(T) * D / 4;      // words per p1t row
    constexpr int WD1 = sizeof(T) * L::LD1 / 4;  // padded
    const uint32_t* w_src = reinterpret_cast<const uint32_t*>(p1t + s * E * D);
    uint32_t* w_dst = reinterpret_cast<uint32_t*>(s_p1);
    for (int i = tid; i < E * WD; i += THREADS) w_dst[(i / WD) * WD1 + i % WD] = w_src[i];
  }
  __syncthreads();

  // ---- a = roi @ p1t^T: thread -> (e, rows pg, pg+4, ...)
  {
    const int e = tid % E, pg = tid / E;
    float acc[ROWS1];
#pragma unroll
    for (int j = 0; j < ROWS1; ++j) acc[j] = 0.f;
    const T* w_row = s_p1 + e * L::LD1;
    for (int d = 0; d < D; d += 2) {
      const float2 w = load2(w_row + d);
#pragma unroll
      for (int j = 0; j < ROWS1; ++j) {
        const int p = pg + 4 * j;
        if (p < P) {
          const float2 a = load2(s_roi + p * D + d);
          acc[j] = fmaf(a.x, w.x, acc[j]);
          acc[j] = fmaf(a.y, w.y, acc[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < ROWS1; ++j) {
      const int p = pg + 4 * j;
      if (p < P) s_x1[p * E + e] = round_to<T>(acc[j]);
    }
  }
  __syncthreads();

  // ---- x1 = relu(LN64(a)), rounded; one warp per row
  {
    const float ga = g1[lane], gb = g1[lane + 32];
    const float ba = b1[lane], bb = b1[lane + 32];
    for (int p = warp; p < P; p += THREADS / 32) {
      const float v0 = s_x1[p * E + lane], v1 = s_x1[p * E + lane + 32];
      const float mu = warp_sum(v0 + v1) / E;
      const float d0 = v0 - mu, d1 = v1 - mu;
      const float var = warp_sum(d0 * d0 + d1 * d1) / E;
      const float inv = 1.f / sqrtf(var + eps);
      s_x1[p * E + lane] = round_to<T>(fmaxf(d0 * inv * ga + ba, 0.f));
      s_x1[p * E + lane + 32] = round_to<T>(fmaxf(d1 * inv * gb + bb, 0.f));
    }
  }
  __syncthreads();

  // ---- c = x1 @ p2e: thread -> output channel tid, all 49 rows
  {
    float acc[P];
#pragma unroll
    for (int p = 0; p < P; ++p) acc[p] = 0.f;
    for (int e = 0; e < E; ++e) {
      const float w = to_f(s_p2[e * D + tid]);
#pragma unroll
      for (int p = 0; p < P; ++p) acc[p] = fmaf(s_x1[p * E + e], w, acc[p]);
    }
    // s_out overlays roi/p1t, which no thread reads after the first product
#pragma unroll
    for (int p = 0; p < P; ++p) s_out[p * D + tid] = round_to<T>(acc[p]);
  }
  __syncthreads();

  // ---- out = relu(LN256(c)); one warp per row, lane owns channels lane + 32k
  {
    constexpr int K = D / 32;
    float g[K], bt[K];
#pragma unroll
    for (int k = 0; k < K; ++k) { g[k] = g2[lane + 32 * k]; bt[k] = b2[lane + 32 * k]; }
    T* o = out + s * P * D;
    for (int p = warp; p < P; p += THREADS / 32) {
      float v[K], sum = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) { v[k] = s_out[p * D + lane + 32 * k]; sum += v[k]; }
      const float mu = warp_sum(sum) / D;
      float sq = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) { v[k] -= mu; sq += v[k] * v[k]; }
      const float inv = 1.f / sqrtf(warp_sum(sq) / D + eps);
#pragma unroll
      for (int k = 0; k < K; ++k)
        o[p * D + lane + 32 * k] = from_f<T>(fmaxf(v[k] * inv * g[k] + bt[k], 0.f));
    }
  }
}

template <typename T>
cudaError_t launch(const void* roi, const void* p1t, const void* p2e,
                   const void* g1, const void* b1, const void* g2,
                   const void* b2, void* out, int S, float eps,
                   cudaStream_t st) {
  const size_t bytes = Smem<T>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      dynamic_conv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dynamic_conv_kernel<T><<<S, THREADS, bytes, st>>>(
      static_cast<const T*>(roi), static_cast<const T*>(p1t),
      static_cast<const T*>(p2e), static_cast<const float*>(g1),
      static_cast<const float*>(b1), static_cast<const float*>(g2),
      static_cast<const float*>(b2), static_cast<T*>(out), eps);
  return cudaGetLastError();
}


// ---------------------------------------------------------------- design "ring" (bf16)

namespace ring {

using bf16 = __nv_bfloat16;
using swin::smem_u32;

constexpr int KB = D / 64;                      // boxes of 64 channels a row
constexpr int BOX = 64 * 64 * 2;                // a box's slot: 64 rows of 128 bytes
constexpr int OPERAND = KB * BOX;               // one operand's four slots, 32 KB
constexpr int A_BYTES = 2 * OPERAND;            // part A: roi | p1t
constexpr int B_BYTES = OPERAND;                // part B: p2e, then the output
constexpr int A_TX = KB * (P + E) * 128;        // the bytes A's eight boxes bring
constexpr int B_TX = KB * E * 128;
constexpr int LN_FLOATS = 2 * E + 2 * D;        // g1 | b1 | g2 | b2
constexpr int BAR_BYTES = 256;
constexpr int MAX_STAGES = 4;
constexpr int SMEM_LIMIT = 232448;              // a block's shared memory on sm_90

constexpr int smem_bytes(int stages) {
  return stages * (A_BYTES + B_BYTES) + LN_FLOATS * 4 + BAR_BYTES;
}

struct Bars {
  uint64_t full_a[MAX_STAGES], empty_a[MAX_STAGES], full_b[MAX_STAGES], empty_b[MAX_STAGES];
};
static_assert(sizeof(Bars) <= BAR_BYTES, "ring barriers");

// descriptor of an MN-major bf16 operand [k rows, N] that TMA wrote as
// boxes of 64 N-columns (one 8 KB slot each, rows of 128 bytes, 128-byte
// swizzle): 64-column blocks BOX bytes apart (leading offset), 8-row
// groups of k 1,024 bytes apart (stride offset); a k-step of 16 rows adds
// 2,048 bytes to the address
__device__ __forceinline__ uint64_t mn_desc(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(BOX >> 4) << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

// D[64 x 256] += A B: A in registers (the m16n8k16 A fragment, each warp
// its 16 rows), B [16 x 256] MN-major in shared memory (mn_desc)
__device__ __forceinline__ void wgmma_rs_n256_mn(float (&d)[128], const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95,%96,%97,%98,%99,%100,%101,%102,%103,%104,%105,%106,%107,%108,%109,%110,%111,%112,%113,%114,%115,%116,%117,%118,%119,%120,%121,%122,%123,%124,%125,%126,%127}, {%128,%129,%130,%131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// the box of tensor map tm at (c0, c1) from shared memory to device memory
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* tm, const void* src, int c0,
                                             int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
               ::"l"(reinterpret_cast<uint64_t>(tm)), "r"(smem_u32(src)), "r"(c0), "r"(c1)
               : "memory");
}

// byte offset of element (r, c) in four swizzled boxes of 64 columns (the
// layout TMA reads and writes with the 128-byte swizzle)
__device__ __forceinline__ int swz_off(int r, int c) {
  return (c >> 6) * BOX + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) + (c & 7) * 2;
}

// relu(LN(v)) of the two rows a thread holds a part of, in place, rounded
// to bf16: acc[4 j + 2 hh + i] is row r0 + 8 hh, column 8 j + 2 t + i, and
// a row's columns lie in the four lanes of a quad.  v is rounded first (the
// product's rounding point); the variance is two-pass, as in design v1.
template <int NJ>
__device__ __forceinline__ void ln_relu_rows(float (&acc)[4 * NJ], const float* g, const float* b,
                                             float eps) {
  constexpr float INV_N = 1.f / (8 * NJ);
  const int t = threadIdx.x & 3;
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4 * NJ; ++i) {
    acc[i] = swin::round_bf16(acc[i]);
    sum[(i >> 1) & 1] += acc[i];
  }
  float mu[2], sq[2] = {0.f, 0.f}, inv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 1);
    sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 2);
    mu[hh] = sum[hh] * INV_N;
  }
#pragma unroll
  for (int i = 0; i < 4 * NJ; ++i) {
    const float d = acc[i] - mu[(i >> 1) & 1];
    acc[i] = d;
    sq[(i >> 1) & 1] += d * d;
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    sq[hh] += __shfl_xor_sync(0xffffffffu, sq[hh], 1);
    sq[hh] += __shfl_xor_sync(0xffffffffu, sq[hh], 2);
    inv[hh] = 1.f / sqrtf(sq[hh] * INV_N + eps);
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const float2 gg = *reinterpret_cast<const float2*>(g + 8 * j + 2 * t);
    const float2 bb = *reinterpret_cast<const float2*>(b + 8 * j + 2 * t);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float* v = acc + 4 * j + 2 * hh;
      v[0] = swin::round_bf16(fmaxf(v[0] * inv[hh] * gg.x + bb.x, 0.f));
      v[1] = swin::round_bf16(fmaxf(v[1] * inv[hh] * gg.y + bb.y, 0.f));
    }
  }
}

// The persistent kernel (the design in the header).
__global__ void __launch_bounds__(swin::RING_THREADS, 1)
dynconv_ring_kernel(const __grid_constant__ CUtensorMap tm_roi,
                    const __grid_constant__ CUtensorMap tm_p1,
                    const __grid_constant__ CUtensorMap tm_p2,
                    const __grid_constant__ CUtensorMap tm_out, const float* __restrict__ g1,
                    const float* __restrict__ b1, const float* __restrict__ g2,
                    const float* __restrict__ b2, int S, int stages, float eps) {
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* a_ring = smem;
  unsigned char* b_ring = smem + stages * A_BYTES;
  float* s_ln = reinterpret_cast<float*>(b_ring + stages * B_BYTES);
  Bars* bars = reinterpret_cast<Bars*>(s_ln + LN_FLOATS);
  const int tid = threadIdx.x, lane = tid & 31;
  const int grid = gridDim.x;
  const int n = (S - static_cast<int>(blockIdx.x) + grid - 1) / grid;  // this block's proposals
  if (tid == swin::THREADS) {
    if (smem_u32(smem) & 1023) __trap();  // the swizzled boxes need 1024-byte slots
    for (int s = 0; s < stages; ++s) {
      swin::mbar_init(&bars->full_a[s], 1);
      swin::mbar_init(&bars->empty_a[s], 4);  // the warpgroup's 4 warps
      swin::mbar_init(&bars->full_b[s], 1);
      swin::mbar_init(&bars->empty_b[s], 1);  // the thread that stores the output
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < LN_FLOATS; i += swin::RING_THREADS)
    s_ln[i] = i < E ? g1[i] : i < 2 * E ? b1[i - E] : i < 2 * E + D ? g2[i - 2 * E]
                                                                  : b2[i - 2 * E - D];
  __syncthreads();

  if (tid >= swin::THREADS) {  // the producer warp: lane 0 the A parts, lane 1 the B parts
    if (lane < 2) {
      const CUtensorMap* first = lane == 0 ? &tm_roi : &tm_p2;
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(first))
                   : "memory");
      if (lane == 0)
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_p1))
                     : "memory");
      for (int j = 0; j < n; ++j) {
        const int slot = j % stages, s = blockIdx.x + j * grid;
        if (lane == 0) {
          if (j >= stages) swin::mbar_wait(&bars->empty_a[slot], (j / stages - 1) & 1);
          unsigned char* dst = a_ring + slot * A_BYTES;
          swin::mbar_expect(&bars->full_a[slot], A_TX);
#pragma unroll
          for (int kb = 0; kb < KB; ++kb) {
            swin::tma_2d(dst + kb * BOX, &tm_roi, 64 * kb, s * P, &bars->full_a[slot]);
            swin::tma_2d(dst + OPERAND + kb * BOX, &tm_p1, 64 * kb, s * E, &bars->full_a[slot]);
          }
        } else {
          if (j >= stages) swin::mbar_wait(&bars->empty_b[slot], (j / stages - 1) & 1);
          unsigned char* dst = b_ring + slot * B_BYTES;
          swin::mbar_expect(&bars->full_b[slot], B_TX);
#pragma unroll
          for (int kb = 0; kb < KB; ++kb)
            swin::tma_2d(dst + kb * BOX, &tm_p2, 64 * kb, s * E, &bars->full_b[slot]);
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg takes this block's proposals wg, wg + 2, ...
  const int wg = tid >> 7, wt = tid & 127, warp = (tid >> 5) & 3;
  const int g = lane >> 2;
  const float* s_g1 = s_ln;
  const float* s_b1 = s_ln + E;
  const float* s_g2 = s_ln + 2 * E;
  const float* s_b2 = s_ln + 2 * E + D;
  for (int j = wg; j < n; j += 2) {
    const int slot = j % stages, phase = (j / stages) & 1, s = blockIdx.x + j * grid;
    const unsigned char* a_slot = a_ring + slot * A_BYTES;
    unsigned char* b_slot = b_ring + slot * B_BYTES;

    // a = roi p1t^T: 4 boxes of 4 k-steps, both operands K-major
    float a[32];
    swin::zero(a);
    swin::mbar_wait(&bars->full_a[slot], phase);
    swin::wg_fence();
#pragma unroll
    for (int kb = 0; kb < KB; ++kb) {
      const uint64_t da = swin::swz_desc(reinterpret_cast<const bf16*>(a_slot + kb * BOX), 64);
      const uint64_t db =
          swin::swz_desc(reinterpret_cast<const bf16*>(a_slot + OPERAND + kb * BOX), 64);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) swin::wgmma_ss_n64(a, da + 2 * ks, db + 2 * ks);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    swin::keep(a);
    __syncwarp();
    if (lane == 0) swin::mbar_arrive(&bars->empty_a[slot]);

    // x1 = round(relu(LN64(round(a)))), kept as the A fragments of the
    // second product: k-step ks is columns 16 ks .. 16 ks + 15
    ln_relu_rows<8>(a, s_g1, s_b1, eps);
    uint32_t xa[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      xa[ks][0] = swin::pack2(a[8 * ks + 0], a[8 * ks + 1]);
      xa[ks][1] = swin::pack2(a[8 * ks + 2], a[8 * ks + 3]);
      xa[ks][2] = swin::pack2(a[8 * ks + 4], a[8 * ks + 5]);
      xa[ks][3] = swin::pack2(a[8 * ks + 6], a[8 * ks + 7]);
    }

    // c = x1 p2e: p2e [64 (k), 256 (n)] MN-major in B's slot
    float c[128];
    swin::zero(c);
    swin::mbar_wait(&bars->full_b[slot], phase);
    swin::wg_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma_rs_n256_mn(c, xa[ks], mn_desc(b_slot + ks * 2048));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    swin::keep(xa);
    swin::keep(c);

    // out = round(relu(LN256(round(c)))), staged over p2e once every warp
    // of the warpgroup is past its product, then four TMA stores
    ln_relu_rows<32>(c, s_g2, s_b2, eps);
    swin::wg_sync(wg);
    {
      const int r0 = 16 * warp + g, cq = 2 * (lane & 3);
#pragma unroll
      for (int jn = 0; jn < 32; ++jn)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<__nv_bfloat162*>(b_slot + swz_off(r0 + 8 * hh, 8 * jn + cq)) =
              __floats2bfloat162_rn(c[4 * jn + 2 * hh], c[4 * jn + 2 * hh + 1]);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    swin::wg_sync(wg);
    if (wt == 0) {
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) tma_store_2d(&tm_out, b_slot + kb * BOX, 64 * kb, s * P);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      swin::mbar_arrive(&bars->empty_b[slot]);
    }
  }
  if (wt == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// the plan (ops/dynamic_conv.py: dynconv_plan) against the layout
bool plan_ok(int S, int grid, int stages, int smem) {
  return grid >= 1 && grid <= S && stages >= 2 && stages <= MAX_STAGES &&
         smem == smem_bytes(stages) && smem <= SMEM_LIMIT;
}

cudaError_t launch(const void* roi, const void* p1t, const void* p2e, const void* g1,
                   const void* b1, const void* g2, const void* b2, void* out, int S, float eps,
                   int grid, int stages, int smem, cudaStream_t st) {
  CUtensorMap tm_roi, tm_p1, tm_p2, tm_out;
  if (!swin::tile_map_2d(&tm_roi, roi, D, S * P, P) ||
      !swin::tile_map_2d(&tm_p1, p1t, D, S * E, E) ||
      !swin::tile_map_2d(&tm_p2, p2e, D, S * E, E) ||
      !swin::tile_map_2d(&tm_out, out, D, S * P, P))
    return cudaErrorNotSupported;
  cudaError_t err = cudaFuncSetAttribute(dynconv_ring_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dynconv_ring_kernel<<<grid, swin::RING_THREADS, smem, st>>>(
      tm_roi, tm_p1, tm_p2, tm_out, static_cast<const float*>(g1),
      static_cast<const float*>(b1), static_cast<const float*>(g2),
      static_cast<const float*>(b2), S, stages, eps);
  return cudaGetLastError();
}

}  // namespace ring

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16.  Launches on `stream`; returns the
// launch's cudaGetLastError().
extern "C" int dynamic_conv_fwd(const void* roi, const void* p1t, const void* p2e,
                                const void* g1, const void* b1, const void* g2,
                                const void* b2, void* out, int S, float eps,
                                int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1
      ? launch<__nv_bfloat16>(roi, p1t, p2e, g1, b1, g2, b2, out, S, eps, st)
      : launch<float>(roi, p1t, p2e, g1, b1, g2, b2, out, S, eps, st);
  return static_cast<int>(err);
}

// The ring design (bf16): roi [S, 49, 256], p1t and p2e [S, 64, 256], out
// [S, 49, 256], 16-byte aligned; (grid, stages, smem) the plan of
// ops/dynamic_conv.py: dynconv_plan, checked against the layout
// (cudaErrorInvalidValue otherwise).  Launches on `stream`; returns the
// launch's cudaGetLastError().
extern "C" int dynamic_conv_ring(const void* roi, const void* p1t, const void* p2e,
                                 const void* g1, const void* b1, const void* g2,
                                 const void* b2, void* out, int S, float eps, int grid,
                                 int stages, int smem, void* stream) {
  if (!ring::plan_ok(S, grid, stages, smem)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(ring::launch(roi, p1t, p2e, g1, b1, g2, b2, out, S, eps, grid,
                                       stages, smem, static_cast<cudaStream_t>(stream)));
}
