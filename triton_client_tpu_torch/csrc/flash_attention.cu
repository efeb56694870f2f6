// Forward flash attention for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel triton_client_tpu/ops/flash_attention.py
// (_flash_call, pl.pallas_call at :140, body _kernel :50-103): forward
// softmax(q k^T * scale + mask) v over [B, H, S, D], online softmax state
// (m, l, acc) in f32, padded keys and (causal) keys after the query masked,
// fully masked rows zeroed (p = 0, never exp(0)), the causal early exit over
// key tiles, and the output acc / max(l, 1e-30) cast to the input type.
//
// What bounds it on the H100.  At the serving shape (B*H = 64, S = 4096,
// D = 64, causal) the work is 4 * B*H * D * S(S+1)/2 = 137 GFLOP against
// 4 * B*H*S*D*2 = 134 MB of q, k, v and o, so operations bound it, on two
// units: the tensor cores (0.139 ms at 989 TFLOP/s) and, at D = 64, the exp
// unit -- B*H*S(S+1)/2 = 537 M exponentials at 16 per clock per SM take
// 0.128 ms at 1.98 GHz on 132 SMs.  Each score also costs about four other
// instructions (max, FFMA, sum, and half each of a bf16 pack and an output
// rescale), so neither unit is kept busy unless the softmax of one tile
// runs while the tensor cores work on another.
//
// Design, bf16 (the shape of FlashAttention-3):
//  * Persistent: one block per SM walks work tiles (b*h, query tile) in a
//    fixed order, the longest causal tiles first.  A block is one producer
//    warpgroup and kWG consumer warpgroups of 64 query rows each: three at
//    D <= 64 (192-query tiles), two at D = 128, where the output
//    accumulator alone takes 64 registers a thread.
//  * The producer gives its registers up (setmaxnreg.dec) and one thread
//    issues TMA loads: q tiles into two buffers, K and V tiles of 128 keys
//    into a ring of stages, each guarded by "full" and "empty" mbarriers.
//    Ring and buffers run on from one work tile to the next, so the next
//    tile's loads overlap this one's last products and epilogue.  The
//    tensor maps are 3-D (D, S, b*h): a ragged tile is zero-filled within
//    its head and never reads the next head's rows.
//  * Consumers (setmaxnreg.inc): S = q K^T is wgmma m64n128k16 with q and
//    K read from shared memory through descriptors whose swizzle matches
//    the TMA box (128-byte rows at D = 64, 32- and 64-byte swizzles at
//    D = 16 and 32, two 128-byte column blocks at D = 128).  O += P V is
//    wgmma with P from registers -- the f32 score accumulator re-packed as
//    the bf16 A fragment -- and V read MN-major straight from its TMA tile
//    with the transpose bit, so no thread stages or transposes V.
//  * Overlap: each consumer issues the q K^T of the next key tile together
//    with the P V of the current one and runs the next softmax while P V is
//    on the tensor cores; the consumers take turns to issue (named
//    barriers), so one's products run while the others do softmax.
//  * Softmax: row max of the raw scores, then p = exp2(s c - max c) with
//    c = scale * log2(e) > 0 in one FFMA and one ex2.approx.  Only the key
//    tiles that cross a warpgroup's diagonal or the end of the sequence
//    are masked; the others take the unmasked body.  Row max within each
//    4-lane group of the accumulator layout; row sums stay per thread until
//    the epilogue.
//  * f32: one thread per query row, key tiles of 32 staged in shared memory
//    as f32, scalar FMAs.  It keeps full f32 math for callers that run the
//    model in f32; it is not on the bf16 serving path.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// Hopper primitives: mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// arrive once and expect `bytes` from TMA before the phase completes
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// wait until the barrier's phase with the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// one box of a 3-D tensor map into shared memory, completion on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// named barriers 1..3: the turn to issue wgmma passes from one consumer
// warpgroup to the next
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// keep the compiler from moving register accesses across a wgmma boundary
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

// d (+)= A B for a 64 x 128 tile, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B for a 64 x N tile: A (16 columns) from registers, B MN-major in
// shared memory (the transpose bit)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                          const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                          const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                          const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                          const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---------------------------------------------------------------------------
// bf16 path: TMA producer, wgmma consumer warpgroups, persistent blocks
// ---------------------------------------------------------------------------

constexpr int kBlockN = 128;  // keys per tile

// Tiles and resources of one instantiation: head dim D, kWG consumer
// warpgroups of 64 query rows each.  Registers set the shape: three
// consumers at 160 registers (D <= 64: 64 for the scores, 32 for P, 32 for
// the output) or two at 232 (D = 128: the output alone takes 64), and the
// producer warpgroup gives up the rest (128 x 32 + 384 x 160 and
// 128 x 40 + 256 x 232 both fit the SM's 65,536).
template <int D, int kWG>
struct Tiles {
  static constexpr int kD = D;
  static constexpr int kConsumers = kWG;
  static constexpr int kThreads = 128 * (kWG + 1);
  static constexpr int kProducerRegs = kWG == 3 ? 32 : 40;
  static constexpr int kConsumerRegs = kWG == 3 ? 160 : 232;
  static constexpr int kBlockM = 64 * kWG;  // query rows per work tile
  // swizzle span = bytes of one row of a column block of a tile
  static constexpr int kSw = D * 2 < 128 ? D * 2 : 128;
  static constexpr int kCols = D * 2 / kSw;  // column blocks (2 at D = 128)
  static constexpr int kColBytes = kBlockN * kSw;     // of a K or V tile
  static constexpr int kQColBytes = kBlockM * kSw;    // of a q tile
  static constexpr int kTileBytes = kBlockN * D * 2;  // K or V tile
  static constexpr int kQBytes = kBlockM * D * 2;
  static constexpr int kStages = D == 128 ? 2 : 4;    // K+V ring
  // wgmma descriptor layout: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte swizzle
  static constexpr uint64_t kMode = kSw == 128 ? 1 : kSw == 64 ? 2 : 3;
  // 1024 to align the base to the swizzle pattern; two q tiles; the ring;
  // the mbarriers
  static constexpr int kSmemBytes = 1024 + 2 * kQBytes +
                                    2 * kStages * kTileBytes +
                                    8 * (2 * kStages + 4);
  // byte offset of the k16 step kk within a K-major tile whose column
  // blocks are col_bytes apart
  static __device__ __forceinline__ uint32_t k_step(int kk, int col_bytes) {
    return kk * 32 / kSw * col_bytes + kk * 32 % kSw;
  }
};

template <int D>
using TilesFor = Tiles<D, D == 128 ? 2 : 3>;

// shared-memory matrix descriptor: start address, leading and stride byte
// offsets (the stride between 8-row groups is 8 rows of kSw bytes)
template <class T>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(8 * T::kSw >> 4) << 32 | T::kMode << 62;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// mask a score tile if kMask and fold it into the running row max of this
// thread's two rows (raw scores: the scale, > 0, is applied in the exp)
template <bool kMask>
__device__ __forceinline__ void mask_max(float (&s)[64], float (&mx)[2],
                                         int col0, int r0, int S,
                                         int causal) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (kMask) {
        const int col = col0 + 8 * j + (e & 1);
        if (col >= S || (causal && col > r0 + 8 * (e >> 1)))
          s[4 * j + e] = -INFINITY;
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
    }
  }
}

// Online softmax of one masked score tile: the new row max, p =
// exp2(s c - max c) in place (one FFMA and one ex2 per score), the
// per-thread row sums, and the factor that rescales what was accumulated
// under the old max.
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&mx)[2],
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2], float c) {
  float base[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    // a row with no valid key so far keeps p = 0 (exp2(-inf)), never exp(0)
    base[i] = mx[i] == -INFINITY ? 0.f : mx[i] * c;
    corr[i] = ex2(m[i] * c - base[i]);
    m[i] = mx[i];
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(fmaf(s[4 * j + e], c, -base[e >> 1]));
      s[4 * j + e] = p;
      rs[e >> 1] += p;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + rs[i];
}

// the f32 probabilities as the bf16 A fragments of the 8 k16 steps of P V
__device__ __forceinline__ void pack_p(const float (&s)[64],
                                       uint32_t (&pa)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <int D>
__device__ __forceinline__ void rescale(float (&acc)[D / 2],
                                        const float (&corr)[2]) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    acc[4 * j + 0] *= corr[0];
    acc[4 * j + 1] *= corr[0];
    acc[4 * j + 2] *= corr[1];
    acc[4 * j + 3] *= corr[1];
  }
}

// S = q K^T of one key tile into s (q and K K-major in shared memory)
template <class T>
__device__ __forceinline__ void issue_qk(float (&s)[64], uint32_t q_at,
                                         uint32_t k_at) {
  pin(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < T::kD / 16; ++kk)
    wgmma_ss_n128(s, smem_desc<T>(q_at + T::k_step(kk, T::kQColBytes), 16),
                  smem_desc<T>(k_at + T::k_step(kk, T::kColBytes), 16), kk);
  wgmma_commit();
}

// acc += P V of one key tile (P in registers, V MN-major in shared memory;
// the leading byte offset steps between V's column blocks at D = 128)
template <class T>
__device__ __forceinline__ void issue_pv(float (&acc)[T::kD / 2],
                                         uint32_t (&pa)[8][4],
                                         uint32_t v_at) {
  pin(acc);
  pin(pa);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_rs<T::kD>(acc, pa[kk],
                    smem_desc<T>(v_at + kk * 16 * T::kSw, T::kColBytes));
  wgmma_commit();
}

// Work item i of a call: query tile n_qt - 1 - i / bh (the longest causal
// tiles first) of head i % bh, and its number of key tiles.
struct WorkTile {
  int q0, bh, n_kb;
};

template <class T>
__device__ __forceinline__ WorkTile work_tile(int i, int bh, int S,
                                              int causal) {
  const int n_qt = (S + T::kBlockM - 1) / T::kBlockM;
  const int n_kt = (S + kBlockN - 1) / kBlockN;
  WorkTile w;
  w.q0 = (n_qt - 1 - i / bh) * T::kBlockM;
  w.bh = i % bh;
  w.n_kb = causal ? min(n_kt, (w.q0 + T::kBlockM - 1) / kBlockN + 1) : n_kt;
  return w;
}

// One persistent block per SM walks the work tiles i = blockIdx.x,
// blockIdx.x + gridDim.x, ...; the K/V ring and the two q buffers carry on
// from one tile to the next, so the producer loads the next tile while the
// consumers finish this one.
template <class T>
__global__ void __launch_bounds__(T::kThreads, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               __nv_bfloat16* __restrict__ out, int bh, int S, float c,
               int causal) {
  constexpr int D = T::kD;
  constexpr int kConsumerThreads = 128 * T::kConsumers;
  extern __shared__ uint8_t smem[];
  const uint32_t sq = (smem_addr(smem) + 1023) & ~1023u;  // two q tiles
  const uint32_t ring = sq + 2 * T::kQBytes;  // stage s: K, then V
  const uint32_t full = ring + 2 * T::kStages * T::kTileBytes;
  const uint32_t empty = full + 8 * T::kStages;
  const uint32_t q_full = empty + 8 * T::kStages;  // per q buffer
  const uint32_t q_empty = q_full + 16;
  const int n_work = (S + T::kBlockM - 1) / T::kBlockM * bh;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerThreads);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(q_full + 8 * b, 1);
      mbar_init(q_empty + 8 * b, kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread keeps the q buffers and the K/V ring full, key
    // tiles of each work tile from the last (diagonal or ragged) down
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(T::kProducerRegs));
    if (threadIdx.x == 0) {
      int it = 0;  // K/V tiles loaded by this block
      int n = 0;   // work tiles started by this block
      for (int i = blockIdx.x; i < n_work; i += gridDim.x, ++n) {
        const WorkTile w = work_tile<T>(i, bh, S, causal);
        const int qb = n & 1;
        mbar_wait(q_empty + 8 * qb, ((n >> 1) & 1) ^ 1);
        mbar_expect_tx(q_full + 8 * qb, T::kQBytes);
#pragma unroll
        for (int cb = 0; cb < T::kCols; ++cb)
          tma_load(sq + qb * T::kQBytes + cb * T::kQColBytes, &tq,
                   q_full + 8 * qb, cb * T::kSw / 2, w.q0, w.bh);
#pragma unroll 1
        for (int kb = w.n_kb - 1; kb >= 0; --kb, ++it) {
          const int st = it % T::kStages;
          const uint32_t k_at = ring + 2 * st * T::kTileBytes;
          mbar_wait(empty + 8 * st, ((it / T::kStages) & 1) ^ 1);
          mbar_expect_tx(full + 8 * st, 2 * T::kTileBytes);
#pragma unroll
          for (int cb = 0; cb < T::kCols; ++cb) {
            tma_load(k_at + cb * T::kColBytes, &tk, full + 8 * st,
                     cb * T::kSw / 2, kb * kBlockN, w.bh);
            tma_load(k_at + T::kTileBytes + cb * T::kColBytes, &tv,
                     full + 8 * st, cb * T::kSw / 2, kb * kBlockN, w.bh);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(T::kConsumerRegs));
    const int cw = wg - 1;  // this warpgroup's 64 rows start at q0 + 64 cw
    const int lane = threadIdx.x % 32;
    const int t = lane % 4;
    const int row = 64 * cw + 16 * (threadIdx.x / 32 % 4) + lane / 4;
    // Turns: named barrier 1 + w is warpgroup w's turn to issue wgmma; each
    // warpgroup passes the turn to the next once it has issued, so the
    // others run their softmax while its products are on the tensor cores.
    const int my_turn = 1 + cw, next_turn = 1 + (cw + 1) % T::kConsumers;
    if (cw == T::kConsumers - 1) bar_arrive(1, 256);  // warpgroup 0 first
    float acc[D / 2], s[64], m[2], l[2], mx[2], corr[2];
    uint32_t pa[8][4];
    int it = 0;  // K/V tiles consumed by this block
    int n = 0;   // work tiles finished by this block
    for (int i = blockIdx.x; i < n_work; i += gridDim.x, ++n) {
      const WorkTile w = work_tile<T>(i, bh, S, causal);
      const int qb = n & 1;
      const int r0 = w.q0 + row;  // this thread's rows: r0 and r0 + 8
      const uint32_t q_at = sq + qb * T::kQBytes + 64 * cw * T::kSw;
#pragma unroll
      for (int k = 0; k < D / 2; ++k) acc[k] = 0.f;
      m[0] = m[1] = -INFINITY;
      l[0] = l[1] = 0.f;
      mbar_wait(q_full + 8 * qb, (n >> 1) & 1);

      // key tiles from the last down; those that cross the diagonal of
      // this warpgroup's rows, or the end of the sequence, are masked.
      // The first one alone:
      int st = it % T::kStages;
      int k0 = (w.n_kb - 1) * kBlockN;
      mbar_wait(full + 8 * st, (it / T::kStages) & 1);
      bar_sync(my_turn, 256);
      issue_qk<T>(s, q_at, ring + 2 * st * T::kTileBytes);
      bar_arrive(next_turn, 256);
      wgmma_wait<0>();
      pin(s);
      mx[0] = mx[1] = -INFINITY;
      if (k0 + kBlockN > S || (causal && k0 + kBlockN - 1 > w.q0 + 64 * cw))
        mask_max<true>(s, mx, k0 + 2 * t, r0, S, causal);
      else
        mask_max<false>(s, mx, 0, r0, S, causal);
      softmax_tile(s, mx, m, l, corr, c);
      pack_p(s, pa);
      // each further key tile: issue its q K^T and the previous tile's
      // P V, run its softmax while P V is on the tensor cores
#pragma unroll 1
      for (int j = 1; j < w.n_kb; ++j) {
        const int prev = st;
        st = (it + j) % T::kStages;
        k0 -= kBlockN;
        mbar_wait(full + 8 * st, ((it + j) / T::kStages) & 1);
        bar_sync(my_turn, 256);
        issue_qk<T>(s, q_at, ring + 2 * st * T::kTileBytes);
        issue_pv<T>(acc, pa, ring + (2 * prev + 1) * T::kTileBytes);
        bar_arrive(next_turn, 256);
        wgmma_wait<1>();  // q K^T done; P V may still run
        pin(s);
        mx[0] = m[0];
        mx[1] = m[1];
        if (causal && k0 + kBlockN - 1 > w.q0 + 64 * cw)
          mask_max<true>(s, mx, k0 + 2 * t, r0, S, causal);
        else
          mask_max<false>(s, mx, 0, r0, S, causal);
        softmax_tile(s, mx, m, l, corr, c);
        wgmma_wait<0>();
        pin(acc);
        pin(pa);  // P V read pa until now: its registers stay untouched
        mbar_arrive(empty + 8 * prev);
        rescale<D>(acc, corr);
        pack_p(s, pa);
      }
      it += w.n_kb;
      mbar_arrive(q_empty + 8 * qb);  // every q K^T of this tile is done
      bar_sync(my_turn, 256);
      issue_pv<T>(acc, pa, ring + (2 * st + 1) * T::kTileBytes);
      // the last warpgroup keeps its last turn: no one would take it
      if (cw < T::kConsumers - 1 || i + (int)gridDim.x < n_work)
        bar_arrive(next_turn, 256);
      wgmma_wait<0>();
      pin(acc);
      mbar_arrive(empty + 8 * st);

      // epilogue: row sums across the 4-lane group, normalise, store the
      // rows < S
      float inv[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        l[k] += __shfl_xor_sync(0xffffffffu, l[k], 1);
        l[k] += __shfl_xor_sync(0xffffffffu, l[k], 2);
        inv[k] = 1.f / fmaxf(l[k], 1e-30f);
      }
      __nv_bfloat16* oh = out + (size_t)w.bh * S * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int col = 8 * j + 2 * t;
        if (r0 < S)
          *reinterpret_cast<uint32_t*>(oh + (size_t)r0 * D + col) =
              pack_bf16(acc[4 * j] * inv[0], acc[4 * j + 1] * inv[0]);
        if (r0 + 8 < S)
          *reinterpret_cast<uint32_t*>(oh + (size_t)(r0 + 8) * D + col) =
              pack_bf16(acc[4 * j + 2] * inv[1], acc[4 * j + 3] * inv[1]);
      }
    }
  }
}

// cuTensorMapEncodeTiled is a driver-API call; it is reached through the
// runtime's entry-point query, so the library needs no -lcuda.
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return rc == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// [bh, S, D] bf16 as a 3-D tensor map (D, S, bh) with boxes of one column
// block x `rows` rows; rows past S are zero-filled within each head
template <class T>
bool tensor_map(CUtensorMap* map, const void* ptr, int bh, int S, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)T::kD, (cuuint64_t)S,
                              (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)T::kD * 2,
                                 (cuuint64_t)S * T::kD * 2};
  const cuuint32_t box[3] = {T::kSw / 2, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      T::kSw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : T::kSw == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                     : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// scale > 0 (the wrapper folds a negative scale's sign into q)
template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int bh, int S, float scale, int causal,
                        cudaStream_t st) {
  using T = TilesFor<D>;
  if (!(scale > 0.f)) return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  if (!tensor_map<T>(&mq, q, bh, S, T::kBlockM) ||
      !tensor_map<T>(&mk, k, bh, S, kBlockN) ||
      !tensor_map<T>(&mv, v, bh, S, kBlockN))
    return cudaErrorInvalidValue;
  cudaError_t rc = cudaFuncSetAttribute(
      flash_fwd_bf16<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::kSmemBytes);
  int dev = 0, sms = 0;
  if (rc == cudaSuccess) rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return rc;
  const long long n_tiles = (S + T::kBlockM - 1) / T::kBlockM * (long long)bh;
  if (n_tiles >= (1LL << 30)) return cudaErrorInvalidValue;  // int indices
  const int n_work = (int)n_tiles;
  flash_fwd_bf16<T><<<n_work < sms ? n_work : sms, T::kThreads,
                      T::kSmemBytes, st>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), bh, S, scale * kLog2e,
      causal);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32 path: one thread per query row, scalar FMAs
// ---------------------------------------------------------------------------

constexpr int kF32Bq = 128;  // query rows per block, one per thread
constexpr int kF32Bk = 32;   // keys per staged tile
constexpr int kF32Chunk = 16;  // keys per online-softmax update

template <int D>
__global__ void __launch_bounds__(kF32Bq)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int S,
              float scale, int causal) {
  __shared__ __align__(16) float Ks[kF32Bk * D];
  __shared__ __align__(16) float Vs[kF32Bk * D];

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kF32Bq;
  const int row = q0 + threadIdx.x;
  const size_t base = (size_t)blockIdx.y * S * D;

  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    // the TPU kernel scales q before the product; so does this one
    qr[d] = row < S ? q[base + (size_t)row * D + d] * scale : 0.f;
    acc[d] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  int n_kb = (S + kF32Bk - 1) / kF32Bk;
  if (causal) n_kb = min(n_kb, (q0 + kF32Bq + kF32Bk - 1) / kF32Bk);

  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * kF32Bk;
    __syncthreads();
    for (int i = threadIdx.x; i < kF32Bk * D / 4; i += kF32Bq) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (k0 + r < S) {
        kv = *reinterpret_cast<const float4*>(k + base + (size_t)(k0 + r) * D + c);
        vv = *reinterpret_cast<const float4*>(v + base + (size_t)(k0 + r) * D + c);
      }
      *reinterpret_cast<float4*>(&Ks[r * D + c]) = kv;
      *reinterpret_cast<float4*>(&Vs[r * D + c]) = vv;
    }
    __syncthreads();

#pragma unroll 1
    for (int c0 = 0; c0 < kF32Bk; c0 += kF32Chunk) {
      float s[kF32Chunk];
      uint32_t valid = 0u;
      float mx = m;
#pragma unroll
      for (int i = 0; i < kF32Chunk; ++i) {
        const float* kr = &Ks[(c0 + i) * D];
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          const float4 kk = *reinterpret_cast<const float4*>(kr + d);
          dot = fmaf(qr[d], kk.x, dot);
          dot = fmaf(qr[d + 1], kk.y, dot);
          dot = fmaf(qr[d + 2], kk.z, dot);
          dot = fmaf(qr[d + 3], kk.w, dot);
        }
        const int key = k0 + c0 + i;
        const bool ok = key < S && (!causal || row >= key);
        s[i] = ok ? dot : kNegInf;
        valid |= (ok ? 1u : 0u) << i;
        mx = fmaxf(mx, s[i]);
      }
      const float corr = expf(m - mx);
      float rs = 0.f;
#pragma unroll
      for (int i = 0; i < kF32Chunk; ++i) {
        const float p = ((valid >> i) & 1u) ? expf(s[i] - mx) : 0.f;
        s[i] = p;
        rs += p;
      }
      l = corr * l + rs;
      m = mx;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
      for (int i = 0; i < kF32Chunk; ++i) {
        const float* vr = &Vs[(c0 + i) * D];
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(vr + d);
          acc[d] = fmaf(s[i], vv.x, acc[d]);
          acc[d + 1] = fmaf(s[i], vv.y, acc[d + 1]);
          acc[d + 2] = fmaf(s[i], vv.z, acc[d + 2]);
          acc[d + 3] = fmaf(s[i], vv.w, acc[d + 3]);
        }
      }
    }
  }

  if (row < S) {
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int d = 0; d < D; ++d) o[base + (size_t)row * D + d] = acc[d] / den;
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int bh, int S, float scale, int causal, cudaStream_t st) {
  dim3 grid((S + kF32Bq - 1) / kF32Bq, bh);
  flash_fwd_f32<D><<<grid, kF32Bq, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: contiguous [bh, S, D]; dtype 0 = f32, 1 = bf16.
// Returns a cudaError_t (0 on a successful launch).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int bh, int S, int D, float scale,
                                   int causal, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  // a thread that ran no CUDA work yet has no current context, and the
  // tensor maps' driver-API encoding refuses the pointers without one:
  // make the device's primary context current (cudaSetDevice does)
  int dev = 0;
  cudaError_t ctx = cudaGetDevice(&dev);
  if (ctx == cudaSuccess) ctx = cudaSetDevice(dev);
  if (ctx != cudaSuccess) return (int)ctx;
  if (dtype == 1) {
    switch (D) {
      case 16: return (int)launch_bf16<16>(q, k, v, o, bh, S, scale, causal, st);
      case 32: return (int)launch_bf16<32>(q, k, v, o, bh, S, scale, causal, st);
      case 64: return (int)launch_bf16<64>(q, k, v, o, bh, S, scale, causal, st);
      case 128: return (int)launch_bf16<128>(q, k, v, o, bh, S, scale, causal, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype == 0) {
    if (bh > 65535) return (int)cudaErrorInvalidValue;  // gridDim.y
    switch (D) {
      case 16: return (int)launch_f32<16>(q, k, v, o, bh, S, scale, causal, st);
      case 32: return (int)launch_f32<32>(q, k, v, o, bh, S, scale, causal, st);
      case 64: return (int)launch_f32<64>(q, k, v, o, bh, S, scale, causal, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaErrorInvalidValue;
}
