// Dynamic-quantize + int8 GEMM for Hopper (sm_90a), bound with ctypes.
//
// Replaces the Pallas TPU kernel triton_client_tpu/ops/int8_matmul.py
// (_call, pl.pallas_call at :102, body _kernel :62-74):
//   xs[m]  = max(amax_k |x[m, k]|, 1e-12) / 127                    (f32)
//   q[m,k] = clip(round_half_even(x[m, k] / xs[m]), -127, 127)     (s8, true divide)
//   out    = ((f32) sum_k q[m,k] * w[k,n]  * xs[m]) * ws[n]        (s32 accumulate)
// cast to the input type.  Codes and outputs are bit-identical to the plain
// PyTorch version: the divide is __fdiv_rn, rounding is rintf, the s32 sum is
// exact in any order, and the epilogue multiplies in the reference's order.
// This file must never be compiled with --use_fast_math.
//
// Why two passes.  The TPU kernel keeps the full K of a 256-row block in
// VMEM, so it reads and quantizes each activation once inside the GEMM.  On
// Hopper a block has 227 KB of shared memory and a 128-row band at
// K = 4096 is 512 KB of codes, so a GEMM that quantizes its own tiles
// re-reads the band and divides again once per column tile (8 times at
// N = 1024 with 128-column tiles, as this file's first design did).  Here
// each row is quantized once, into device memory, and the GEMM is a pure
// s8 x s8 product that TMA can feed.
//
// What bounds it on the H100, at FFN-down (M = 16384, K = 4096, N = 1024,
// bf16): the product is 2*M*K*N = 137.4 G int8 operations, 0.0694 ms at
// 1,979 TOP/s, against 105 MB of inputs and outputs (0.031 ms at 3.35 TB/s),
// so operations bound the function.  The split adds the codes' round trip:
// the quantize pass reads 134.2 MB and writes 67.1 MB (0.060 ms), so the
// design's own floor is 0.130 ms.
//
// Design:
//  * quantize_rows: one block of 128 threads per row, 16-byte loads.  A
//    thread holds up to 4 chunks of the row in registers (8 KB rows: bf16
//    up to K = 4096, f32 up to 2048), the block takes the row's amax
//    (warp shuffles, then shared memory), and each thread divides and
//    stores its codes from the registers; the rest of a longer row is read
//    again, from L2.  It writes xs[M] (f32) and the codes q[M, K] (s8):
//    scratch the wrapper allocates with torch.empty, 67 MB at the serving
//    shape.  On the H100 a warp per row (more registers, fewer warps) was
//    much slower, and a reciprocal multiply in place of the divide gained
//    nothing: the pass waits on memory, not on the divide.
//  * int8_gemm: persistent, one block per SM walking 128 x 256 output tiles,
//    the N tiles of a row band adjacent (concurrent blocks share the band
//    through L2).  Warpgroup 0 gives its registers up (setmaxnreg.dec) and
//    one thread issues TMA loads through 2-D tensor maps on the codes
//    [M, K] and the K-major weight [N, K], 128 bytes of K per stage with
//    the 128-byte swizzle, into a ring of 4 stages (16 + 32 KB each) under
//    full/empty mbarriers; rows past M come back as zeros.  Two consumer
//    warpgroups of 64 rows (setmaxnreg.inc) run wgmma m64n256k32 s32.s8.s8
//    from shared memory, 128 s32 accumulators a thread, one group kept in
//    flight while the next stage lands.  The epilogue scales and casts, and
//    each warp passes its rows through 2 KB of shared memory so they leave
//    as 16-byte stores of whole 128-byte row segments (the accumulator
//    layout alone gives 4-byte stores into 8 rows, which made the GEMM far
//    slower where the output is large, at K = 1024, N = 4096); ragged rows
//    are masked, and the producer already loads the next tile.
//  * The weight must be K-major: wgmma reads 8-bit operands only K-major
//    (the transpose bits exist for 16-bit types).  The wrapper passes a
//    [K, N] weight whose storage is [N, K] straight through and copies a
//    row-major one.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// quantize-rows pass
// ---------------------------------------------------------------------------

constexpr int kQThreads = 128;  // one block per row
constexpr int kHeld = 4;        // 16-byte chunks of the row a thread keeps

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// the 16 bytes of a chunk as f32 values: 8 bf16 or 4 f32
template <typename T>
__device__ __forceinline__ void widen(const uint4& v,
                                      float (&f)[16 / sizeof(T)]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (sizeof(T) == 2) {
      f[2 * j] = __uint_as_float(w[j] << 16);
      f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    } else {
      f[j] = __uint_as_float(w[j]);
    }
  }
}

template <typename T>
__device__ __forceinline__ float chunk_amax(const uint4& v, float amax) {
  float f[16 / sizeof(T)];
  widen<T>(v, f);
#pragma unroll
  for (int j = 0; j < 16 / (int)sizeof(T); ++j) amax = fmaxf(amax, fabsf(f[j]));
  return amax;
}

__device__ __forceinline__ uint32_t code(float f, float s) {
  const float r = fminf(fmaxf(rintf(__fdiv_rn(f, s)), -127.f), 127.f);
  return (uint32_t)(int)r & 0xffu;
}

// quantize one chunk and store its codes (8 bytes for bf16, 4 for f32)
template <typename T>
__device__ __forceinline__ void store_codes(int8_t* dst, const uint4& v,
                                            float s) {
  float f[16 / sizeof(T)];
  widen<T>(v, f);
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < 16 / (int)sizeof(T); ++j)
    w[j / 4] |= code(f[j], s) << (8 * (j % 4));
  if constexpr (sizeof(T) == 2)
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  else
    *reinterpret_cast<uint32_t*>(dst) = w[0];
}

// xs[m] = max(amax_k |x[m,k]|, 1e-12) / 127, q[m, :] = the row's codes;
// one block per row, K % 128 == 0, rows 16-byte aligned
template <typename T>
__global__ void __launch_bounds__(kQThreads)
quantize_rows(const T* __restrict__ x, int8_t* __restrict__ q,
              float* __restrict__ xs, int K) {
  constexpr int kVec = 16 / sizeof(T);       // elements per chunk
  constexpr int kStep = kQThreads * kVec;    // elements per block-wide step
  __shared__ float part[kQThreads / 32];
  const T* xr = x + (size_t)blockIdx.x * K;
  int8_t* qr = q + (size_t)blockIdx.x * K;
  const int c0 = threadIdx.x * kVec;
  uint4 held[kHeld];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kHeld; ++i) {
    if (c0 + i * kStep < K) {
      held[i] = load16(xr + c0 + i * kStep);
      amax = chunk_amax<T>(held[i], amax);
    }
  }
  for (int c = c0 + kHeld * kStep; c < K; c += kStep)
    amax = chunk_amax<T>(load16(xr + c), amax);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = amax;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kQThreads / 32; ++w) amax = fmaxf(amax, part[w]);
  const float s = __fdiv_rn(fmaxf(amax, 1e-12f), 127.0f);
  if (threadIdx.x == 0) xs[blockIdx.x] = s;
#pragma unroll
  for (int i = 0; i < kHeld; ++i)
    if (c0 + i * kStep < K)
      store_codes<T>(qr + c0 + i * kStep, held[i], s);
  for (int c = c0 + kHeld * kStep; c < K; c += kStep)
    store_codes<T>(qr + c, load16(xr + c), s);
}

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

// one box of a 2-D tensor map into shared memory, completion on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1)
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

// keep the compiler from moving accumulator accesses across a wgmma
__device__ __forceinline__ void pin(int (&r)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// shared-memory matrix descriptor of a K-major tile with 128-byte rows and
// the 128-byte swizzle: stride between 8-row groups 1024 bytes
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
}

// d (+)= A B for a 64 x 256 tile, 32 deep; A and B s8, K-major in shared
// memory; d s32
__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

// ---------------------------------------------------------------------------
// s8 GEMM
// ---------------------------------------------------------------------------

constexpr int kBM = 128, kBN = 256;  // output tile
constexpr int kBK = 128;             // bytes (= s8 elements) of K per stage
constexpr int kStages = 4;
constexpr int kABytes = kBM * kBK;   // 16 KB of codes
constexpr int kBBytes = kBN * kBK;   // 32 KB of weights
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kConsumerThreads = 256;  // two warpgroups of 64 rows
constexpr int kGemmThreads = 128 + kConsumerThreads;
// 168 registers a thread at entry (65,536 / 384); 40 x 128 + 232 x 256 fit
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
// epilogue staging: 16 rows of 128 bytes for each consumer warp, rows 144
// bytes apart so the accumulator layout's 4-byte writes hit 32 banks
constexpr int kStageRow = 144;
constexpr int kEpilogueBytes = kConsumerThreads / 32 * 16 * kStageRow;
// 1024 to align the ring to the swizzle pattern; the ring; the mbarriers;
// the epilogue staging
constexpr int kSmemBytes =
    1024 + kStages * kStageBytes + 2 * 8 * kStages + kEpilogueBytes;

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// One persistent block per SM walks output tiles t = blockIdx.x,
// blockIdx.x + gridDim.x, ... (row band t / n_tiles_n, column tile
// t % n_tiles_n); the ring runs on from one tile to the next, so the
// producer loads the next tile while the consumers store this one.
template <typename T>
__global__ void __launch_bounds__(kGemmThreads, 1)
int8_gemm(const __grid_constant__ CUtensorMap ta,
          const __grid_constant__ CUtensorMap tb,
          const float* __restrict__ xs, const float* __restrict__ ws,
          T* __restrict__ out, int M, int K, int N) {
  extern __shared__ uint8_t smem[];
  const uint32_t ring = (smem_addr(smem) + 1023) & ~1023u;  // A then B
  const uint32_t full = ring + kStages * kStageBytes;
  const uint32_t empty = full + 8 * kStages;
  const int n_tiles_n = (N + kBN - 1) / kBN;
  const int n_tiles = ((M - 1) / kBM + 1) * n_tiles_n;
  const int n_kb = K / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    if (threadIdx.x == 0) {
      int it = 0;  // stages filled by this block
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int m0 = t / n_tiles_n * kBM, n0 = t % n_tiles_n * kBN;
#pragma unroll 1
        for (int kb = 0; kb < n_kb; ++kb, ++it) {
          const int st = it % kStages;
          const uint32_t a_at = ring + st * kStageBytes;
          mbar_wait(empty + 8 * st, ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(full + 8 * st, kStageBytes);
          tma_load(a_at, &ta, full + 8 * st, kb * kBK, m0);
          tma_load(a_at + kABytes, &tb, full + 8 * st, kb * kBK, n0);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(kConsumerRegs));
    const int cw = wg - 1;  // this warpgroup's 64 rows start at m0 + 64 cw
    const int lane = threadIdx.x % 32;
    // accumulator layout: rows row and row + 8, columns 8 j + col, + 1
    const int row = 64 * cw + 16 * (threadIdx.x / 32 % 4) + lane / 4;
    const int col = 2 * (lane % 4);
    constexpr int kGroupCols = 128 / sizeof(T);  // output columns a group
    uint8_t* stage = smem + (empty + 8 * kStages - smem_addr(smem)) +
                     (threadIdx.x / 32 - 4) * 16 * kStageRow;
    int acc[128];
    int it = 0;  // stages consumed by this block
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const int m0 = t / n_tiles_n * kBM, n0 = t % n_tiles_n * kBN;
      int st = 0;
#pragma unroll 1
      for (int kb = 0; kb < n_kb; ++kb) {
        const int prev = st;
        st = (it + kb) % kStages;
        const uint32_t a_at = ring + st * kStageBytes + 64 * cw * kBK;
        const uint32_t b_at = ring + st * kStageBytes + kABytes;
        mbar_wait(full + 8 * st, ((it + kb) / kStages) & 1);
        pin(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 32; ++kk)
          wgmma_s8_n256(acc, smem_desc(a_at + 32 * kk),
                        smem_desc(b_at + 32 * kk), kb > 0 || kk > 0);
        wgmma_commit();
        pin(acc);
        if (kb > 0) {
          wgmma_wait<1>();  // the previous stage's products are done
          mbar_arrive(empty + 8 * prev);
        }
      }
      wgmma_wait<0>();
      pin(acc);
      mbar_arrive(empty + 8 * st);
      it += n_kb;

      // epilogue: ((f32) acc * xs[m]) * ws[n], in the reference's order,
      // 128 bytes of each of the warp's 16 rows at a time: the
      // accumulator layout goes through the warp's staging rows and leaves
      // as 16-byte stores, four full 128-byte row segments per instruction
      const int r0 = m0 + row, r1 = r0 + 8;
      const float s0 = r0 < M ? xs[r0] : 0.f;
      const float s1 = r1 < M ? xs[r1] : 0.f;
#pragma unroll
      for (int g = 0; g < kBN / kGroupCols; ++g) {
        if (n0 + g * kGroupCols >= N) break;  // N % 128 == 0: whole groups
#pragma unroll
        for (int jj = 0; jj < kGroupCols / 8; ++jj) {
          const int j = g * kGroupCols / 8 + jj;
          const int c = n0 + 8 * j + col;
          const float w0 = __ldg(ws + c), w1 = __ldg(ws + c + 1);
          T* at = reinterpret_cast<T*>(stage + lane / 4 * kStageRow) + 8 * jj +
                  col;
          store2(at, ((float)acc[4 * j] * s0) * w0,
                 ((float)acc[4 * j + 1] * s0) * w1);
          store2(reinterpret_cast<T*>(reinterpret_cast<uint8_t*>(at) +
                                      8 * kStageRow),
                 ((float)acc[4 * j + 2] * s1) * w0,
                 ((float)acc[4 * j + 3] * s1) * w1);
        }
        __syncwarp();
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int rr = 4 * h + lane / 8;  // of the warp's 16 rows
          const int gr = m0 + row - lane / 4 + rr;
          const uint4 v = *reinterpret_cast<const uint4*>(
              stage + rr * kStageRow + 16 * (lane % 8));
          if (gr < M)
            *reinterpret_cast<uint4*>(out + (size_t)gr * N + n0 +
                                      g * kGroupCols +
                                      lane % 8 * (16 / sizeof(T))) = v;
        }
        __syncwarp();
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

// a row-major [rows, K] s8 matrix as a 2-D tensor map (K, rows) with boxes
// of 128 bytes x box_rows, 128-byte swizzle; rows past the end read as 0
bool tensor_map(CUtensorMap* map, const void* ptr, int rows, int K,
                int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
cudaError_t launch_quantize(const void* x, void* q, void* xs, int M, int K,
                            cudaStream_t st) {
  quantize_rows<T><<<M, kQThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(q),
      static_cast<float*>(xs), K);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_gemm(const void* q, const void* wt, const void* xs,
                        const void* ws, void* out, int M, int K, int N,
                        cudaStream_t st) {
  CUtensorMap ma, mb;
  if (!tensor_map(&ma, q, M, K, kBM) || !tensor_map(&mb, wt, N, K, kBN))
    return cudaErrorInvalidValue;
  cudaError_t rc = cudaFuncSetAttribute(
      int8_gemm<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  int dev = 0, sms = 0;
  if (rc == cudaSuccess) rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return rc;
  const long long tiles =
      (long long)((M - 1) / kBM + 1) * ((N - 1) / kBN + 1);
  if (tiles >= (1LL << 31)) return cudaErrorInvalidValue;  // int tile index
  int8_gemm<T><<<tiles < sms ? (int)tiles : sms, kGemmThreads, kSmemBytes,
                 st>>>(ma, mb, static_cast<const float*>(xs),
                       static_cast<const float*>(ws), static_cast<T*>(out),
                       M, K, N);
  return cudaGetLastError();
}

bool valid(int M, int K, int dtype) {
  return M > 0 && K > 0 && K % 128 == 0 && (dtype == 0 || dtype == 1);
}

}  // namespace

// The quantize pass alone.  x: contiguous [M, K], 16-byte aligned (dtype
// 0 = f32, 1 = bf16); q: [M, K] s8 out; xs: [M] f32 out.  K % 128 == 0.
// Returns a cudaError_t.
extern "C" int int8_quantize_rows_fwd(const void* x, void* q, void* xs,
                                      int M, int K, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!valid(M, K, dtype)) return (int)cudaErrorInvalidValue;
  return dtype == 1 ? (int)launch_quantize<__nv_bfloat16>(x, q, xs, M, K, st)
                    : (int)launch_quantize<float>(x, q, xs, M, K, st);
}

// The quantize pass, then the s8 GEMM.  x as above; wt: the weight K-major,
// contiguous [N, K] s8, 16-byte aligned; ws: [N] f32; q: [M, K] s8 and xs:
// [M] f32 scratch; out: [M, N] in x's type.  K % 128 == 0 and
// N % 128 == 0.  Returns a cudaError_t.
extern "C" int int8_matmul_fwd(const void* x, const void* wt, const void* ws,
                               void* q, void* xs, void* out, int M, int K,
                               int N, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!valid(M, K, dtype) || N <= 0 || N % 128)
    return (int)cudaErrorInvalidValue;
  // a thread that ran no CUDA work yet has no current context, and the
  // tensor maps' driver-API encoding refuses the pointers without one:
  // make the device's primary context current (cudaSetDevice does)
  int dev = 0;
  cudaError_t ctx = cudaGetDevice(&dev);
  if (ctx == cudaSuccess) ctx = cudaSetDevice(dev);
  if (ctx != cudaSuccess) return (int)ctx;
  const int rc = int8_quantize_rows_fwd(x, q, xs, M, K, dtype, stream);
  if (rc != 0) return rc;
  return dtype == 1
             ? (int)launch_gemm<__nv_bfloat16>(q, wt, xs, ws, out, M, K, N, st)
             : (int)launch_gemm<float>(q, wt, xs, ws, out, M, K, N, st);
}
