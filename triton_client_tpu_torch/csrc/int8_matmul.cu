// Fused dynamic-quantize + int8 GEMM for Hopper (sm_90a), bound with ctypes.
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
// What bounds it on the H100: at the FFN-down serving shape (M = 16384,
// K = 4096, N = 1024) the product is 2*M*K*N int8 operations against
// ~M*K*2 + K*N + M*N*2 bytes, so the int8 tensor-core rate bounds it; the
// per-element IEEE divide of the quantize prologue is the next cost.
//
// Design (simple and correct first; no wgmma, TMA or multi-stage pipeline):
//  * row_scale: one warp per row computes xs[m] (a 4*M-byte side output).
//  * gemm: one block of 8 warps per 128x128 output tile.  For each 64-deep
//    slice of K the block reads the activation tile in its own type,
//    quantizes it in registers with xs[m] and stores the int8 codes straight
//    to shared memory -- the quantized activation never touches device
//    memory, which is the point of the TPU kernel's fusion.  The weight tile
//    is transposed 4x4 bytes at a time (__byte_perm) into [n][k] order so
//    both mma.sync m16n8k32 s8 fragments are 32-bit shared-memory loads.
//    Each warp owns a 64x32 sub-tile (4 x 4 mma tiles, s32 in registers).
//    Blocks walk N fastest, so the blocks that share an activation row band
//    run together and re-read it from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kLds = kBK + 16;  // padded smem row (bytes): conflict-free fragment loads
constexpr int kThreads = 256;

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// four consecutive elements of a row as f32
__device__ __forceinline__ void load4(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&f)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  f[0] = __low2float(a); f[1] = __high2float(a);
  f[2] = __low2float(b); f[3] = __high2float(b);
}

__device__ __forceinline__ uint32_t quant4(const float (&f)[4], float s) {
  uint32_t w = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float r = fminf(fmaxf(rintf(__fdiv_rn(f[j], s)), -127.f), 127.f);
    w |= (uint32_t)(uint8_t)(int8_t)(int)r << (8 * j);
  }
  return w;
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// xs[m] = max(amax_k |x[m,k]|, 1e-12) / 127; one warp per row, K % 128 == 0
template <typename T>
__global__ void __launch_bounds__(kThreads)
row_scale(const T* __restrict__ x, float* __restrict__ xs, int M, int K) {
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const T* xr = x + (size_t)row * K;
  float amax = 0.f;
  for (int c = lane * 4; c < K; c += 128) {
    float f[4];
    load4(xr + c, f);
#pragma unroll
    for (int j = 0; j < 4; ++j) amax = fmaxf(amax, fabsf(f[j]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if (lane == 0) xs[row] = __fdiv_rn(fmaxf(amax, 1e-12f), 127.0f);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
int8_gemm(const T* __restrict__ x, const int8_t* __restrict__ w,
          const float* __restrict__ ws, const float* __restrict__ xs,
          T* __restrict__ out, int M, int K, int N) {
  __shared__ __align__(16) int8_t Xq[kBM * kLds];  // [m][k] int8 codes
  __shared__ __align__(16) int8_t Wt[kBN * kLds];  // [n][k] int8 weights

  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64;  // warp's row offset in the tile
  const int wn = (warp & 3) * 32;   // warp's column offset in the tile

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // activation tile: 128 rows x 64 cols, 8 elements (two words) per chunk
    for (int c = tid; c < kBM * (kBK / 8); c += kThreads) {
      const int r = c / (kBK / 8), cc = (c % (kBK / 8)) * 8;
      const int gr = m0 + r;
      uint2 qv = make_uint2(0u, 0u);
      if (gr < M) {
        const T* src = x + (size_t)gr * K + k0 + cc;
        const float s = xs[gr];
        float f[4];
        load4(src, f);
        qv.x = quant4(f, s);
        load4(src + 4, f);
        qv.y = quant4(f, s);
      }
      *reinterpret_cast<uint2*>(&Xq[r * kLds + cc]) = qv;
    }
    // weight tile: 64 (k) x 128 (n), 4x4-byte blocks transposed to [n][k]
    for (int c = tid; c < (kBK / 4) * (kBN / 4); c += kThreads) {
      const int kb = c % (kBK / 4), nb = c / (kBK / 4);
      const int8_t* src = w + (size_t)(k0 + kb * 4) * N + n0 + nb * 4;
      const uint32_t r0 = *reinterpret_cast<const uint32_t*>(src);
      const uint32_t r1 = *reinterpret_cast<const uint32_t*>(src + N);
      const uint32_t r2 = *reinterpret_cast<const uint32_t*>(src + 2 * (size_t)N);
      const uint32_t r3 = *reinterpret_cast<const uint32_t*>(src + 3 * (size_t)N);
      const uint32_t lo01 = __byte_perm(r0, r1, 0x5140);
      const uint32_t hi01 = __byte_perm(r0, r1, 0x7362);
      const uint32_t lo23 = __byte_perm(r2, r3, 0x5140);
      const uint32_t hi23 = __byte_perm(r2, r3, 0x7362);
      int8_t* dst = &Wt[(nb * 4) * kLds + kb * 4];
      *reinterpret_cast<uint32_t*>(dst) = __byte_perm(lo01, lo23, 0x5410);
      *reinterpret_cast<uint32_t*>(dst + kLds) = __byte_perm(lo01, lo23, 0x7632);
      *reinterpret_cast<uint32_t*>(dst + 2 * kLds) = __byte_perm(hi01, hi23, 0x5410);
      *reinterpret_cast<uint32_t*>(dst + 3 * kLds) = __byte_perm(hi01, hi23, 0x7632);
    }
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* p = &Xq[(wm + i * 16 + g) * kLds + ks + t * 4];
        a[i][0] = *reinterpret_cast<const uint32_t*>(p);
        a[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kLds);
        a[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        a[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kLds + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* p = &Wt[(wn + j * 8 + g) * kLds + ks + t * 4];
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(p);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(p + 16);
#pragma unroll
        for (int i = 0; i < 4; ++i) mma_s8(acc[i][j], a[i], b0, b1);
      }
    }
    __syncthreads();
  }

  // epilogue: ((f32) acc * xs[m]) * ws[n], in the reference's order
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ra = m0 + wm + i * 16 + g;
    const int rb = ra + 8;
    const float sa = ra < M ? xs[ra] : 0.f;
    const float sb = rb < M ? xs[rb] : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + wn + j * 8 + t * 2;
      const float w0 = ws[c], w1 = ws[c + 1];
      if (ra < M) {
        store_out(out + (size_t)ra * N + c, ((float)acc[i][j][0] * sa) * w0);
        store_out(out + (size_t)ra * N + c + 1, ((float)acc[i][j][1] * sa) * w1);
      }
      if (rb < M) {
        store_out(out + (size_t)rb * N + c, ((float)acc[i][j][2] * sb) * w0);
        store_out(out + (size_t)rb * N + c + 1, ((float)acc[i][j][3] * sb) * w1);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* ws, void* xs,
                   void* out, int M, int K, int N, cudaStream_t st) {
  row_scale<T><<<(M + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<float*>(xs), M, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid(N / kBN, (M + kBM - 1) / kBM);
  int8_gemm<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(ws), static_cast<const float*>(xs),
      static_cast<T*>(out), M, K, N);
  return cudaGetLastError();
}

}  // namespace

// x: contiguous [M, K] (dtype 0 = f32, 1 = bf16); w: contiguous [K, N] int8;
// ws: [N] f32; xs: [M] f32 scratch (the per-row scales); out: [M, N] in x's
// type.  K % 128 == 0 and N % 128 == 0.  Returns a cudaError_t.
extern "C" int int8_matmul_fwd(const void* x, const void* w, const void* ws,
                               void* xs, void* out, int M, int K, int N,
                               int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || K <= 0 || N <= 0 || K % 128 || N % 128 ||
      (M + kBM - 1) / kBM > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) return (int)launch<__nv_bfloat16>(x, w, ws, xs, out, M, K, N, st);
  if (dtype == 0) return (int)launch<float>(x, w, ws, xs, out, M, K, N, st);
  return (int)cudaErrorInvalidValue;
}
