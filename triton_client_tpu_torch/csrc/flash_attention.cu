// Forward flash attention for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel triton_client_tpu/ops/flash_attention.py
// (_flash_call, pl.pallas_call at :140, body _kernel :50-103): forward
// softmax(q k^T * scale + mask) v over [B, H, S, D], online softmax state
// (m, l, acc) in f32, the -1e30 mask, padded keys masked for any S, fully
// masked rows zeroed (p = 0, never exp(0)), the causal early exit over key
// tiles, and the output acc / max(l, 1e-30) cast to the input type.
//
// What bounds it on the H100: at the serving shape (S = 4096, D = 64, causal)
// the work is ~4 * B*H * S^2/2 * D operations against only 4 * B*H*S*D*2
// bytes of q, k, v and o, so it is bound by operations -- tensor-core rate for
// the product work, and the exp unit for the softmax.  Nothing of size S x S
// ever touches device memory.
//
// Design (simple and correct first; no wgmma, TMA or pipelining yet):
//  * bf16: one block of 4 warps per (b*h, 64-query tile).  Each warp owns 16
//    query rows whose q fragments stay in registers for the whole loop.  Key
//    tiles of 64 are staged in shared memory (K row-major, V transposed so
//    both mma B-fragments are 32-bit loads).  S = q k^T and O += P V run on
//    mma.sync m16n8k16 (bf16 in, f32 accumulate); the score fragment doubles
//    as the A fragment of P V after a bf16 pack, as in FlashAttention-2.
//    Row max and row sum use two xor-shuffles within each 4-lane group.
//  * f32: one thread per query row (128 rows per block), key tiles of 32
//    staged in shared memory as f32, scalar FMAs.  It keeps full f32 math for
//    callers that run the model in f32; it is not on the bf16 serving path.
//  * Causal: key tiles entirely above the block's last row are never loaded,
//    and the q tiles are walked from the last (heaviest) one down so the
//    longest blocks start first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// bf16 tensor-core path
// ---------------------------------------------------------------------------

constexpr int kBq = 64;     // query rows per block (4 warps x 16 rows)
constexpr int kBk = 64;     // keys per staged tile
constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p, int row,
                                              int col, int S, int D) {
  if (row >= S) return 0u;
  return *reinterpret_cast<const uint32_t*>(p + (size_t)row * D + col);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ o, int S, float scale, int causal) {
  constexpr int KS = D + 8;    // padded row stride of Ks: conflict-free reads
  constexpr int VS = kBk + 8;  // padded row stride of Vt
  __shared__ __align__(16) __nv_bfloat16 Ks[kBk * KS];
  __shared__ __align__(16) __nv_bfloat16 Vt[D * VS];

  const int q_tile = gridDim.x - 1 - blockIdx.x;  // heaviest causal tile first
  const int q0 = q_tile * kBq;
  const size_t base = (size_t)blockIdx.y * S * D;
  const __nv_bfloat16* qh = q + base;
  const __nv_bfloat16* kh = k + base;
  const __nv_bfloat16* vh = v + base;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  const int r1 = r0 + 8;

  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + t * 2;
    qf[kk][0] = load_pair(qh, r0, c, S, D);
    qf[kk][1] = load_pair(qh, r1, c, S, D);
    qf[kk][2] = load_pair(qh, r0, c + 8, S, D);
    qf[kk][3] = load_pair(qh, r1, c + 8, S, D);
  }

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  int n_kb = (S + kBk - 1) / kBk;
  if (causal) n_kb = min(n_kb, (q0 + kBq + kBk - 1) / kBk);

  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * kBk;
    __syncthreads();  // the previous tile is fully consumed
    constexpr int CH = D / 8;  // 16-byte chunks per row
    for (int c = threadIdx.x; c < kBk * CH; c += kThreads) {
      const int r = c / CH, cc = (c % CH) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < S) {
        kv = *reinterpret_cast<const uint4*>(kh + (size_t)(k0 + r) * D + cc);
        vv = *reinterpret_cast<const uint4*>(vh + (size_t)(k0 + r) * D + cc);
      }
      *reinterpret_cast<uint4*>(&Ks[r * KS + cc]) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) Vt[(cc + j) * VS + r] = ve[j];
    }
    __syncthreads();

    // S = q k^T for this warp's 16 rows x 64 keys
    float s[kBk / 8][4];
#pragma unroll
    for (int j = 0; j < kBk / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* krow = &Ks[(j * 8 + g) * KS + t * 2];
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + kk * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 8);
        mma_16816(s[j], qf[kk], b0, b1);
      }
    }

    // scale, mask (padding keys and, if causal, keys after the query), row max
    uint32_t valid = 0u;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kBk / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = (e < 2) ? r0 : r1;
        const int col = k0 + j * 8 + t * 2 + (e & 1);
        const bool ok = col < S && (!causal || row >= col);
        const float val = ok ? s[j][e] * scale : kNegInf;
        s[j][e] = val;
        valid |= (ok ? 1u : 0u) << (j * 4 + e);
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }

    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kBk / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        // a fully masked row would give exp(0); zero it instead
        const float p = ((valid >> (j * 4 + e)) & 1u)
                            ? exp2f((s[j][e] - mx[i]) * kLog2e) : 0.f;
        s[j][e] = p;
        rs[i] += p;
      }
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      corr[i] = exp2f((m[i] - mx[i]) * kLog2e);
      l[i] = corr[i] * l[i] + rs[i];
      m[i] = mx[i];
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }

    // O += P V: the score fragments of key columns 16kk..16kk+15 are the
    // A fragment of one k16 step
#pragma unroll
    for (int kk = 0; kk < kBk / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const __nv_bfloat16* vrow = &Vt[(j * 8 + g) * VS + kk * 16 + t * 2];
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(vrow);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(vrow + 8);
        mma_16816(acc[j], a, b0, b1);
      }
    }
  }

  const float d0 = fmaxf(l[0], 1e-30f), d1 = fmaxf(l[1], 1e-30f);
  __nv_bfloat16* oh = o + base;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + t * 2;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(oh + (size_t)r0 * D + c) =
          pack_bf16(acc[j][0] / d0, acc[j][1] / d0);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(oh + (size_t)r1 * D + c) =
          pack_bf16(acc[j][2] / d1, acc[j][3] / d1);
  }
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
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int bh, int S, float scale, int causal, cudaStream_t st) {
  dim3 grid((S + kBq - 1) / kBq, bh);
  flash_fwd_bf16<D><<<grid, kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S,
      scale, causal);
  return cudaGetLastError();
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
  if (bh <= 0 || bh > 65535 || S <= 0) return (int)cudaErrorInvalidValue;
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
    switch (D) {
      case 16: return (int)launch_f32<16>(q, k, v, o, bh, S, scale, causal, st);
      case 32: return (int)launch_f32<32>(q, k, v, o, bh, S, scale, causal, st);
      case 64: return (int)launch_f32<64>(q, k, v, o, bh, S, scale, causal, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaErrorInvalidValue;
}
