// Dense non-causal attention for Hopper: o = softmax(q k^T * scale) v per
// (batch, head), with the softmax taken exactly over each full score row.
//
// Replaces livetalking_tpu/ops/pallas_attention.py::_attn_kernel (the TPU
// kernel behind _pallas_forward / vmem_attention). Same function, same
// arithmetic order of roundings:
//   s = (q . k) * scale      f32 products of the (bf16 or f32) inputs, f32 sums
//   m = max_j s,  p = exp(s - m),  a = p / sum_j p      all f32
//   a is rounded to v's dtype, then o = a . v with f32 sums, rounded to v's dtype
//
// Design. The TPU kernel holds one (batch*head) problem whole in VMEM. A
// Hopper block has at most 227 KB of shared memory, so a block takes a
// tile of QR = 16 query rows of one (batch*head) and holds their full
// score rows (16 x T floats: 64 KB at T = 1024) in shared memory; the
// softmax is therefore exact, never rescaled online. Three phases:
//   1. scores s = q.k * scale into the shared score rows;
//   2. softmax: one warp per row, f32 max / exp / sum / divide, the
//      probabilities rounded to v's dtype in place;
//   3. o = a.v with f32 sums.
// Two kernels share that plan:
//   - attention_tc_kernel, for bf16 with D % 8 == 0 and T % 8 == 0 (every
//     shape of the MuseTalk path): phases 1 and 3 run on the tensor cores
//     as mma.sync m16n8k16 bf16 products with f32 accumulators (8 warps
//     over the 8-key or 8-column tiles, each with several tiles' or steps'
//     loads in flight at once); the bf16 probabilities overwrite
//     the front half of their own f32 score row, so the block needs
//     16*T*4 + 16*D*2 bytes of shared memory. Products of two bf16 values
//     are exact in f32; only the order of the f32 sums differs from the
//     reference.
//   - attention_kernel, for f32 and any other shape, on the f32 CUDA
//     cores: in phase 1 each thread owns keys and keeps 16 f32 sums; in
//     phase 3 threads own output columns and slices of the keys, whose
//     partial sums meet in shared memory. f32 inputs never go through
//     the tensor cores (TF32 would round them).
//
// What bounds it on the H100: operations. 4*T*T*D flops per (batch*head)
// against 4*T*D*2 bytes of q/k/v/o: at (16, 8, 1024, 40) in bf16 that is
// 21.5 GFLOP for 42 MB, far right of the ridge. On the bf16 tensor cores
// (989 TFLOP/s) the floor is about 22 us, and the B*H*T*T exponentials
// (134 M, 16 per SM per clock) about 32-36 us. Neither kernel stages k
// and v through shared memory: every block reads the whole k and v of its
// (batch*head) through L1/L2, T/16 times over, which is what they wait on
// (TMA tiles, wgmma and larger query tiles are the next steps). PERF.md
// holds the measured times.
//
// The kernels allocate nothing and launch on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int QR = 16;        // query rows per block
constexpr int THREADS = 256;  // 8 warps

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared memory: sQ (QR x D) | sS (QR x T) | sP (QR x THREADS), all f32.
// vec: D % 4 == 0 and T % 4 == 0, so rows of sQ and sS are 16-byte aligned
// and read as float4.
template <typename T>
__global__ void __launch_bounds__(THREADS)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 int n, int D, float scale, int vec) {
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sS = sQ + QR * D;
  float* sP = sS + QR * n;

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * QR;
  const int nr = min(QR, n - r0);
  const size_t base = (size_t)blockIdx.y * n * D;
  const T* qb = q + base;
  const T* kb = k + base;
  const T* vb = v + base;
  T* ob = o + base;

  // the query tile in f32; rows past the end are zero (their scores are
  // computed and never used)
  for (int i = tid; i < QR * D; i += THREADS) {
    const int r = i / D;
    sQ[i] = (r < nr) ? to_f(qb[(size_t)r0 * D + i]) : 0.0f;
  }
  __syncthreads();

  // 1. scores
  for (int j = tid; j < n; j += THREADS) {
    float acc[QR];
#pragma unroll
    for (int r = 0; r < QR; ++r) acc[r] = 0.0f;
    const T* kr = kb + (size_t)j * D;
    if (vec) {
      for (int d = 0; d < D; d += 4) {
        const float k0 = to_f(kr[d]), k1 = to_f(kr[d + 1]);
        const float k2 = to_f(kr[d + 2]), k3 = to_f(kr[d + 3]);
#pragma unroll
        for (int r = 0; r < QR; ++r) {
          const float4 qv = *reinterpret_cast<const float4*>(sQ + r * D + d);
          acc[r] = fmaf(qv.x, k0, acc[r]);
          acc[r] = fmaf(qv.y, k1, acc[r]);
          acc[r] = fmaf(qv.z, k2, acc[r]);
          acc[r] = fmaf(qv.w, k3, acc[r]);
        }
      }
    } else {
      for (int d = 0; d < D; ++d) {
        const float kd = to_f(kr[d]);
#pragma unroll
        for (int r = 0; r < QR; ++r) acc[r] = fmaf(sQ[r * D + d], kd, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < QR; ++r) sS[r * n + j] = __fmul_rn(acc[r], scale);
  }
  __syncthreads();

  // 2. exact softmax per row, probabilities rounded to v's dtype
  const int warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < nr; r += THREADS / 32) {
    float* row = sS + r * n;
    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float sum = 0.0f;
    for (int j = lane; j < n; j += 32) {
      const float p = expf(row[j] - m);
      row[j] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < n; j += 32) row[j] = to_f(from_f<T>(__fdiv_rn(row[j], sum)));
  }
  __syncthreads();

  // 3. o = a . v: L output columns per pass, S slices of the key range
  const int L = min(D, THREADS);
  const int S = THREADS / L;
  const int dl = tid % L;
  const int split = tid / L;
  int chunk = (n + S - 1) / S;
  if (vec) chunk = (chunk + 3) & ~3;
  const int j0 = min(split * chunk, n);
  const int j1 = min(j0 + chunk, n);
  for (int d0 = 0; d0 < D; d0 += L) {
    const int d = d0 + dl;
    float acc[QR];
#pragma unroll
    for (int r = 0; r < QR; ++r) acc[r] = 0.0f;
    if (split < S && d < D) {
      if (vec) {
        for (int j = j0; j < j1; j += 4) {
          const float v0 = to_f(vb[(size_t)j * D + d]);
          const float v1 = to_f(vb[(size_t)(j + 1) * D + d]);
          const float v2 = to_f(vb[(size_t)(j + 2) * D + d]);
          const float v3 = to_f(vb[(size_t)(j + 3) * D + d]);
#pragma unroll
          for (int r = 0; r < QR; ++r) {
            const float4 a = *reinterpret_cast<const float4*>(sS + r * n + j);
            acc[r] = fmaf(a.x, v0, acc[r]);
            acc[r] = fmaf(a.y, v1, acc[r]);
            acc[r] = fmaf(a.z, v2, acc[r]);
            acc[r] = fmaf(a.w, v3, acc[r]);
          }
        }
      } else {
        for (int j = j0; j < j1; ++j) {
          const float vj = to_f(vb[(size_t)j * D + d]);
#pragma unroll
          for (int r = 0; r < QR; ++r) acc[r] = fmaf(sS[r * n + j], vj, acc[r]);
        }
      }
    }
    if (split < S) {
#pragma unroll
      for (int r = 0; r < QR; ++r) sP[(split * QR + r) * L + dl] = acc[r];
    }
    __syncthreads();
    for (int i = tid; i < nr * L; i += THREADS) {
      const int r = i / L, c = i - r * L;
      if (d0 + c < D) {
        float s = 0.0f;
        for (int sp = 0; sp < S; ++sp) s += sP[(sp * QR + r) * L + c];
        ob[(size_t)(r0 + r) * D + d0 + c] = from_f<T>(s);
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// bf16 tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int TC_WARPS = 8;
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int TC_NB = 4;  // 8-key tiles per warp pass in phase 1
constexpr int TC_KB = 4;  // 16-key steps per batch of v loads in phase 3

// c += a . b for one m16n8k16 tile: a (16x16, row-major) in 4 registers,
// b (16x8, column-major) in 2, c (16x8) f32 in 4 (PTX ISA fragment layouts:
// g = lane / 4, t = lane % 4; a0 = A[g][2t..2t+1], a1 = A[g+8][2t..],
// a2 = A[g][2t+8..], a3 = A[g+8][2t+8..]; b0 = B[2t..2t+1][g],
// b1 = B[2t+8..2t+9][g]; c0,c1 = C[g][2t..2t+1], c2,c3 = C[g+8][2t..]).
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// Shared memory: sS (QR x n f32 score rows; row r's bf16 probabilities
// later fill its first 2n bytes) | sQ (QR x Dq bf16, zero past D).
// Requires D % 8 == 0 and n % 8 == 0, so no bf16 pair straddles an edge.
__global__ void __launch_bounds__(TC_THREADS)
attention_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                    int n, int D, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int Dq = (D + 15) & ~15;
  float* sS = smem;
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(sS + QR * n);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * QR;
  const int nr = min(QR, n - r0);
  const size_t base = (size_t)blockIdx.y * n * D;
  const __nv_bfloat16* kb = k + base;
  const __nv_bfloat16* vb = v + base;

  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  for (int i = tid; i < QR * Dq; i += TC_THREADS) {
    const int r = i / Dq, d = i - r * Dq;
    sQ[i] = (r < nr && d < D) ? q[base + (size_t)(r0 + r) * D + d] : zero;
  }
  __syncthreads();

  // 1. scores: warp w takes TC_NB adjacent 8-key tiles per pass, and
  // issues all their k loads of a 16-wide step before the products, so
  // 2*TC_NB loads are in flight per thread (the loop is latency-bound)
  for (int nt0 = warp * TC_NB; nt0 * 8 < n; nt0 += TC_WARPS * TC_NB) {
    float c[TC_NB][4];
#pragma unroll
    for (int i = 0; i < TC_NB; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.0f;
    for (int k0 = 0; k0 < Dq; k0 += 16) {
      uint32_t a[4], b[TC_NB][2];
#pragma unroll
      for (int i = 0; i < TC_NB; ++i) {
        const int key = (nt0 + i) * 8 + g;  // tiles are whole: n % 8 == 0
        const __nv_bfloat16* kr = kb + (size_t)key * D;
        const bool in = key < n;
        b[i][0] = (in && k0 + 2 * t < D)
                      ? __ldg(reinterpret_cast<const unsigned int*>(kr + k0 + 2 * t)) : 0u;
        b[i][1] = (in && k0 + 8 + 2 * t < D)
                      ? __ldg(reinterpret_cast<const unsigned int*>(kr + k0 + 8 + 2 * t)) : 0u;
      }
      a[0] = *reinterpret_cast<const uint32_t*>(sQ + g * Dq + k0 + 2 * t);
      a[1] = *reinterpret_cast<const uint32_t*>(sQ + (g + 8) * Dq + k0 + 2 * t);
      a[2] = *reinterpret_cast<const uint32_t*>(sQ + g * Dq + k0 + 8 + 2 * t);
      a[3] = *reinterpret_cast<const uint32_t*>(sQ + (g + 8) * Dq + k0 + 8 + 2 * t);
#pragma unroll
      for (int i = 0; i < TC_NB; ++i) mma_bf16(c[i], a, b[i]);
    }
#pragma unroll
    for (int i = 0; i < TC_NB; ++i) {
      const int col = (nt0 + i) * 8 + 2 * t;
      if (col < n) {
        sS[g * n + col] = __fmul_rn(c[i][0], scale);
        sS[g * n + col + 1] = __fmul_rn(c[i][1], scale);
        sS[(g + 8) * n + col] = __fmul_rn(c[i][2], scale);
        sS[(g + 8) * n + col + 1] = __fmul_rn(c[i][3], scale);
      }
    }
  }
  __syncthreads();

  // 2. exact softmax per row; the bf16 probabilities overwrite the front
  // half of the row: in round i the warp reads floats [32i, 32i+32) and
  // writes bf16 [32i, 32i+32), i.e. bytes [64i, 64i+64), which only rounds
  // <= i have read (hence the __syncwarp between read and write)
  for (int r = warp; r < QR; r += TC_WARPS) {
    float* row = sS + r * n;
    __nv_bfloat16* prow = reinterpret_cast<__nv_bfloat16*>(row);
    if (r >= nr) {  // padding rows: zero probabilities
      for (int j = lane; j < n; j += 32) prow[j] = zero;
      continue;
    }
    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float sum = 0.0f;
    for (int j = lane; j < n; j += 32) {
      const float p = expf(row[j] - m);
      row[j] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    for (int j0 = 0; j0 < n; j0 += 32) {
      const int j = j0 + lane;
      const float p = (j < n) ? row[j] : 0.0f;
      __syncwarp();
      if (j < n) prow[j] = __float2bfloat16_rn(__fdiv_rn(p, sum));
      __syncwarp();
    }
  }
  __syncthreads();

  // 3. o = a . v: warp w takes the 8-column tiles w, w + 8, ...; the v
  // loads of TC_KB 16-key steps are issued before their products
  for (int nt = warp; nt * 8 < D; nt += TC_WARPS) {
    const int d = nt * 8 + g;  // < D, as D % 8 == 0
    float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const __nv_bfloat16* pg = reinterpret_cast<const __nv_bfloat16*>(sS + g * n);
    const __nv_bfloat16* pg8 = reinterpret_cast<const __nv_bfloat16*>(sS + (g + 8) * n);
    const __nv_bfloat16* vd = vb + d;
    for (int kk = 0; kk < n; kk += 16 * TC_KB) {
      __nv_bfloat16 vv[TC_KB][4];
#pragma unroll
      for (int s = 0; s < TC_KB; ++s) {
        // keys j0, j0+1 and j1, j1+1 of step s; past n (n % 16 == 8, or the
        // last batch) they are zero
        const int j0 = kk + 16 * s + 2 * t, j1 = j0 + 8;
        vv[s][0] = (j0 < n) ? vd[(size_t)j0 * D] : zero;
        vv[s][1] = (j0 < n) ? vd[(size_t)(j0 + 1) * D] : zero;
        vv[s][2] = (j1 < n) ? vd[(size_t)j1 * D] : zero;
        vv[s][3] = (j1 < n) ? vd[(size_t)(j1 + 1) * D] : zero;
      }
#pragma unroll
      for (int s = 0; s < TC_KB; ++s) {
        const int j0 = kk + 16 * s + 2 * t, j1 = j0 + 8;
        uint32_t a[4], b[2];
        a[0] = (j0 < n) ? *reinterpret_cast<const uint32_t*>(pg + j0) : 0u;
        a[1] = (j0 < n) ? *reinterpret_cast<const uint32_t*>(pg8 + j0) : 0u;
        a[2] = (j1 < n) ? *reinterpret_cast<const uint32_t*>(pg + j1) : 0u;
        a[3] = (j1 < n) ? *reinterpret_cast<const uint32_t*>(pg8 + j1) : 0u;
        b[0] = pack_bf16(vv[s][0], vv[s][1]);
        b[1] = pack_bf16(vv[s][2], vv[s][3]);
        mma_bf16(c, a, b);
      }
    }
    const int col = nt * 8 + 2 * t;
    __nv_bfloat16* og = o + base + (size_t)(r0 + g) * D + col;
    if (g < nr)
      *reinterpret_cast<uint32_t*>(og) =
          pack_bf16(__float2bfloat16_rn(c[0]), __float2bfloat16_rn(c[1]));
    if (g + 8 < nr)
      *reinterpret_cast<uint32_t*>(og + (size_t)8 * D) =
          pack_bf16(__float2bfloat16_rn(c[2]), __float2bfloat16_rn(c[3]));
  }
}

bool use_tc(int n, int D, int dtype) { return dtype == 1 && D % 8 == 0 && n % 8 == 0; }

size_t smem_bytes(int n, int D, int dtype) {
  if (use_tc(n, D, dtype))
    return sizeof(float) * (size_t)QR * n + 2 * (size_t)QR * ((D + 15) & ~15);
  return sizeof(float) * (size_t)QR * (D + n + THREADS);
}

int launch_tc(const void* q, const void* k, const void* v, void* o, int BH, int n, int D,
              float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(n, D, 1);
  cudaError_t err = cudaFuncSetAttribute(attention_tc_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + QR - 1) / QR, BH);
  attention_tc_kernel<<<grid, TC_THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)o, n, D, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int BH, int n, int D,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(n, D, 0);
  cudaError_t err = cudaFuncSetAttribute(attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = (D % 4 == 0) && (n % 4 == 0);
  const dim3 grid((n + QR - 1) / QR, BH);
  attention_kernel<T><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, n, D, scale, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory one block needs, for the wrapper's check.
extern "C" int attention_smem_bytes(int n, int D, int dtype) {
  return (int)smem_bytes(n, D, dtype);
}

// C entry point for ctypes. q, k, v, o: contiguous (BH, n, D) of one dtype
// (dtype 0 = float32, 1 = bfloat16) on one device; o is written. The caller
// guarantees 0 < BH <= 65535 and that the shared memory fits. Returns
// cudaGetLastError() of the launch as an int (0 = launched).
extern "C" int attention_launch(const void* q, const void* k, const void* v, void* o,
                                int BH, int n, int D, float scale, int dtype,
                                void* stream) {
  if (BH == 0 || n == 0) return 0;
  if (use_tc(n, D, dtype))
    return launch_tc(q, k, v, o, BH, n, D, scale, (cudaStream_t)stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, BH, n, D, scale, (cudaStream_t)stream);
  return launch<float>(q, k, v, o, BH, n, D, scale, (cudaStream_t)stream);
}
