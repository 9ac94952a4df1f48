// Dense non-causal attention for Hopper: o = softmax(q k^T * scale) v per
// (batch, head), with the softmax taken exactly over each full score row.
//
// Replaces livetalking_tpu/ops/pallas_attention.py::_attn_kernel (the TPU
// kernel behind _pallas_forward / vmem_attention). Same function, same
// order of roundings:
//   s = (q . k) * scale      f32 products of the (bf16 or f32) inputs, f32 sums
//   m = max_j s,  p = exp(s - m),  a = p / sum_j p      all f32
//   a is rounded to v's dtype, then o = a . v with f32 sums, rounded to v's dtype
//
// bf16 with D % 8 == 0 and 16-byte aligned tensors (every shape of the
// MuseTalk path) runs on the tensor cores (mma.sync m16n8k16 bf16, f32
// accumulators) in two passes over the key tiles:
//   pass 1  the scores of every key tile; each row's running max m and sum
//           l of exp(s - m) in f32 (the sum rescaled by exp(m_old - m_new)
//           when the max grows; nothing else is rescaled);
//   pass 2  the scores again; a = bf16(exp(s - m) / l); o += a . v.
// So a is rounded to bf16 after the f32 division by the whole row's sum, as
// in the reference, and no score is stored: any T runs. Per score: the max
// is taken on q.k (scale > 0 keeps the order, a negative scale reverses
// it), exp(s - m) = 2^(q.k * (scale log2 e) - m log2 e) with one FFMA and
// ex2.approx (within about 1e-6 relative of exp(s - m) for s - m > -20),
// and p / l is p * r corrected by two FFMAs with r = 1/l correctly rounded
// (Markstein), the bits of __fdiv_rn(p, l) wherever the quotient is a
// normal float. The price of the two passes is a second q.k^T and a second
// exponential per score.
//
// K and V tiles are staged in shared memory by 16-byte cp.async (zero-filled
// past T and past D) in two slots, so the load of step i + 1 runs under the
// products of step i; pass 2's first tile is loaded under pass 1's last.
// Rows are padded by 16 bytes (an odd number of 16-byte units), so the
// ldmatrix reads of 8 rows hit 8 different bank groups. k^T fragments come
// from ldmatrix, v fragments from ldmatrix.trans.
//
//   attention_tc_kernel<NK>, D <= 160 (DP = 16 NK >= D): 4 warps, 64-key
//     tiles; a warp owns MT m16 row tiles (MT = 2 up to D = 64, so the k
//     and v fragments serve two row tiles, else 1): 64 MT query rows per
//     block. A warp keeps its q fragments (4 NK MT registers), its scores
//     (32 MT) and its output (8 NK MT) in registers; the scores'
//     accumulator layout is the a operand's layout of the product with v,
//     so the probabilities never leave registers. Shared memory: q tile +
//     2 slots of k and v, rows of 2 DP + 16 bytes: (64 MT + 256)(2 DP + 16)
//     bytes, 43,008 at D = 40, 56,320 at D = 80, 107,520 at D = 160. k and
//     v are read T/128 times per (batch, head) at D = 40 (the first port
//     read them T/16 times through L1/L2). One __syncthreads a step: the
//     load of step s + 1 goes into the slot that step s - 1 read.
//   attention_wide_kernel, 160 < D <= 512 (the VAE's one 512-wide head):
//     16 warps, 64 query rows, 16-key tiles, D padded to 512. The output
//     columns are split across the warps (32 each: 4 x 4 m16n8 tiles, 64
//     f32 registers a thread, which leaves no room for q fragments), so
//     the probabilities go through shared memory: warp (m, d) computes the
//     scores of 16 rows over 128 of the 512 columns from q and k fragments
//     read by ldmatrix, the four partial tiles meet in shared memory and
//     are summed in a fixed order, the 512 threads take the row statistics
//     and write a as bf16, and each warp multiplies the 64 x 16 a tile by
//     its 32 columns of v. Shared memory: q 64 rows and 2 slots of k and v
//     (4 x 16 rows) of 1,040 bytes, partial scores 4 x 64 x 20 floats, a
//     64 x 48 bytes: 156,672 bytes, one block per SM. k and v are read
//     T/64 times per head. Three __syncthreads a step (the top one also
//     frees the slot, partial scores and a that step s - 1 read). Its
//     shared-memory traffic bounds it: the q fragments are read again for
//     every key tile and each k fragment by the 4 warps of a column range.
//
// attention_kernel, for f32 and any other shape, runs on the f32 CUDA
// cores: a block takes 16 query rows and holds their full f32 score rows in
// shared memory (16 T floats, so T is bounded by shared memory); in phase 1
// each thread owns keys and keeps 16 f32 sums; in phase 3 threads own
// output columns and slices of the keys, whose partial sums meet in shared
// memory. f32 inputs never go through the tensor cores (TF32 would round
// them).
//
// What bounds it on the H100: operations. 4 T^2 D flops per (batch, head)
// against 4 T D 2 bytes of q/k/v/o, far right of the ridge at every
// MuseTalk shape, and B H T^2 exponentials at 16 per SM per clock. The two
// passes do 6 T^2 D flops and two exponentials per score, and mma.sync
// reaches part of the tensor-core rate that wgmma does. At D = 40 the
// per-score f32 work (two exponentials, the division, the max and sums)
// takes more issue slots than the products, and each step's dependent
// chain (products, row max, shuffles, sums) runs with 8 warps per SM; a
// deeper k/v ring did not help, so loads are not what it waits on. At
// D = 512 the shared-memory traffic above bounds it. Left for later:
// wgmma with TMA-fed k/v tiles and a producer warp, and one pass with the
// scores held in shared memory where T is small enough. PERF.md holds the
// measured times.
//
// The kernels allocate nothing and launch on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
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
// bf16 tensor-core kernels
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; with pred false nothing is read and the 16
// bytes are zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a . b for one m16n8k16 tile: a (16x16, row-major) in 4 registers,
// b (16x8, column-major) in 2, c (16x8) f32 in 4 (PTX ISA fragment layouts:
// g = lane / 4, t = lane % 4; a0 = A[g][2t..2t+1], a1 = A[g+8][2t..],
// a2 = A[g][2t+8..], a3 = A[g+8][2t+8..]; b0 = B[2t..2t+1][g],
// b1 = B[2t+8..2t+9][g]; c0,c1 = C[g][2t..2t+1], c2,c3 = C[g+8][2t..]).
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the SFU (ex2.approx: at most 2 ulp from 2^x; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// p / l from r = __frcp_rn(l): the product corrected by its exact residual
// (Markstein); equal to __fdiv_rn(p, l) wherever the quotient is normal
__device__ __forceinline__ float div_by(float p, float l, float r) {
  const float q = __fmul_rn(p, r);
  return __fmaf_rn(__fmaf_rn(-q, l, p), r, q);
}

// Rows [r0, r0 + ROWS) of a (n x D) bf16 matrix into a shared tile of
// ROWS x CH 16-byte chunks, row stride lds bytes; rows past n and chunks
// past D are zero.
template <int ROWS, int CH, int NTHREADS>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src, int r0, int n,
                                          int D, int lds, int tid) {
  const int dch = D >> 3;
#pragma unroll 4
  for (int i = tid; i < ROWS * CH; i += NTHREADS) {
    const int r = i / CH, c = i - r * CH;
    const bool ok = r0 + r < n && c < dch;
    cp_async16(dst + r * lds + c * 16, ok ? src + (size_t)(r0 + r) * D + c * 8 : src, ok);
  }
}

constexpr int TK = 64;  // keys per tile
constexpr int TC_THREADS = 128;  // 4 warps
constexpr int TC_MAX_NK = 10;    // D <= 160
constexpr int TC_SLOTS = 2;      // k (and v) tiles in flight: steps s and s + 1

// 16-row m tiles per warp: two up to D = 64 (the k and v fragments then
// serve two row tiles; the registers of a third would not fit), else one
__host__ __device__ constexpr int tc_mt(int nk) { return nk <= 4 ? 2 : 1; }
template <int NK>
__host__ __device__ constexpr int tc_lds() { return 32 * NK + 16; }  // bytes per row: 2 DP + 16
template <int NK>
__host__ __device__ constexpr int tc_rows() { return 64 * tc_mt(NK); }  // query rows per block

// Shared memory: q (tc_rows rows) | TC_SLOTS k slots | TC_SLOTS v slots (TK rows each).
template <int NK>
__global__ void __launch_bounds__(TC_THREADS)
attention_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                    int n, int D, float scale) {
  constexpr int CH = 2 * NK;  // 16-byte chunks per row; also 8-column output tiles
  constexpr int LDS = tc_lds<NK>();
  constexpr int MT = tc_mt(NK);
  constexpr int QB = tc_rows<NK>();
  extern __shared__ __align__(16) float smem[];  // one name and type for every kernel
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sK = sQ + QB * LDS;
  const uint32_t sV = sK + TC_SLOTS * TK * LDS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * QB;
  const size_t base = (size_t)blockIdx.y * n * D;
  const __nv_bfloat16* kb = k + base;
  const __nv_bfloat16* vb = v + base;
  const int ntiles = (n + TK - 1) / TK;
  const int steps = 2 * ntiles;  // pass 1: k tiles; pass 2: k and v tiles

  // the ring: step ld goes to slot ld_slot; every step commits one group
  int ld = 0, ld_slot = 0;
  auto load_next = [&]() {
    if (ld < steps) {
      const int j = ld < ntiles ? ld : ld - ntiles;
      load_tile<TK, CH, TC_THREADS>(sK + ld_slot * TK * LDS, kb, j * TK, n, D, LDS, tid);
      if (ld >= ntiles)
        load_tile<TK, CH, TC_THREADS>(sV + ld_slot * TK * LDS, vb, j * TK, n, D, LDS, tid);
    }
    cp_async_commit();
    ++ld;
    ld_slot = ld_slot + 1 == TC_SLOTS ? 0 : ld_slot + 1;
  };

  load_tile<QB, CH, TC_THREADS>(sQ, q + base, q0, n, D, LDS, tid);  // in step 0's group
#pragma unroll
  for (int i = 0; i < TC_SLOTS - 1; ++i) load_next();

  // warp w owns query rows q0 + 16 (MT w + mt) + {g, g + 8}, mt < MT
  uint32_t qf[MT][NK][4];
  float m[MT][2], l[MT][2], rl[MT][2];
  // a negative scale is applied as -q (exact) times |scale|; sl > 0 keeps
  // exp(-inf) = 0 for the keys past T
  const float sc = fabsf(scale);
  const float sl = fmaxf(__fmul_rn(sc, LOG2E), FLT_MIN);
  float acc[MT][CH][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = rl[mt][0] = rl[mt][1] = 0.0f;
#pragma unroll
    for (int i = 0; i < CH; ++i) acc[mt][i][0] = acc[mt][i][1] = acc[mt][i][2] = acc[mt][i][3] = 0.0f;
  }

  int slot = 0;
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<TC_SLOTS - 2>();  // step s has landed
    __syncthreads();  // ... for every thread, and every warp is done with step s - 1
    load_next();      // step s + TC_SLOTS - 1, into step s - 1's slot
    if (s == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int kk = 0; kk < NK; ++kk)
          ldmatrix_x4(qf[mt][kk], sQ + ((warp * MT + mt) * 16 + (lane & 15)) * LDS + kk * 32 +
                                      (lane >> 4) * 16);
      if (scale < 0.0f) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int kk = 0; kk < NK; ++kk)
#pragma unroll
            for (int r = 0; r < 4; ++r) qf[mt][kk][r] ^= 0x80008000u;  // both bf16 signs
      }
    }
    const bool pass2 = s >= ntiles;
    const int j = pass2 ? s - ntiles : s;
    const uint32_t kt = sK + slot * TK * LDS;

    // c = q . k^T for the warp's rows and the tile's 64 keys (s = c * scale)
    float c[MT][8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 8; ++i) c[mt][i][0] = c[mt][i][1] = c[mt][i][2] = c[mt][i][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, kt + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LDS + kk * 32 +
                           ((lane >> 3) & 1) * 16);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(c[mt][2 * np], qf[mt][kk], b[0], b[1]);
          mma_bf16(c[mt][2 * np + 1], qf[mt][kk], b[2], b[3]);
        }
      }
    }
    // keys past T weigh nothing: c = -inf drops them from the max and
    // gives p = 0
    const int key0 = j * TK;
    if (key0 + TK > n) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (key0 + i * 8 + 2 * t + (e & 1) >= n) c[mt][i][e] = -INFINITY;
    }

    if (!pass2) {
      // running max and sum of rows g (h = 0) and g + 8 (h = 1) of each m
      // tile; the four lanes of a quad share a row and keep partial sums.
      // The max of s = c * |scale| is taken on c (rounding is monotonic)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // max and sum as trees (short dependency chains)
          float r[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) r[i] = fmaxf(c[mt][i][2 * h], c[mt][i][2 * h + 1]);
#pragma unroll
          for (int w = 4; w > 0; w >>= 1)
#pragma unroll
            for (int i = 0; i < w; ++i) r[i] = fmaxf(r[i], r[i + w]);
          float mx = fmaxf(r[0], __shfl_xor_sync(0xffffffffu, r[0], 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float mn = fmaxf(m[mt][h], __fmul_rn(mx, sc));
          const float ml = __fmul_rn(mn, LOG2E);
#pragma unroll
          for (int i = 0; i < 8; ++i)
            r[i] = ex2(fmaf(c[mt][i][2 * h], sl, -ml)) + ex2(fmaf(c[mt][i][2 * h + 1], sl, -ml));
#pragma unroll
          for (int w = 4; w > 0; w >>= 1)
#pragma unroll
            for (int i = 0; i < w; ++i) r[i] += r[i + w];
          l[mt][h] = l[mt][h] * ex2(__fmul_rn(m[mt][h] - mn, LOG2E)) + r[0];
          m[mt][h] = mn;
        }
      if (s == ntiles - 1) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            l[mt][h] += __shfl_xor_sync(0xffffffffu, l[mt][h], 1);
            l[mt][h] += __shfl_xor_sync(0xffffffffu, l[mt][h], 2);
            rl[mt][h] = __frcp_rn(l[mt][h]);
            m[mt][h] = __fmul_rn(m[mt][h], LOG2E);  // pass 2 wants m log2 e
          }
      }
    } else {
      // a = bf16(exp(s - m) / l), laid out as the a operand of a . v
      const uint32_t vt = sV + slot * TK * LDS;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int i = 2 * kk + u;  // the 8-key score tile of a2u, a2u+1
            float p[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int h = e >> 1;
              p[e] = div_by(ex2(fmaf(c[mt][i][e], sl, -m[mt][h])), l[mt][h], rl[mt][h]);
            }
            a[mt][2 * u] = pack_bf16(p[0], p[1]);
            a[mt][2 * u + 1] = pack_bf16(p[2], p[3]);
          }
#pragma unroll
        for (int np = 0; np < NK; ++np) {
          if (np * 16 < D) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS +
                                     np * 32 + (lane >> 4) * 16);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
              mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
            }
          }
        }
      }
    }
    slot = slot + 1 == TC_SLOTS ? 0 : slot + 1;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r = q0 + (warp * MT + mt) * 16 + g;
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int col = i * 8 + 2 * t;
      if (col < D) {
        __nv_bfloat16* og = o + base + (size_t)r * D + col;
        if (r < n) *reinterpret_cast<uint32_t*>(og) = pack_bf16(acc[mt][i][0], acc[mt][i][1]);
        if (r + 8 < n)
          *reinterpret_cast<uint32_t*>(og + (size_t)8 * D) =
              pack_bf16(acc[mt][i][2], acc[mt][i][3]);
      }
    }
  }
}

// --- D in (160, 512] ---

constexpr int WQ = 64;          // query rows per block
constexpr int WK = 16;          // keys per tile
constexpr int WD = 512;         // head dim the tiles are padded to
constexpr int W_THREADS = 512;  // 16 warps
constexpr int WLDS = 2 * WD + 16;  // bytes per q/k/v row
constexpr int SPL = WK + 4;        // floats per partial-score row
constexpr int PLDS = 2 * WK + 16;  // bytes per probability row
constexpr int W_SLOTS = 2;         // k (and v) tiles in flight: steps s and s + 1
constexpr size_t W_SMEM =
    (size_t)(WQ + 2 * W_SLOTS * WK) * WLDS + 4 * WQ * SPL * 4 + WQ * PLDS;

// Shared memory: q | W_SLOTS k slots | W_SLOTS v slots | partial scores
// (4 x WQ x SPL f32) | a (WQ x PLDS bytes).
__global__ void __launch_bounds__(W_THREADS)
attention_wide_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                      int n, int D, float scale) {
  constexpr int CH = WD / 8;
  extern __shared__ __align__(16) float smem[];
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sK = sQ + WQ * WLDS;
  const uint32_t sV = sK + W_SLOTS * WK * WLDS;
  float* sS = reinterpret_cast<float*>(reinterpret_cast<uint8_t*>(smem) +
                                       (WQ + 2 * W_SLOTS * WK) * WLDS);
  uint8_t* sPp = reinterpret_cast<uint8_t*>(sS + 4 * WQ * SPL);
  const uint32_t sP = smem_u32(sPp);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mt = warp & 3, dq = warp >> 2;  // score rows 16 mt.., columns 128 dq..
  const int q0 = blockIdx.x * WQ;
  const size_t base = (size_t)blockIdx.y * n * D;
  const __nv_bfloat16* kb = k + base;
  const __nv_bfloat16* vb = v + base;
  const int ntiles = (n + WK - 1) / WK;
  const int steps = 2 * ntiles;

  // the ring: step ld goes to slot ld_slot; every step commits one group
  int ld = 0, ld_slot = 0;
  auto load_next = [&]() {
    if (ld < steps) {
      const int j = ld < ntiles ? ld : ld - ntiles;
      load_tile<WK, CH, W_THREADS>(sK + ld_slot * WK * WLDS, kb, j * WK, n, D, WLDS, tid);
      if (ld >= ntiles)
        load_tile<WK, CH, W_THREADS>(sV + ld_slot * WK * WLDS, vb, j * WK, n, D, WLDS, tid);
    }
    cp_async_commit();
    ++ld;
    ld_slot = ld_slot + 1 == W_SLOTS ? 0 : ld_slot + 1;
  };
  load_tile<WQ, CH, W_THREADS>(sQ, q + base, q0, n, D, WLDS, tid);  // in step 0's group
#pragma unroll
  for (int i = 0; i < W_SLOTS - 1; ++i) load_next();

  // the softmax phase: thread tid owns row er, keys ek, ek + 1
  const int er = tid >> 3, ek = (tid & 7) * 2;
  float m = -INFINITY, l = 0.0f, rl = 0.0f;
  // a negative scale is applied as -(q.k) times |scale|; sl > 0 keeps
  // exp(-inf) = 0 for the keys past T
  const float sgn = scale < 0.0f ? -1.0f : 1.0f, sc = fabsf(scale);
  const float sl = fmaxf(__fmul_rn(sc, LOG2E), FLT_MIN);
  // o[:, 32 warp ..]: 4 m tiles x 4 column tiles
  float acc[4][4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[a][i][0] = acc[a][i][1] = acc[a][i][2] = acc[a][i][3] = 0.0f;

  // one barrier at the top of a step orders step s - 1's reads of its
  // slot, of the partial scores and of a before this step rewrites them
  int slot = 0;
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<W_SLOTS - 2>();  // step s has landed
    __syncthreads();
    load_next();  // step s + W_SLOTS - 1, into step s - 1's slot
    const bool pass2 = s >= ntiles;
    const int j = pass2 ? s - ntiles : s;
    const uint32_t kt = sK + slot * WK * WLDS;

    // partial scores of rows 16 mt.. and the tile's 16 keys over columns
    // 128 dq .. 128 dq + 127 (q and k fragments both from shared memory:
    // the output takes 64 registers a thread)
    {
      float c[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int col = (dq * 128 + kk * 16) * 2;
        uint32_t a[4], b[4];
        ldmatrix_x4(a, sQ + (mt * 16 + (lane & 15)) * WLDS + col + (lane >> 4) * 16);
        ldmatrix_x4(b, kt + ((lane & 7) + (lane >> 4) * 8) * WLDS + col + ((lane >> 3) & 1) * 16);
        mma_bf16(c[0], a, b[0], b[1]);
        mma_bf16(c[1], a, b[2], b[3]);
      }
      float* ps = sS + (dq * WQ + mt * 16 + g) * SPL + 2 * t;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        *reinterpret_cast<float2*>(ps + i * 8) = make_float2(c[i][0], c[i][1]);
        *reinterpret_cast<float2*>(ps + 8 * SPL + i * 8) = make_float2(c[i][2], c[i][3]);
      }
    }
    __syncthreads();

    // the four partials summed in a fixed order, signed; keys past T are -inf
    float sv[2];
    {
      const float* pr = sS + er * SPL + ek;
      const float2 p0 = *reinterpret_cast<const float2*>(pr);
      const float2 p1 = *reinterpret_cast<const float2*>(pr + WQ * SPL);
      const float2 p2 = *reinterpret_cast<const float2*>(pr + 2 * WQ * SPL);
      const float2 p3 = *reinterpret_cast<const float2*>(pr + 3 * WQ * SPL);
      sv[0] = sgn * (((p0.x + p1.x) + p2.x) + p3.x);
      sv[1] = sgn * (((p0.y + p1.y) + p2.y) + p3.y);
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (j * WK + ek + e >= n) sv[e] = -INFINITY;
    }
    if (!pass2) {
      // the 8 lanes of a row (consecutive) share its max and keep partial
      // sums; the max of s = c * |scale| is taken on c
      float mx = fmaxf(sv[0], sv[1]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float mn = fmaxf(m, __fmul_rn(mx, sc));
      const float ml = __fmul_rn(mn, LOG2E);
      const float sum = ex2(fmaf(sv[0], sl, -ml)) + ex2(fmaf(sv[1], sl, -ml));
      l = l * ex2(__fmul_rn(m - mn, LOG2E)) + sum;
      m = mn;
      if (s == ntiles - 1) {
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        l += __shfl_xor_sync(0xffffffffu, l, 4);
        rl = __frcp_rn(l);
        m = __fmul_rn(m, LOG2E);  // pass 2 wants m log2 e
      }
    } else {
      *reinterpret_cast<uint32_t*>(sPp + er * PLDS + ek * 2) =
          pack_bf16(div_by(ex2(fmaf(sv[0], sl, -m)), l, rl),
                    div_by(ex2(fmaf(sv[1], sl, -m)), l, rl));
      __syncthreads();

      // o[:, 32 warp ..] += a . v
      if (warp * 32 < D) {
        const uint32_t vt = sV + slot * WK * WLDS;
        uint32_t b[2][4];
#pragma unroll
        for (int np = 0; np < 2; ++np)
          ldmatrix_x4_trans(b[np], vt + ((lane & 7) + ((lane >> 3) & 1) * 8) * WLDS +
                                       (warp * 32 + np * 16) * 2 + (lane >> 4) * 16);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          uint32_t a[4];
          ldmatrix_x4(a, sP + (u * 16 + (lane & 15)) * PLDS + (lane >> 4) * 16);
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            mma_bf16(acc[u][2 * np], a, b[np][0], b[np][1]);
            mma_bf16(acc[u][2 * np + 1], a, b[np][2], b[np][3]);
          }
        }
      }
    }
    slot = slot + 1 == W_SLOTS ? 0 : slot + 1;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int r = q0 + u * 16 + g;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = warp * 32 + i * 8 + 2 * t;
      if (col < D) {
        __nv_bfloat16* og = o + base + (size_t)r * D + col;
        if (r < n) *reinterpret_cast<uint32_t*>(og) = pack_bf16(acc[u][i][0], acc[u][i][1]);
        if (r + 8 < n)
          *reinterpret_cast<uint32_t*>(og + (size_t)8 * D) = pack_bf16(acc[u][i][2], acc[u][i][3]);
      }
    }
  }
}

enum Path { F32_CORES, TC, WIDE };

Path path(int D, int dtype, int aligned) {
  if (dtype != 1 || D % 8 != 0 || !aligned) return F32_CORES;
  return D <= 16 * TC_MAX_NK ? TC : WIDE;
}

size_t smem_bytes(int n, int D, int dtype, int aligned) {
  switch (path(D, dtype, aligned)) {
    case TC: {
      const int nk = (D + 15) / 16;
      return (size_t)(64 * tc_mt(nk) + 2 * TC_SLOTS * TK) * (32 * nk + 16);
    }
    case WIDE: return W_SMEM;
    default: return sizeof(float) * (size_t)QR * (D + n + THREADS);
  }
}

template <typename K>
int launch_bf16(K kernel, dim3 grid, int threads, size_t smem, const void* q, const void* k,
                const void* v, void* o, int n, int D, float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, stream>>>((const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
                                          (const __nv_bfloat16*)v, (__nv_bfloat16*)o, n, D,
                                          scale);
  return (int)cudaGetLastError();
}

template <int NK>
int launch_tc(const void* q, const void* k, const void* v, void* o, int BH, int n, int D,
              float scale, cudaStream_t stream) {
  return launch_bf16(attention_tc_kernel<NK>, dim3((n + tc_rows<NK>() - 1) / tc_rows<NK>(), BH),
                     TC_THREADS, (size_t)(tc_rows<NK>() + 2 * TC_SLOTS * TK) * tc_lds<NK>(), q, k, v, o, n,
                     D, scale, stream);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int BH, int n, int D,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(n, D, 0, 0);
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

// Bytes of dynamic shared memory one block needs, for the wrapper's check;
// aligned: q, k, v and o all start on a 16-byte boundary.
extern "C" int attention_smem_bytes(int n, int D, int dtype, int aligned) {
  return (int)smem_bytes(n, D, dtype, aligned);
}

// C entry point for ctypes. q, k, v, o: contiguous (BH, n, D) of one dtype
// (dtype 0 = float32, 1 = bfloat16) on one device; o is written. The caller
// guarantees 0 < BH <= 65535 and that the shared memory fits. Returns
// cudaGetLastError() of the launch as an int (0 = launched).
extern "C" int attention_launch(const void* q, const void* k, const void* v, void* o,
                                int BH, int n, int D, float scale, int dtype,
                                void* stream) {
  if (BH == 0 || n == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const int aligned = (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) & 15) == 0;
  switch (path(D, dtype, aligned)) {
    case TC:
      switch ((D + 15) / 16) {
        case 1: return launch_tc<1>(q, k, v, o, BH, n, D, scale, s);
        case 2: return launch_tc<2>(q, k, v, o, BH, n, D, scale, s);
        case 3: return launch_tc<3>(q, k, v, o, BH, n, D, scale, s);
        case 4: return launch_tc<4>(q, k, v, o, BH, n, D, scale, s);
        case 5: return launch_tc<5>(q, k, v, o, BH, n, D, scale, s);
        case 6: return launch_tc<6>(q, k, v, o, BH, n, D, scale, s);
        case 7: return launch_tc<7>(q, k, v, o, BH, n, D, scale, s);
        case 8: return launch_tc<8>(q, k, v, o, BH, n, D, scale, s);
        case 9: return launch_tc<9>(q, k, v, o, BH, n, D, scale, s);
        default: return launch_tc<10>(q, k, v, o, BH, n, D, scale, s);
      }
    case WIDE:
      return launch_bf16(attention_wide_kernel, dim3((n + WQ - 1) / WQ, BH), W_THREADS, W_SMEM,
                         q, k, v, o, n, D, scale, s);
    default:
      if (dtype == 1) return launch<__nv_bfloat16>(q, k, v, o, BH, n, D, scale, s);
      return launch<float>(q, k, v, o, BH, n, D, scale, s);
  }
}
