// GroupNorm, and GroupNorm followed by SiLU, of NHWC bf16 activations for
// Hopper: the norms of the bf16 MuseTalk step (the U-Net's resnets,
// transformers and norm_out, the VAE decoder's resnets, mid attention and
// norm_out).
//
// Replaces no TPU kernel: the JAX package leaves GroupNorm to XLA, which
// fuses the statistics and the affine into the neighbouring ops. The port's
// eager version (ops/norm.py::group_norm_plain: x.float(), x*x, two
// reductions over (H, W), a dozen (B, C) ops, the broadcast affine, the cast,
// then SiLU's cast, silu and cast) moves about 64 bytes per activation
// element in some 26 launches; this pair of kernels moves 6.
//
//   group_norm_moments_kernel  per-channel sums of x and x^2 (float32) of
//       each sample, per block, into a scratch buffer; the last block of a
//       sample to finish sums the blocks' partials in block order, then the
//       channels of each group in channel order, and writes the sample's
//       per-channel scale and shift with group_norm_plain's arithmetic:
//         mu = g1 / n, var = max(g2 / n - mu * mu, 0), inv = rsqrt(var + eps),
//         scale = inv * gamma, shift = beta - mu * scale   (n = H W C/groups)
//   group_norm_apply_kernel<SILU>  y = bf16(x * scale + shift) and, with
//       SILU, bf16(v / (1 + exp(-v))) of v = float(y): the plain version's
//       two roundings (a product and a sum each rounded on its own, the IEEE
//       division, expf; the file is built without fast math, so nothing is
//       contracted into an FMA).
//
// What bounds them on the H100: bytes. The moments launch reads x once (2
// bytes an element), the apply launch reads it again and writes y (4 bytes);
// the scratch is a few (B, C) float arrays. At the decoder's 256x256x128
// sites and B = 128 that is 2.1 GB read, 6.4 GB moved in all: 1.9 ms at
// 3.35 TB/s. SiLU's exp and division are about 30 instructions an element,
// below the instruction rate that streaming at that speed allows. PERF.md holds
// the measured times (83-87% of 3.35 TB/s on the 6 bytes at the decoder's
// sites from 64 px at B = 128; the U-Net's small sites are launch-bound).
//
// Design. Both launches share one division of the work, from ops/norm.py::
// group_norm_plan: a block of T = (C / 8) x R threads; thread t owns the 8
// channels (one 16-byte vector) c0 = 8 (t % (C / 8)) of pixel rows
// t / (C / 8), + R, + 2R, ... of its block's range of pixels, so a warp's
// loads cover consecutive 16-byte vectors of consecutive pixels (coalesced)
// and a thread's channels stay fixed: the moments accumulate in 16
// registers, and the apply launch loads its 8 scales and shifts once. The
// grid is (blocks per sample, B); a block's range is HW / blocks pixels. Four
// 16-byte loads are in flight per thread before they are used.
//   Moments: the R rows' sums meet in shared memory and are added in row
//   order; the block writes its 2C partials, fences, and takes a ticket
//   (atomicAdd on the sample's counter). The block that draws the last ticket
//   reads the partials from L2 (__ldcg), sums them in block order, resets the
//   counter for the next launch on the stream; one thread a group sums its
//   channels into mu and rsqrt(var + eps), then every thread writes the scale
//   and shift of channels tid, tid + T, ... (a serial loop over a group's
//   channels in one thread cost the U-Net's 8x8x2560 sites ~0.1 ms). A block
//   takes at least 32 pixels, so its 2C partials are at most a sixteenth of
//   what it reads.
//   Every sum runs in a fixed order, so the same input gives the same bits.
//   Apply: elementwise with the sample's scale and shift.
// The kernels allocate nothing and launch on the caller's stream; the
// wrapper owns the output and the scratch (cached per device and stream).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;  // T = (C / 8) R is at most this (C <= 4096)
constexpr int kMaxChannels = 4096;
constexpr int kMaxGroups = 512;
constexpr int kUnroll = 4;        // 16-byte loads in flight per thread

__device__ __forceinline__ void unpack8(const uint4& v, float f[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void accumulate(const uint4& v, float s1[8], float s2[8]) {
  float f[8];
  unpack8(v, f);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    s1[k] = __fadd_rn(s1[k], f[k]);
    // a bf16 value squared is exact in float32
    s2[k] = __fadd_rn(s2[k], __fmul_rn(f[k], f[k]));
  }
}

__device__ __forceinline__ float affine_at(const void* p, int c, int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[c])
                 : static_cast<const float*>(p)[c];
}

// The block's pixel range [p0, p1) of its sample.
__device__ __forceinline__ void block_range(int HW, long long& p0, long long& p1) {
  p0 = (long long)HW * blockIdx.x / gridDim.x;
  p1 = (long long)HW * (blockIdx.x + 1) / gridDim.x;
}

// x: (B, HW, C) bf16 as 16-byte vectors; part: (B, blocks, 2, C) f32;
// tickets: (B,) int32, zero on entry and on exit; scale, shift: (B, C) f32;
// gamma, beta: (C,) bf16 (affine_bf16) or f32.
__global__ void __launch_bounds__(kMaxThreads, 2)
    group_norm_moments_kernel(const uint4* __restrict__ x, const void* __restrict__ gamma,
                              const void* __restrict__ beta, int affine_bf16,
                              float* __restrict__ part, int* __restrict__ tickets,
                              float* __restrict__ scale, float* __restrict__ shift, int HW, int C,
                              int groups, float eps) {
  __shared__ float red[kMaxThreads * 16];
  __shared__ float gstat[2 * kMaxGroups];  // mu, then rsqrt(var + eps), by group
  __shared__ int is_last;
  const int V = C >> 3, T = blockDim.x, R = T / V;
  const int tid = threadIdx.x, cv = tid % V, row = tid / V;
  const int b = blockIdx.y, nb = gridDim.x;
  long long p0, p1;
  block_range(HW, p0, p1);
  const uint4* xs = x + (long long)b * HW * V + cv;

  float s1[8], s2[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) s1[k] = s2[k] = 0.f;
  long long p = p0 + row;
  for (; p + (long long)(kUnroll - 1) * R < p1; p += (long long)kUnroll * R) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldg(xs + (p + (long long)u * R) * V);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) accumulate(v[u], s1, s2);
  }
  for (; p < p1; p += R) accumulate(__ldg(xs + p * V), s1, s2);

  // the R rows' sums, added in row order: red[(row * 16 + k) * V + cv]
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    red[(row * 16 + k) * V + cv] = s1[k];
    red[(row * 16 + 8 + k) * V + cv] = s2[k];
  }
  __syncthreads();
  float* mine = part + ((long long)b * nb + blockIdx.x) * 2 * C;
  for (int i = tid; i < 16 * V; i += T) {  // i = k V + cv'
    float a = 0.f;
    for (int r = 0; r < R; ++r) a = __fadd_rn(a, red[r * 16 * V + i]);
    const int k = i / V;
    mine[(k >> 3) * C + (i % V) * 8 + (k & 7)] = a;
  }

  // the last block of the sample to finish reduces the partials
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(tickets + b, 1) == nb - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  float* tot = red;  // s1 at [0, C), s2 at [C, 2C)
  const float* all = part + (long long)b * nb * 2 * C;
  for (int i = tid; i < 2 * C; i += T) {
    float a = 0.f;
    int k = 0;
    for (; k + 8 <= nb; k += 8) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = __ldcg(all + (long long)(k + u) * 2 * C + i);
#pragma unroll
      for (int u = 0; u < 8; ++u) a = __fadd_rn(a, v[u]);
    }
    for (; k < nb; ++k) a = __fadd_rn(a, __ldcg(all + (long long)k * 2 * C + i));
    tot[i] = a;
  }
  __syncthreads();
  if (tid == 0) tickets[b] = 0;
  // group statistics, then each channel's scale and shift (all threads)
  const int cpg = C / groups;
  const float n = (float)((long long)HW * cpg);
  for (int g = tid; g < groups; g += T) {
    float g1 = 0.f, g2 = 0.f;
    for (int c = g * cpg; c < (g + 1) * cpg; ++c) {
      g1 = __fadd_rn(g1, tot[c]);
      g2 = __fadd_rn(g2, tot[C + c]);
    }
    const float mu = __fdiv_rn(g1, n);
    const float var = fmaxf(__fsub_rn(__fdiv_rn(g2, n), __fmul_rn(mu, mu)), 0.f);
    gstat[g] = mu;
    gstat[kMaxGroups + g] = rsqrtf(__fadd_rn(var, eps));
  }
  __syncthreads();
  for (int c = tid; c < C; c += T) {
    const int g = c / cpg;
    const float mu = gstat[g];
    const float sc = __fmul_rn(gstat[kMaxGroups + g], affine_at(gamma, c, affine_bf16));
    scale[(long long)b * C + c] = sc;
    shift[(long long)b * C + c] = __fsub_rn(affine_at(beta, c, affine_bf16), __fmul_rn(mu, sc));
  }
}

template <bool SILU>
__device__ __forceinline__ uint4 apply8(const uint4& v, const float sc[8], const float sh[8]) {
  float f[8];
  unpack8(v, f);
  uint4 o;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&o);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    __nv_bfloat16 y = __float2bfloat16_rn(__fadd_rn(__fmul_rn(f[k], sc[k]), sh[k]));
    if (SILU) {
      const float a = __bfloat162float(y);
      y = __float2bfloat16_rn(__fdiv_rn(a, __fadd_rn(1.f, expf(-a))));
    }
    h[k] = y;
  }
  return o;
}

// x, y: (B, HW, C) bf16 as 16-byte vectors; scale, shift: (B, C) f32.
template <bool SILU>
__global__ void __launch_bounds__(kMaxThreads, 2)
    group_norm_apply_kernel(const uint4* __restrict__ x, const float* __restrict__ scale,
                            const float* __restrict__ shift, uint4* __restrict__ y, int HW,
                            int C) {
  const int V = C >> 3, R = blockDim.x / V;
  const int tid = threadIdx.x, cv = tid % V, row = tid / V;
  const int b = blockIdx.y;
  long long p0, p1;
  block_range(HW, p0, p1);
  float sc[8], sh[8];
  const float4* s4 = reinterpret_cast<const float4*>(scale + (long long)b * C + cv * 8);
  const float4* h4 = reinterpret_cast<const float4*>(shift + (long long)b * C + cv * 8);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float4 s = s4[i], t = h4[i];
    sc[4 * i] = s.x, sc[4 * i + 1] = s.y, sc[4 * i + 2] = s.z, sc[4 * i + 3] = s.w;
    sh[4 * i] = t.x, sh[4 * i + 1] = t.y, sh[4 * i + 2] = t.z, sh[4 * i + 3] = t.w;
  }
  const long long base = (long long)b * HW * V + cv;
  long long p = p0 + row;
  for (; p + (long long)(kUnroll - 1) * R < p1; p += (long long)kUnroll * R) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldg(x + base + (p + (long long)u * R) * V);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      y[base + (p + (long long)u * R) * V] = apply8<SILU>(v[u], sc, sh);
  }
  for (; p < p1; p += R) y[base + p * V] = apply8<SILU>(__ldg(x + base + p * V), sc, sh);
}

}  // namespace

extern "C" int group_norm_max_threads() { return kMaxThreads; }

// x, y: (B, H W, C) bf16, contiguous, 16-byte aligned; gamma, beta: (C,) bf16
// (affine_bf16 = 1) or f32; part: (B, blocks, 2, C) f32; tickets: (B,) int32,
// zero (the launch leaves them zero); scale, shift: (B, C) f32, 16-byte
// aligned. C a multiple of 8 and of groups, at most 4096; at most 512
// groups; threads a multiple
// of C / 8, at most 512; 1 <= B <= 65535. Launches the moments kernel, then
// the apply kernel (with SiLU when silu != 0), on stream. Returns
// cudaErrorInvalidValue for arguments it cannot take, else
// cudaGetLastError() after the launches.
extern "C" int group_norm_launch(const void* x, const void* gamma, const void* beta,
                                 int affine_bf16, void* y, void* part, void* tickets, void* scale,
                                 void* shift, int B, int HW, int C, int groups, float eps,
                                 int silu, int threads, int blocks, void* stream) {
  if (B < 1 || B > 65535 || HW < 1 || C < 8 || C > kMaxChannels || C % 8 || groups < 1 ||
      groups > kMaxGroups || C % groups || threads < C / 8 || threads > kMaxThreads ||
      threads % (C / 8) || blocks < 1 || blocks > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(blocks, B);
  group_norm_moments_kernel<<<grid, threads, 0, s>>>(
      static_cast<const uint4*>(x), gamma, beta, affine_bf16, static_cast<float*>(part),
      static_cast<int*>(tickets), static_cast<float*>(scale), static_cast<float*>(shift), HW, C,
      groups, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (silu)
    group_norm_apply_kernel<true><<<grid, threads, 0, s>>>(
        static_cast<const uint4*>(x), static_cast<const float*>(scale),
        static_cast<const float*>(shift), static_cast<uint4*>(y), HW, C);
  else
    group_norm_apply_kernel<false><<<grid, threads, 0, s>>>(
        static_cast<const uint4*>(x), static_cast<const float*>(scale),
        static_cast<const float*>(shift), static_cast<uint4*>(y), HW, C);
  return (int)cudaGetLastError();
}
