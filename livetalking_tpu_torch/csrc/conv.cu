// int8 (and bf16) 3x3 stride-1 pad-1 convolutions for Hopper, NHWC, as
// implicit GEMMs on the tensor cores.
//
// Replaces the two Pallas kernels of livetalking_tpu/ops/pallas_conv.py:
//
//   conv3x3_kernel      <- _kernel (driven by _conv3x3_core through conv3x3_q
//                          and conv3x3_bf16): y = conv(x, w) * scale[o] + bias[o]
//                          (+ residual), int8 x int8 with int32 sums, or the
//                          bf16 twin with f32 sums.
//   conv3x3_gnq_kernel  <- _gnq_kernel (driven by conv3x3_gnq): GroupNorm apply
//                          a = x*scale[b,c] + shift[b,c], SiLU a*sigmoid(a),
//                          quantize q = clamp(rint(a / act), -127, 127),
//                          optional nearest-2x upsample of the input, int8 conv,
//                          y = acc * out_scale[o] + bias[o] (+ residual) -> bf16,
//                          and per-block partial sums of the bf16-rounded y and
//                          y^2 per (image, channel) for the next GroupNorm.
//
// Design. The GEMM is M = B*H*W output pixels by N = O output channels by
// K = 9*C (tap-major: K index (dy*3 + dx)*C + c, the weight layout
// (O, 3, 3, C) that diffusion_blocks.quantize_conv writes once). A block
// computes a BM = 128 pixel x BN = 64 or 128 channel tile with 8 warps
// (4 along M x 2 along N), walking K 64 bytes at a time: a stage is 64
// channels (int8) or 32 channels (bf16) of one tap, so its input rows are 128
// pixels shifted by (dy, dx), zero where the shifted pixel falls outside the
// image (the conv's padding ring). Products are mma.sync m16n8k32 s8 (int32
// sums) or m16n8k16 bf16 (f32 sums); both take 32 bytes of K per tile with
// the same register byte layout, so one ldmatrix-based inner loop serves
// both. Shared-memory rows are 80 bytes (64 + 16 padding), which makes the
// ldmatrix row reads conflict-free.
//   - conv3x3_kernel stages input and weights with 16-byte cp.async (zero
//     fill for the padding ring and ragged edges), 3 stages deep.
//   - conv3x3_gnq_kernel stages the weights the same way, 2 stages deep, and
//     the input through registers: it loads 16 bf16 channels of a pixel for
//     the next stage while the tensor cores work on this one, then applies
//     GN, SiLU and the quantize in f32 and stores 16 int8 values. Padding is
//     zero after the activation (activation-space padding, as the reference).
//     In upsample mode a shifted output pixel (h, w) reads source pixel
//     (h >> 1, w >> 1) of the half-size input. The block's 128 pixels lie in
//     one image (the wrapper requires H*W % 128 == 0), so it writes its
//     moment sums to its own (image, tile, channel) slot of a scratch
//     buffer; the wrapper adds the tiles. No atomics: the result does not
//     depend on the order blocks run in.
// Epilogues use __fmul_rn/__fadd_rn and divisions use __fdiv_rn (the file
// is built without fast math), so no contraction rounds differently from
// the plain PyTorch version. The TPU kernel's structure (a (TH+2)-row VMEM
// window, the dx taps folded on the output side, a sequential row-tile grid)
// exists for the TPU's sublane layout and is not carried over.
//
// What bounds them on the H100. int8: 2*M*N*K operations against the
// input, weights and output bytes; at MuseTalk's B=16 shapes every site is
// far right of the ridge (e.g. 256 px, 256 -> 256: 1.24 TOP for 79 MB), so
// the floor is the int8 tensor-core rate, 1,979 TOP/s (0.63 ms there).
// Summed over a B=16 step, that floor is 5.7 ms for the 80 int8 3x3
// convs (U-Net and unfused decoder) and 4.9 ms for the fused decode's 21
// conv3x3_gnq_kernel launches (chip_smoke.py computes both). mma.sync reaches only part of that rate on Hopper (wgmma and TMA are the
// way to the rest: later work), and the implicit GEMM re-reads each input
// pixel 9 times (once per tap) through L2. conv3x3_gnq_kernel also redoes
// GN + SiLU + quantize (an expf and two IEEE divisions per element) for
// each tap and each output-channel block: 9 * O/BN times per input
// element, which costs more than its tensor-core work at the decoder's
// shapes; computing the activations once per block (a halo tile) is the
// first redesign. PERF.md holds the measured times.
//
// The kernels allocate nothing and launch on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;       // output pixels per block
constexpr int BK = 64;        // K bytes per stage
constexpr int LDS = BK + 16;  // shared-memory row stride in bytes
constexpr int THREADS = 256;  // 8 warps: 4 along M (32 rows each) x 2 along N
constexpr int STAGES = 3;     // cp.async depth of conv3x3_kernel

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

// c += a . b over 32 bytes of K. Fragments (PTX ISA, g = lane / 4,
// t = lane % 4): a0 = row g, K bytes 4t..4t+3; a1 = row g+8, same bytes;
// a2, a3 = the same rows, bytes 16+4t..; b0 = column g, bytes 4t..4t+3;
// b1 = column g, bytes 16+4t..; c0, c1 = row g, columns 2t, 2t+1; c2, c3 =
// row g+8. The byte layout is the same for s8 (m16n8k32) and bf16 (m16n8k16).
__device__ __forceinline__ void mma(int c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float to_f(int v) { return __int2float_rn(v); }
__device__ __forceinline__ float to_f(float v) { return v; }

// One stage (BK bytes of K) of the block's tile. sA: BM rows, sB: BN rows
// of LDS bytes. Warp (warp_m, warp_n) owns rows warp_m*32 .. +32 and
// columns warp_n*BN/2 .. +BN/2: 2 x (BN/16) mma tiles.
template <typename Acc, int BN>
__device__ __forceinline__ void mma_stage(Acc (&acc)[2][BN / 16][4], uint32_t sA, uint32_t sB,
                                          int warp_m, int warp_n, int lane) {
  constexpr int NT = BN / 16;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 32) {
    uint32_t a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      // matrices: rows 0-7 | 8-15 of the m16 tile, bytes 0-15 | 16-31
      const int row = warp_m * 32 + mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      ldmatrix_x4(a[mt], sA + row * LDS + kk + (lane >> 4) * 16);
    }
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      // matrices: columns 0-7 bytes 0-15 | 0-7 bytes 16-31 | 8-15 | 8-15
      uint32_t b[4];
      const int row = warp_n * (BN / 2) + np * 16 + (lane & 7) + (lane >> 4) * 8;
      ldmatrix_x4(b, sB + row * LDS + kk + ((lane >> 3) & 1) * 16);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma(acc[mt][2 * np], a[mt], b[0], b[1]);
        mma(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
      }
    }
  }
}

template <bool INT8>
struct AccT {
  using type = int;
};
template <>
struct AccT<false> {
  using type = float;
};

// ---------------------------------------------------------------------------
// kernel 4: int8 (or bf16) input, cp.async staging
// ---------------------------------------------------------------------------

template <bool INT8, int BN>
__global__ void __launch_bounds__(THREADS)
conv3x3_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ w,
               const float* __restrict__ scale, const float* __restrict__ bias,
               const void* __restrict__ res, void* __restrict__ y, int H, int W, int C, int O,
               int M, int out_bf16, int has_res) {
  using Acc = typename AccT<INT8>::type;
  constexpr int NT = BN / 16;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* sA = smem;                      // STAGES x BM x LDS
  uint8_t* sB = smem + STAGES * BM * LDS;  // STAGES x BN x LDS

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp & 3, warp_n = warp >> 2;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int Cb = C * (INT8 ? 1 : 2);  // bytes per pixel
  const int Kb = 9 * Cb;              // bytes per weight row
  const int KT = Kb / BK;
  const int HW = H * W;

  // this thread stages input rows tid/4 and tid/4 + 64, 16-byte segment tid%4
  const int seg = tid & 3;
  int pix[2], ph[2], pw[2];
  bool pv[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int m = m0 + (tid >> 2) + 64 * u;
    pv[u] = m < M;
    pix[u] = pv[u] ? m : 0;  // m = (b*H + h)*W + w
    const int rem = pix[u] % HW;
    ph[u] = rem / W;
    pw[u] = rem - ph[u] * W;
  }

  auto load_stage = [&](int kt, int slot) {
    const int kb0 = kt * BK;
    const int tap = kb0 / Cb, cb0 = kb0 - tap * Cb;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const uint32_t a_base = smem_u32(sA + slot * BM * LDS);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = (tid >> 2) + 64 * u;
      const int hs = ph[u] + dy, ws = pw[u] + dx;
      const bool ok = pv[u] && hs >= 0 && hs < H && ws >= 0 && ws < W;
      const uint8_t* src = ok ? x + (size_t)(pix[u] + dy * W + dx) * Cb + cb0 + seg * 16 : x;
      cp_async16(a_base + r * LDS + seg * 16, src, ok);
    }
    const uint32_t b_base = smem_u32(sB + slot * BN * LDS);
#pragma unroll
    for (int i = tid; i < BN * 4; i += THREADS) {
      const int r = i >> 2, s = i & 3;
      const bool ok = n0 + r < O;
      const uint8_t* src = ok ? w + (size_t)(n0 + r) * Kb + kb0 + s * 16 : w;
      cp_async16(b_base + r * LDS + s * 16, src, ok);
    }
  };

  Acc acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();  // stage kt has landed
    __syncthreads();              // ... for every thread; slot (kt-1) % STAGES is free
    const int nk = kt + STAGES - 1;
    if (nk < KT) load_stage(nk, nk % STAGES);
    cp_async_commit();
    const int slot = kt % STAGES;
    mma_stage<Acc, BN>(acc, smem_u32(sA + slot * BM * LDS), smem_u32(sB + slot * BN * LDS),
                       warp_m, warp_n, lane);
  }
  cp_async_wait<0>();

  // epilogue: acc * scale[o] + bias[o] (+ residual), in f32, then rounded
  const int g = lane >> 2, t = lane & 3;
  const bool pairs = (O & 1) == 0;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + warp_m * 32 + mt * 16 + g + 8 * half;
      if (m >= M) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = n0 + warp_n * (BN / 2) + nt * 8 + 2 * t;
        const size_t off = (size_t)m * O + n;
        float v[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          v[j] = to_f(acc[mt][nt][2 * half + j]);
          if (n + j < O) {
            if (scale != nullptr) v[j] = __fmul_rn(v[j], scale[n + j]);
            v[j] = __fadd_rn(v[j], bias[n + j]);
            if (has_res) {
              const float r = out_bf16
                  ? __bfloat162float(static_cast<const __nv_bfloat16*>(res)[off + j])
                  : static_cast<const float*>(res)[off + j];
              v[j] = __fadd_rn(v[j], r);
            }
          }
        }
        if (out_bf16) {
          __nv_bfloat16* yo = static_cast<__nv_bfloat16*>(y) + off;
          if (pairs && n + 1 < O) {
            *reinterpret_cast<__nv_bfloat162*>(yo) = __floats2bfloat162_rn(v[0], v[1]);
          } else {
            if (n < O) yo[0] = __float2bfloat16_rn(v[0]);
            if (n + 1 < O) yo[1] = __float2bfloat16_rn(v[1]);
          }
        } else {
          float* yo = static_cast<float*>(y) + off;
          if (pairs && n + 1 < O) {
            *reinterpret_cast<float2*>(yo) = make_float2(v[0], v[1]);
          } else {
            if (n < O) yo[0] = v[0];
            if (n + 1 < O) yo[1] = v[1];
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// kernel 5: GN + SiLU + quantize prologue, moment epilogue
// ---------------------------------------------------------------------------

// bf16 pair of a 32-bit word -> two f32 (a bf16 is the high half of an f32)
__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ uint32_t quantize_one(float a, bool gn, float s, float sh, float act) {
  if (gn) {
    a = __fadd_rn(__fmul_rn(a, s), sh);
    const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-a)));
    a = __fmul_rn(a, sig);
  }
  const float q = fminf(fmaxf(rintf(__fdiv_rn(a, act)), -127.0f), 127.0f);
  return (uint32_t)(uint8_t)(int8_t)(int)q;
}

template <int BN>
__global__ void __launch_bounds__(THREADS)
conv3x3_gnq_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ gns,
                   const float* __restrict__ gnb, const float* __restrict__ act_ptr,
                   const uint8_t* __restrict__ w, const float* __restrict__ oscale,
                   const float* __restrict__ bias, const __nv_bfloat16* __restrict__ res,
                   __nv_bfloat16* __restrict__ y, float* __restrict__ part, int H, int W, int C,
                   int O, int upsample, int has_gn, int has_res, int tiles) {
  constexpr int NT = BN / 16;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* sA = smem;                                         // 2 x BM x LDS
  uint8_t* sB = sA + 2 * BM * LDS;                            // 2 x BN x LDS
  float* sS = reinterpret_cast<float*>(sB + 2 * BN * LDS);  // C GN scales
  float* sH = sS + C;                                         // C GN shifts

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp & 3, warp_n = warp >> 2;
  const int HW = H * W;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int b = m0 / HW;                 // every row of the block is in image b
  const int tile = (m0 - b * HW) / BM;
  const int Bn = gridDim.x / tiles;
  const int Hs = upsample ? H >> 1 : H, Ws = upsample ? W >> 1 : W;
  const int Kb = 9 * C;
  const int KT = Kb / BK;
  const float act = *act_ptr;
  const bool gn = has_gn != 0;

  if (gn) {
    for (int c = tid; c < C; c += THREADS) {
      sS[c] = gns[(size_t)b * C + c];
      sH[c] = gnb[(size_t)b * C + c];
    }
  }

  const int seg = tid & 3;
  int ph[2], pw[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int rem = m0 - b * HW + (tid >> 2) + 64 * u;
    ph[u] = rem / W;
    pw[u] = rem - ph[u] * W;
  }

  uint4 raw[2][2];
  bool rok[2];
  int c0 = 0;  // first channel of this thread's segment in the gathered stage
  auto gather = [&](int kt) {
    const int kb0 = kt * BK;
    const int tap = kb0 / C;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    c0 = kb0 - tap * C + seg * 16;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int hi = ph[u] + dy, wi = pw[u] + dx;
      const bool ok = hi >= 0 && hi < H && wi >= 0 && wi < W;
      const int hs = upsample ? hi >> 1 : hi, ws = upsample ? wi >> 1 : wi;
      const uint4* src = reinterpret_cast<const uint4*>(
          x + (((size_t)b * Hs + (ok ? hs : 0)) * Ws + (ok ? ws : 0)) * C + c0);
      raw[u][0] = ok ? __ldg(src) : make_uint4(0u, 0u, 0u, 0u);
      raw[u][1] = ok ? __ldg(src + 1) : make_uint4(0u, 0u, 0u, 0u);
      rok[u] = ok;
    }
  };
  auto store_a = [&](int slot) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = (tid >> 2) + 64 * u;
      uint32_t q[4] = {0u, 0u, 0u, 0u};
      if (rok[u]) {
        const uint32_t wd[8] = {raw[u][0].x, raw[u][0].y, raw[u][0].z, raw[u][0].w,
                                raw[u][1].x, raw[u][1].y, raw[u][1].z, raw[u][1].w};
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int c = c0 + 2 * k;
          const float s0 = gn ? sS[c] : 0.0f, h0 = gn ? sH[c] : 0.0f;
          const float s1 = gn ? sS[c + 1] : 0.0f, h1 = gn ? sH[c + 1] : 0.0f;
          const uint32_t lo = quantize_one(bf_lo(wd[k]), gn, s0, h0, act);
          const uint32_t hi = quantize_one(bf_hi(wd[k]), gn, s1, h1, act);
          q[k >> 1] |= (lo | (hi << 8)) << (16 * (k & 1));
        }
      }
      *reinterpret_cast<uint4*>(sA + slot * BM * LDS + r * LDS + seg * 16) =
          make_uint4(q[0], q[1], q[2], q[3]);
    }
  };
  auto load_b = [&](int kt, int slot) {
    const int kb0 = kt * BK;
    const uint32_t b_base = smem_u32(sB + slot * BN * LDS);
#pragma unroll
    for (int i = tid; i < BN * 4; i += THREADS) {
      const int r = i >> 2, s = i & 3;
      cp_async16(b_base + r * LDS + s * 16, w + (size_t)(n0 + r) * Kb + kb0 + s * 16, true);
    }
  };

  int acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;

  gather(0);
  load_b(0, 0);
  cp_async_commit();
  __syncthreads();  // GN scale/shift in shared memory
  store_a(0);
  cp_async_wait<0>();
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < KT;
    if (more) {  // next stage's input in flight to registers, weights to shared
      gather(kt + 1);
      load_b(kt + 1, cur ^ 1);
      cp_async_commit();
    }
    mma_stage<int, BN>(acc, smem_u32(sA + cur * BM * LDS), smem_u32(sB + cur * BN * LDS),
                       warp_m, warp_n, lane);
    if (more) store_a(cur ^ 1);
    cp_async_wait<0>();
    __syncthreads();
  }

  // epilogue: y = acc * out_scale[o] + bias[o] (+ residual) -> bf16, and the
  // sums of the rounded y and y^2 over this block's pixels
  const int g = lane >> 2, t = lane & 3;
  float s1[NT][2], s2[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) s1[nt][0] = s1[nt][1] = s2[nt][0] = s2[nt][1] = 0.0f;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + warp_m * 32 + mt * 16 + g + 8 * half;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = n0 + warp_n * (BN / 2) + nt * 8 + 2 * t;
        const size_t off = (size_t)m * O + n;
        float v[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          v[j] = __fadd_rn(__fmul_rn(__int2float_rn(acc[mt][nt][2 * half + j]), oscale[n + j]),
                           bias[n + j]);
          if (has_res) v[j] = __fadd_rn(v[j], __bfloat162float(res[off + j]));
        }
        const __nv_bfloat162 yb = __floats2bfloat162_rn(v[0], v[1]);
        *reinterpret_cast<__nv_bfloat162*>(y + off) = yb;
        const float y0 = __low2float(yb), y1 = __high2float(yb);
        s1[nt][0] += y0;
        s1[nt][1] += y1;
        s2[nt][0] += y0 * y0;
        s2[nt][1] += y1 * y1;
      }
    }
  }
  // sum over the 8 lanes that share t (they hold the same columns)
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s1[nt][j] += __shfl_xor_sync(0xffffffffu, s1[nt][j], o);
        s2[nt][j] += __shfl_xor_sync(0xffffffffu, s2[nt][j], o);
      }
  // then over the 4 warps along M, in a fixed order
  float* red = reinterpret_cast<float*>(smem);  // [2][4][BN], over the drained stages
  if (g == 0) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = warp_n * (BN / 2) + nt * 8 + 2 * t + j;
        red[(0 * 4 + warp_m) * BN + col] = s1[nt][j];
        red[(1 * 4 + warp_m) * BN + col] = s2[nt][j];
      }
  }
  __syncthreads();
  for (int i = tid; i < 2 * BN; i += THREADS) {
    const int k = i / BN, col = i - k * BN;
    const float* rr = red + k * 4 * BN + col;
    const float s = ((rr[0] + rr[BN]) + rr[2 * BN]) + rr[3 * BN];
    part[(((size_t)k * Bn + b) * tiles + tile) * O + n0 + col] = s;
  }
}

template <bool INT8, int BN>
int launch_conv(const void* x, const void* w, const void* scale, const void* bias,
                const void* res, void* y, int B, int H, int W, int C, int O, int out_bf16,
                int has_res, cudaStream_t stream) {
  const size_t smem = (size_t)STAGES * (BM + BN) * LDS;
  cudaError_t err = cudaFuncSetAttribute(conv3x3_kernel<INT8, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int M = B * H * W;
  const dim3 grid((M + BM - 1) / BM, (O + BN - 1) / BN);
  conv3x3_kernel<INT8, BN><<<grid, THREADS, smem, stream>>>(
      (const uint8_t*)x, (const uint8_t*)w, (const float*)scale, (const float*)bias, res, y, H,
      W, C, O, M, out_bf16, has_res);
  return (int)cudaGetLastError();
}

template <int BN>
int launch_gnq(const void* x, const void* gns, const void* gnb, const void* act, const void* w,
               const void* oscale, const void* bias, const void* res, void* y, void* part,
               int B, int H, int W, int C, int O, int upsample, int has_gn, int has_res,
               int tiles, cudaStream_t stream) {
  const size_t smem = (size_t)2 * (BM + BN) * LDS + (has_gn ? 2 * sizeof(float) * C : 0);
  cudaError_t err = cudaFuncSetAttribute(conv3x3_gnq_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * tiles, O / BN);
  conv3x3_gnq_kernel<BN><<<grid, THREADS, smem, stream>>>(
      (const __nv_bfloat16*)x, (const float*)gns, (const float*)gnb, (const float*)act,
      (const uint8_t*)w, (const float*)oscale, (const float*)bias, (const __nv_bfloat16*)res,
      (__nv_bfloat16*)y, (float*)part, H, W, C, O, upsample, has_gn, has_res, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// Output pixels per block, for the wrapper's check of its tiling.
extern "C" int conv_block_m() { return BM; }

// Kernel 4. x: (B, H, W, C) int8 (in_bf16 = 0) or bf16 (in_bf16 = 1), C a
// multiple of 64 (int8) or 32 (bf16); w: (O, 3, 3, C) of the same type;
// scale (O,) f32 or null (bf16 twin: no scale); bias (O,) f32; res null or
// (B, H, W, O) of the output type; y: (B, H, W, O) f32 (out_bf16 = 0) or
// bf16. All contiguous on one device. Returns cudaGetLastError() of the
// launch (0 = launched).
extern "C" int conv3x3_launch(const void* x, const void* w, const void* scale, const void* bias,
                              const void* res, void* y, int B, int H, int W, int C, int O,
                              int in_bf16, int out_bf16, int has_res, void* stream) {
  if (B == 0 || H == 0 || W == 0 || O == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const bool wide = O % 128 == 0;
  if (in_bf16)
    return wide ? launch_conv<false, 128>(x, w, scale, bias, res, y, B, H, W, C, O, out_bf16,
                                          has_res, s)
                : launch_conv<false, 64>(x, w, scale, bias, res, y, B, H, W, C, O, out_bf16,
                                         has_res, s);
  return wide ? launch_conv<true, 128>(x, w, scale, bias, res, y, B, H, W, C, O, out_bf16,
                                       has_res, s)
              : launch_conv<true, 64>(x, w, scale, bias, res, y, B, H, W, C, O, out_bf16,
                                      has_res, s);
}

// Kernel 5. x: (B, H/2, W/2, C) bf16 with upsample, else (B, H, W, C); H, W
// are the output's. gns, gnb: (B, C) f32, or null with has_gn = 0; act: one
// f32 on the device; w: (O, 3, 3, C) int8; oscale, bias: (O,) f32; res null
// or (B, H, W, O) bf16; y: (B, H, W, O) bf16; part: (2, B, tiles, O) f32,
// tiles = H*W / 128, receives the per-block sums of y and y^2. C and O
// multiples of 64, H*W a multiple of 128. Returns cudaGetLastError().
extern "C" int conv3x3_gnq_launch(const void* x, const void* gns, const void* gnb,
                                  const void* act, const void* w, const void* oscale,
                                  const void* bias, const void* res, void* y, void* part, int B,
                                  int H, int W, int C, int O, int upsample, int has_gn,
                                  int has_res, int tiles, void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (O % 128 == 0)
    return launch_gnq<128>(x, gns, gnb, act, w, oscale, bias, res, y, part, B, H, W, C, O,
                           upsample, has_gn, has_res, tiles, s);
  return launch_gnq<64>(x, gns, gnb, act, w, oscale, bias, res, y, part, B, H, W, C, O,
                        upsample, has_gn, has_res, tiles, s);
}
