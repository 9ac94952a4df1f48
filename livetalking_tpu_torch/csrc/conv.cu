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
//                          and per-tile partial sums of the bf16-rounded y and
//                          y^2 per (image, channel) for the next GroupNorm.
//
// Design of the GEMM core. The GEMM is M = B*H*W output pixels by N = O
// output channels by K = 9*C (tap-major: K index (dy*3 + dx)*C + c, the
// weight layout (O, 3, 3, C) that diffusion_blocks.quantize_conv writes
// once). A block computes BM = 128 output pixels; its warps are 4 along M
// (32 pixels each) x 2 or 4 along N, and K is walked 64 bytes at a time: a
// stage is 64 channels (int8) or 32 channels (bf16) of one tap. Products
// are mma.sync m16n8k32 s8 (int32 sums) or m16n8k16 bf16 (f32 sums); both
// take 32 bytes of K per tile with the same register byte layout, so one
// ldmatrix-based inner loop (mma_stage) serves both kernels. Weight rows in
// shared memory are 80 bytes (64 + 16 padding), which makes the ldmatrix
// row reads conflict-free.
//
// conv3x3_kernel (kernel 4): 8 warps, a BN = 64 or 128 channel tile; input
// rows (128 pixels shifted by (dy, dx), zero-filled outside the image) and
// weights are staged with 16-byte cp.async, 3 stages deep.
//
// conv3x3_gnq_kernel (kernel 5): a block owns an 8 x 16 tile of output
// pixels of one image and all O output channels.
//   - Halo. Its input halo, 10 x 18 pixels (in upsample mode the 6 x 10
//     source pixels that the (h >> 1, w >> 1) indices reach), is loaded
//     once, all C channels (8 bf16 a thread and load, 4 loads in flight),
//     and GN, SiLU and the quantize are applied once per element into an
//     int8 halo in shared memory, rows of C + 16 bytes (an odd number of
//     16-byte units, so 8 ldmatrix rows hit 8 bank groups). Pixels outside
//     the image are 0: activation-space padding, as the reference. Each
//     input element is activated 180/128 = 1.4 times (0.5 in upsample
//     mode) where the first port's kernel activated it once per tap and
//     output-channel block, 9 O/BN = 9 to 36 times.
//   - Taps. The 9 taps read their A rows from the halo by address: a
//     lane's ldmatrix row is output pixel (ty, tx) shifted by (dy, dx).
//   - Weights stream through a 4-stage cp.async ring that runs on across
//     the block's output-channel passes (the first 3 stages load under the
//     halo's activation); the loop walks passes of BN channels, taps and
//     64-byte channel chunks without divisions.
//   - BN = 256 (16 warps, 4 x 4, a 32 x 64 tile each: 64 int32 accumulators
//     a thread) when O % 256 == 0, else BN = 128 or 64 with 8 warps (two
//     blocks per SM where shared memory allows).
//   - Shared memory: halo (10 x 18 or 6 x 10) x (C + 16) + 4 x BN x 80
//     (weights) + 8 C (GN) + 32 BN (moments): 189,248 bytes at C = 512,
//     BN = 256; 141,120 at C = 256, BN = 256; 96,064 at C = 256, BN = 128;
//     72,000 at C = 128, BN = 128. Ragged tiles at the right or bottom edge
//     compute their missing pixels from zeros and never store them.
//   - Epilogue per pass: y = acc * out_scale[o] + bias[o] (+ residual) ->
//     bf16; the sums of the rounded y and y^2 over the tile's pixels, over
//     lanes by shuffles and over the 4 warps along M in a fixed order, go to
//     the tile's own (image, tile, channel) slot of a scratch buffer, which
//     the wrapper adds up. No atomics: the result does not depend on the
//     order blocks run in.
//   - Math: __fmul_rn/__fadd_rn, SiLU's 1 / (1 + e) as __frcp_rn (the
//     correctly rounded reciprocal: the bits of the IEEE division), the
//     division by the activation scale as __fdiv_rn (the file is built
//     without fast math), so no contraction rounds differently from the
//     plain PyTorch version.
// The TPU kernel's structure (a (TH+2)-row VMEM window, the dx taps folded
// on the output side, a sequential row-tile grid) exists for the TPU's
// sublane layout and is not carried over.
//
// What bounds them on the H100: operations. 2*M*N*K int8 operations
// against the input, weights and output bytes; at MuseTalk's B=16 shapes
// every site is far right of the ridge (e.g. 256 px, 256 -> 256: 1.24 TOP
// for 79 MB), so the floor is the int8 tensor-core rate, 1,979 TOP/s (0.63
// ms there). Summed over a B=16 step, that floor is 5.7 ms for the 80 int8
// 3x3 convs (U-Net and unfused decoder) and 4.9 ms for the fused decode's
// 21 conv3x3_gnq_kernel launches (chip_smoke.py computes both). mma.sync
// reaches part of that rate on Hopper, and the weights are re-read from L2
// once per 128-pixel tile. Left for later: wgmma with TMA-fed weight tiles
// and a producer warp, a persistent grid, and for kernel 4 the halo tile
// and the quantize of conv_q folded into the producer. PERF.md holds the
// measured times.
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

// One stage (BK bytes of K) of the block's tile. a_row[mt]: the shared
// address of this lane's ldmatrix row of the warp's m16 tile mt at the
// stage's first K byte (row lane & 15 of the tile: matrices rows 0-7 |
// 8-15, bytes 0-15 | 16-31, so lanes 16-31 add 16 bytes); sB: BN rows of
// LDS bytes. With WN warps along N, warp (warp_m, warp_n) owns 32 rows and
// columns warp_n*BN/WN .. +BN/WN: 2 x (BN/WN/8) mma tiles.
template <typename Acc, int BN, int WN = 2>
__device__ __forceinline__ void mma_stage(Acc (&acc)[2][BN / WN / 8][4],
                                          const uint32_t (&a_row)[2], uint32_t sB, int warp_n,
                                          int lane) {
  constexpr int NT = BN / WN / 8;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 32) {
    uint32_t a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) ldmatrix_x4(a[mt], a_row[mt] + kk);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      // matrices: columns 0-7 bytes 0-15 | 0-7 bytes 16-31 | 8-15 | 8-15
      uint32_t b[4];
      const int row = warp_n * (BN / WN) + np * 16 + (lane & 7) + (lane >> 4) * 8;
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
    const uint32_t a0 =
        smem_u32(sA + slot * BM * LDS) + (warp_m * 32 + (lane & 15)) * LDS + (lane >> 4) * 16;
    const uint32_t a_row[2] = {a0, a0 + 16 * LDS};
    mma_stage<Acc, BN>(acc, a_row, smem_u32(sB + slot * BN * LDS), warp_n, lane);
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
// kernel 5: GN + SiLU + quantize of a halo tile, moment epilogue
// ---------------------------------------------------------------------------

constexpr int GTH = 8, GTW = 16;  // output tile: GTH rows x GTW columns = BM pixels
constexpr int GSTAGES = 4;        // cp.async depth of the weight ring
static_assert(GTH * GTW == BM, "one output tile is one block's BM pixels");

// halo rows and columns: the input pixels the tile's taps reach (output
// space), or the source pixels the >> 1 indices reach in upsample mode
__host__ __device__ constexpr int halo_rows(int up) { return up ? GTH / 2 + 2 : GTH + 2; }
__host__ __device__ constexpr int halo_cols(int up) { return up ? GTW / 2 + 2 : GTW + 2; }

// Bytes of dynamic shared memory of one block: the int8 halo (rows of C +
// 16 bytes), the weight ring, the GN scale and shift, the moment reduction.
size_t gnq_smem_bytes(int C, int BN, int up) {
  return (size_t)halo_rows(up) * halo_cols(up) * (C + 16) + (size_t)GSTAGES * BN * LDS +
         2 * sizeof(float) * C + 2 * 4 * sizeof(float) * BN;
}

// bf16 pair of a 32-bit word -> two f32 (a bf16 is the high half of an f32)
__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// GN apply, SiLU as a * sigmoid(a), quantize: the plain version's roundings
// (the correctly rounded reciprocal gives 1 / (1 + e) bit for bit; the
// division by the activation scale stays an IEEE division)
__device__ __forceinline__ uint32_t quantize_one(float a, bool gn, float s, float sh, float act) {
  if (gn) {
    a = __fadd_rn(__fmul_rn(a, s), sh);
    a = __fmul_rn(a, __frcp_rn(__fadd_rn(1.0f, expf(-a))));
  }
  const float q = fminf(fmaxf(rintf(__fdiv_rn(a, act)), -127.0f), 127.0f);
  return (uint32_t)(uint8_t)(int8_t)(int)q;
}

// 8 bf16 channels c .. c + 7 -> 8 int8
__device__ __forceinline__ uint2 activate8(uint4 raw, bool gn, const float* sS, const float* sH,
                                           int c, float act) {
  const uint32_t wd[4] = {raw.x, raw.y, raw.z, raw.w};
  uint32_t q[2] = {0u, 0u};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int cc = c + 2 * k;
    const uint32_t lo = quantize_one(bf_lo(wd[k]), gn, gn ? sS[cc] : 0.0f, gn ? sH[cc] : 0.0f, act);
    const uint32_t hi =
        quantize_one(bf_hi(wd[k]), gn, gn ? sS[cc + 1] : 0.0f, gn ? sH[cc + 1] : 0.0f, act);
    q[k >> 1] |= (lo | (hi << 8)) << (16 * (k & 1));
  }
  return make_uint2(q[0], q[1]);
}

// Block (tile, b) owns output rows h0 .. h0 + 7 and columns w0 .. w0 + 15
// of image b (a ragged tile at the right or bottom edge computes its
// missing pixels from zeros and never stores them) and every output
// channel. It activates its input halo, all C channels, once into shared
// memory, then walks the output-channel tiles n0 = 0, BN, ... and, inside
// each, K by tap and 64-channel chunk; the taps read their A rows from the
// halo by address. The weight ring runs on across output-channel tiles.
template <int BN, int WN>
__global__ void __launch_bounds__(128 * WN, WN == 2 ? 2 : 1)
conv3x3_gnq_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ gns,
                   const float* __restrict__ gnb, const float* __restrict__ act_ptr,
                   const uint8_t* __restrict__ w, const float* __restrict__ oscale,
                   const float* __restrict__ bias, const __nv_bfloat16* __restrict__ res,
                   __nv_bfloat16* __restrict__ y, float* __restrict__ part, int H, int W, int C,
                   int O, int upsample, int has_gn, int has_res) {
  constexpr int NTH = 128 * WN;  // 4 warps along M x WN along N
  constexpr int NT = BN / WN / 8;
  extern __shared__ __align__(16) uint8_t smem[];
  const int up = upsample != 0;
  const int HR = halo_rows(up), HC = halo_cols(up);
  const int LDH = C + 16;  // halo row stride: an odd number of 16-byte units
  uint8_t* sA = smem;                                         // HR*HC pixels x LDH
  uint8_t* sB = sA + HR * HC * LDH;                           // GSTAGES x BN x LDS
  float* sS = reinterpret_cast<float*>(sB + GSTAGES * BN * LDS);  // C GN scales
  float* sH = sS + C;                                             // C GN shifts
  float* red = sH + C;                                            // [2][4][BN]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp & 3, warp_n = warp >> 2;
  const int tile = blockIdx.x, tiles = gridDim.x;
  const int b = blockIdx.y, Bn = gridDim.y;
  const int tiles_w = (W + GTW - 1) / GTW;
  const int h0 = (tile / tiles_w) * GTH, w0 = (tile % tiles_w) * GTW;
  const int Hs = up ? H >> 1 : H, Ws = up ? W >> 1 : W;
  const int Kb = 9 * C;
  const float act = *act_ptr;
  const bool gn = has_gn != 0;

  // the weight ring: a stage holds BN rows x 64 bytes of K; this thread
  // copies 16 bytes of rows ld_n0 + (tid >> 2) + i * NTH / 4, walking each
  // set of BN output channels through its 9 C bytes of K, then the next set
  constexpr int LOADS = BN * 4 / NTH;
  const uint32_t b_ld = smem_u32(sB) + (tid >> 2) * LDS + (tid & 3) * 16;
  int ld_n0 = 0, ld_kb = 0;
  auto load_next = [&](int slot) {
    if (ld_n0 < O) {
#pragma unroll
      for (int i = 0; i < LOADS; ++i)
        cp_async16(b_ld + (slot * BN + i * (NTH / 4)) * LDS,
                   w + (size_t)(ld_n0 + (tid >> 2) + i * (NTH / 4)) * Kb + ld_kb + (tid & 3) * 16,
                   true);
      ld_kb += BK;
      if (ld_kb == Kb) {  // on to the next BN output channels
        ld_kb = 0;
        ld_n0 += BN;
      }
    }
    cp_async_commit();
  };
  // the first weight stages load under the halo's activation
#pragma unroll
  for (int s = 0; s < GSTAGES - 1; ++s) load_next(s);

  if (gn) {
    for (int c = tid; c < C; c += NTH) {
      sS[c] = gns[(size_t)b * C + c];
      sH[c] = gnb[(size_t)b * C + c];
    }
  }
  __syncthreads();

  // the halo, activated once: 8 channels a thread and item, 4 items' loads
  // in flight; pixels outside the image are 0 (activation-space padding)
  {
    const int hy0 = up ? (h0 >> 1) - 1 : h0 - 1, wx0 = up ? (w0 >> 1) - 1 : w0 - 1;
    const int c8 = C >> 3, total = HR * HC * c8;
    constexpr int U = 4;
    for (int i0 = tid; i0 < total; i0 += U * NTH) {
      uint4 raw[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * NTH;
        const int pix = i / c8, c = (i - pix * c8) * 8;
        const int hy = hy0 + pix / HC, wx = wx0 + pix % HC;
        const bool ok = i < total && hy >= 0 && hy < Hs && wx >= 0 && wx < Ws;
        raw[u] = ok ? __ldg(reinterpret_cast<const uint4*>(
                          x + (((size_t)b * Hs + hy) * Ws + wx) * C + c))
                    : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * NTH;
        if (i < total) {
          const int pix = i / c8, c = (i - pix * c8) * 8;
          const int hy = hy0 + pix / HC, wx = wx0 + pix % HC;
          const bool ok = hy >= 0 && hy < Hs && wx >= 0 && wx < Ws;
          *reinterpret_cast<uint2*>(sA + pix * LDH + c) =
              ok ? activate8(raw[u], gn, sS, sH, c, act) : make_uint2(0u, 0u);
        }
      }
    }
  }

  // this lane's ldmatrix rows: output row ty = 2 warp_m + mt of the tile,
  // column tx = lane & 15
  const int tx = lane & 15;
  const uint32_t a_lane = smem_u32(sA) + (lane >> 4) * 16;
  const int g = lane >> 2, t = lane & 3;

  int acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;

  int slot = 0;  // ring slot of the stage in use
  for (int n0 = 0; n0 < O; n0 += BN) {
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
      uint32_t a_tap[2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int ty = 2 * warp_m + mt;
        const int hp = up ? (((ty + dy) >> 1) + 1) * HC + ((tx + dx) >> 1) + 1
                          : (ty + 1 + dy) * HC + tx + 1 + dx;
        a_tap[mt] = a_lane + hp * LDH;
      }
      for (int c0 = 0; c0 < C; c0 += BK) {
        cp_async_wait<GSTAGES - 2>();  // this stage has landed
        __syncthreads();               // ... for every thread (and the halo is written)
        load_next(slot == 0 ? GSTAGES - 1 : slot - 1);  // the slot read one stage ago
        const uint32_t a_row[2] = {a_tap[0] + c0, a_tap[1] + c0};
        mma_stage<int, BN, WN>(acc, a_row, smem_u32(sB + slot * BN * LDS), warp_n, lane);
        slot = slot + 1 == GSTAGES ? 0 : slot + 1;
      }
    }

    // epilogue of output channels n0 .. n0 + BN - 1: y = acc * out_scale[o]
    // + bias[o] (+ residual) -> bf16, and the sums of the rounded y and y^2
    // over the tile's pixels: first over this thread's 4 pixels, then the 8
    // lanes that share t (same columns), then the 4 warps along M in a
    // fixed order
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = warp_n * (BN / WN) + j * 8 + 2 * t;
      const int n = n0 + col;
      const float sc0 = oscale[n], sc1 = oscale[n + 1], bi0 = bias[n], bi1 = bias[n + 1];
      float s1[2] = {0.0f, 0.0f}, s2[2] = {0.0f, 0.0f};
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int h = h0 + 2 * warp_m + mt, wo = w0 + g + 8 * half;
          if (h < H && wo < W) {
            const size_t off = (((size_t)b * H + h) * W + wo) * O + n;
            float v0 = __fadd_rn(__fmul_rn(__int2float_rn(acc[mt][j][2 * half]), sc0), bi0);
            float v1 = __fadd_rn(__fmul_rn(__int2float_rn(acc[mt][j][2 * half + 1]), sc1), bi1);
            if (has_res) {
              const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(res + off);
              v0 = __fadd_rn(v0, __low2float(r));
              v1 = __fadd_rn(v1, __high2float(r));
            }
            const __nv_bfloat162 yb = __floats2bfloat162_rn(v0, v1);
            *reinterpret_cast<__nv_bfloat162*>(y + off) = yb;
            const float y0 = __low2float(yb), y1 = __high2float(yb);
            s1[0] += y0;
            s1[1] += y1;
            s2[0] += y0 * y0;
            s2[1] += y1 * y1;
          }
          acc[mt][j][2 * half] = acc[mt][j][2 * half + 1] = 0;
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          s1[e] += __shfl_xor_sync(0xffffffffu, s1[e], o);
          s2[e] += __shfl_xor_sync(0xffffffffu, s2[e], o);
        }
      if (g == 0) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          red[(0 * 4 + warp_m) * BN + col + e] = s1[e];
          red[(1 * 4 + warp_m) * BN + col + e] = s2[e];
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < 2 * BN; i += NTH) {
      const int k = i / BN, col = i - k * BN;
      const float* rr = red + k * 4 * BN + col;
      const float s = ((rr[0] + rr[BN]) + rr[2 * BN]) + rr[3 * BN];
      part[(((size_t)k * Bn + b) * tiles + tile) * O + n0 + col] = s;
    }
    // red is written again only after the next K walk's __syncthreads
  }
  cp_async_wait<0>();
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

int gnq_tiles(int H, int W) { return ((H + GTH - 1) / GTH) * ((W + GTW - 1) / GTW); }

// output channels per pass of the block: 256 (16 warps), 128 or 64 (8 warps)
int gnq_bn(int O) { return O % 256 == 0 ? 256 : O % 128 == 0 ? 128 : 64; }

template <int BN, int WN>
int launch_gnq(const void* x, const void* gns, const void* gnb, const void* act, const void* w,
               const void* oscale, const void* bias, const void* res, void* y, void* part,
               int B, int H, int W, int C, int O, int upsample, int has_gn, int has_res,
               cudaStream_t stream) {
  const size_t smem = gnq_smem_bytes(C, BN, upsample);
  cudaError_t err = cudaFuncSetAttribute(conv3x3_gnq_kernel<BN, WN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(gnq_tiles(H, W), B);
  conv3x3_gnq_kernel<BN, WN><<<grid, 128 * WN, smem, stream>>>(
      (const __nv_bfloat16*)x, (const float*)gns, (const float*)gnb, (const float*)act,
      (const uint8_t*)w, (const float*)oscale, (const float*)bias, (const __nv_bfloat16*)res,
      (__nv_bfloat16*)y, (float*)part, H, W, C, O, upsample, has_gn, has_res);
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

// Kernel 5's output tiles per image (the moments' scratch holds one slot
// per tile) and the dynamic shared memory of one block, for the wrapper.
extern "C" int conv3x3_gnq_tiles(int H, int W) { return gnq_tiles(H, W); }
extern "C" int conv3x3_gnq_smem_bytes(int C, int O, int upsample) {
  return (int)gnq_smem_bytes(C, gnq_bn(O), upsample);
}

// Kernel 5. x: (B, H/2, W/2, C) bf16 with upsample, else (B, H, W, C); H, W
// are the output's (even with upsample). gns, gnb: (B, C) f32, or null with
// has_gn = 0; act: one f32 on the device; w: (O, 3, 3, C) int8; oscale,
// bias: (O,) f32; res null or (B, H, W, O) bf16; y: (B, H, W, O) bf16;
// part: (2, B, tiles, O) f32, tiles = conv3x3_gnq_tiles(H, W), receives the
// per-tile sums of y and y^2. C and O multiples of 64, 0 < B <= 65535, and
// conv3x3_gnq_smem_bytes within the block limit. Returns
// cudaGetLastError(), or cudaErrorInvalidValue if tiles is not the kernel's.
extern "C" int conv3x3_gnq_launch(const void* x, const void* gns, const void* gnb,
                                  const void* act, const void* w, const void* oscale,
                                  const void* bias, const void* res, void* y, void* part, int B,
                                  int H, int W, int C, int O, int upsample, int has_gn,
                                  int has_res, int tiles, void* stream) {
  if (B == 0) return 0;
  if (tiles != gnq_tiles(H, W)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (gnq_bn(O)) {
    case 256:
      return launch_gnq<256, 4>(x, gns, gnb, act, w, oscale, bias, res, y, part, B, H, W, C, O,
                                upsample, has_gn, has_res, s);
    case 128:
      return launch_gnq<128, 2>(x, gns, gnb, act, w, oscale, bias, res, y, part, B, H, W, C, O,
                                upsample, has_gn, has_res, s);
    default:
      return launch_gnq<64, 2>(x, gns, gnb, act, w, oscale, bias, res, y, part, B, H, W, C, O,
                               upsample, has_gn, has_res, s);
  }
}
