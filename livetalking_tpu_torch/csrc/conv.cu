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
// Both are GEMMs of M = B*H*W output pixels by N = O output channels by
// K = 9*C (tap-major: K index (dy*3 + dx)*C + c, the weight layout
// (O, 3, 3, C) that diffusion_blocks.quantize_conv writes once), walked in
// 64-byte chunks of K: 64 channels (int8) or 32 channels (bf16) of a tap.
//
// conv3x3_kernel (kernel 4): wgmma fed by TMA, K split across blocks.
//   - Tiles. A block computes a 128-pixel by BN-channel output tile (BN =
//     256 where O % 256 == 0 and the tiles fill the card without a split,
//     else 128) over a range of K stages; its 128 pixels are a box of
//     (bw, bh, bb) = (w, h, image) pixels, powers of two. ops/conv.py::
//     conv3x3_plan picks the box, the mode, BN and the split from (B, H, W,
//     C, O) and the SM count; this file checks what it is given.
//   - A operand, two modes. Halo mode (images at least 8 px wide, every
//     site from 8x8 up): the box is 8 x 16 (8 x 8 x 2 images at 8x8), and a
//     stage is one 64-byte channel chunk of all nine taps. The producer
//     loads the tile's input halo, (bh + 2) x 10 x bb pixels, once per chunk
//     as four 4-D TMA boxes of 16 bytes of channels each (no swizzle, so a
//     slice is 8-row core matrices of 16-byte rows); tap (dy, dx) is then a
//     wgmma descriptor that starts (dy * 10 + dx) pixels into the halo with
//     core matrices 160 bytes (one halo row) apart and the second 16 bytes
//     of K one slice further. Each input byte is read from L2 1.4 times per
//     N tile instead of 9. Per-tap mode (narrower images: the U-Net's 4x4
//     sites, box 4 x 4 x 8 images): a stage is one tap's 64-byte chunk, a
//     4-D box of (64 bytes, bw, bh, bb) at (c0, w0+dx-1, h0+dy-1, b0) in
//     the 64-byte swizzle, which lands in (b, h, w) order as the A tile's
//     K-major rows. In both modes TMA zero-fills every coordinate outside
//     the tensor: that is the conv's zero padding and the ragged edge of
//     B, H and W, and no thread computes an address or a bound. The halo
//     was chosen over per-tap boxes everywhere it fits: the per-tap kernel
//     was bound by L2 traffic (9 reads of each input byte per N tile).
//   - B operand. A 2-D tensor map over wq (O, 9C), which is K-major as
//     wgmma wants 8-bit B; a stage loads (64 bytes of K, BN rows) in the
//     64-byte swizzle, rows past O zero-filled (conv_out's O = 4).
//   - Warp roles. 288 threads: two consumer warpgroups (pixels 0-63 and
//     64-127 of the tile) and one producer warp, whose lane 0 issues the
//     TMA copies into rings of stages with a full and an empty mbarrier
//     each. A consumer waits on the stage's full barrier, issues 2 x (BN /
//     128) wgmma.mma_async m64n128k32 s8 (m64n128k16 bf16), commits, and
//     frees the previous stage once wgmma.wait_group 1 says its products
//     are done.
//   - Split K. With T = (M tiles) x (N tiles) < #SMs, K is cut into S =
//     min(2 #SMs / T, 9 C bytes / 64 / 8, 6, stages) ranges of whole
//     stages when that is 3 or more, part s taking stages [s KT / S, (s +
//     1) KT / S) (in per-tap mode a range may end inside a tap). The
//     U-Net's 4x4 sites get 20 tiles x 6 parts, its 8x8 sites 80 x 3; every
//     other site has T >= 128 and S = 1. Each part stores its int32 (f32) partial tile to
//     a workspace in the accumulators' register order (16-byte stores,
//     coalesced), fences, and bumps the tile's counter; the part that
//     arrives last reads the partials back and sums them in the fixed
//     order 0 .. S-1, resets the counter for the next launch on the
//     stream, and runs the epilogue. Integer sums are exact in any order;
//     the bf16 twin's f32 sums run in that fixed order, so its result does
//     not depend on block timing.
//   - Work units and persistence. A (tile, K range) pair is a work unit.
//     BN = 256 and per-tap instances are persistent: one block per SM
//     walks units blockIdx.x, + gridDim.x, ..., the rings run on across
//     units, and the output is staged in its own 68 KB tile, so the
//     producer fills the rings for the next unit during the epilogue. BN =
//     128 halo instances run one block per unit, two blocks per SM (one
//     block's epilogue runs under the other's products) and stage the
//     output in their rings. (On an H100 80GB HBM3 at 700 W, one
//     persistent block per SM lost 20-40% at those sites, and two-block
//     clusters that multicast the weight tile to a pair of M tiles took
//     twice as long everywhere: the blocks stall on each other's stage
//     releases.)
//   - Shared memory and registers (nvcc -Xptxas -v, no spills): per-tap BN
//     = 128: 8 stages x (8 + 8) KB + the 69,632-byte staging tile =
//     201,856 bytes, 158 registers; per-tap BN = 256: 6 x (8 + 16) KB +
//     staging = 218,208 bytes, 168 registers; halo BN = 128: 2 halo chunks
//     of 13 KB + 8 x 8 KB weight tiles = 93,344 bytes, 96 registers (two
//     blocks per SM); halo BN = 256: 2 x 13 KB + 8 x 16 KB + staging =
//     228,512 bytes, 168 registers. 168 is the most a 288-thread block can
//     have (three warps share an SM quarter's 16,384 registers), 96 with
//     two blocks; BN/2 of them are accumulators.
//   - Epilogue, 128 channels at a time: the f32 sums go to the staging tile
//     (rows 136 floats apart, so 8 rows of float2 stores hit distinct
//     banks), then each thread takes 8 consecutive channels of a row: y =
//     acc * scale[o] + bias[o] (+ residual) in f32 (__fmul_rn, __fadd_rn),
//     rounded to bf16 or kept f32, stored 16 bytes at a time; pixels
//     outside the image and channels past O are masked.
//   - Host side: tensor maps are cached per (pointer, shape, box), the
//     input's included (the caching allocator hands the same blocks out
//     again), cuTensorMapEncodeTiled comes through cudaGetDriverEntryPoint
//     (no -lcuda), and the shared-memory attribute is set once per kernel
//     instance and device.
//
// conv3x3_gnq_kernel (kernel 5): a block owns an 8 x 16 tile of output
// pixels of one image and all O output channels. Products are mma.sync
// m16n8k32 s8 over ldmatrix fragments (mma_stage); weight rows in shared
// memory are 80 bytes (64 + 16 padding), which makes the ldmatrix row reads
// conflict-free.
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
// What bounds them on the H100: 2*M*N*K int8 operations at 1,979 TOP/s
// against the input, weight and output bytes at 3.35 TB/s. At MuseTalk's
// B=16 shapes the sites from 16 px up are far right of the ridge (e.g.
// 256 px, 256 -> 256: 1.24 TOP for 79 MB, 0.63 ms); the U-Net's 4x4 sites
// are bound by their weight bytes (14.7 MB for 1280 -> 1280, 4.7 us).
// Summed over a B=16 step the floor is 5.7 ms for the 80 int8 3x3 convs
// of kernel 4 (U-Net and unfused decoder), 1.2 ms for the fused step's 59,
// and 4.9 ms for the fused decode's 21 conv3x3_gnq_kernel launches
// (chip_smoke.py computes each). Kernel 4 reads every weight byte from L2
// once per M tile (with BN = 256 that is two thirds of its L2 traffic),
// which with the per-tile pipeline fill and the epilogue (not overlapped
// with the products in a persistent block) bounds it at 35-57% of its
// floor at the large sites; at the 4x4 sites the serial sum of the
// partials in the last part adds to that. Left for later: ping-pong
// consumer warpgroups (one tile's epilogue under the other's products),
// 128-byte K stages, the epilogue through TMA stores, the quantize of
// conv_q folded into a transform stage between the load and the products,
// and for kernel 5 wgmma. PERF.md holds the measured times.
//
// The kernels allocate nothing and launch on the caller's stream.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <functional>
#include <mutex>
#include <unordered_map>

namespace {

constexpr int BM = 128;       // output pixels per block
constexpr int BK = 64;        // K bytes per stage
constexpr int LDS = BK + 16;  // shared-memory row stride in bytes

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
// row g+8.
__device__ __forceinline__ void mma(int c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
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
// kernel 4: TMA-fed wgmma implicit GEMM, K split across blocks
// ---------------------------------------------------------------------------

constexpr int K4_CONSUMERS = 256;              // two consumer warpgroups
constexpr int K4_THREADS = K4_CONSUMERS + 32;  // and one producer warp
constexpr int K4_HALO_W = 8 + 2;               // halo mode: tile columns 8, plus the border

// The shared memory of one block: the rings, a 128 x 128 f32 output
// staging tile (rows of K4_STAGE_W floats), the barriers. Per-tap mode: NA
// stages, each an A box (128 rows x 64 bytes) and a B tile (BN rows x 64
// bytes) on one full and one empty barrier. Halo mode: NA = 2 halo chunks
// (four 16-byte channel slices of up to 200 pixels each, slices 128-byte
// aligned) on their own barriers, and NB = 8 B tiles, one per (chunk,
// tap). Persistent instances (one block per SM walking several work units)
// keep the staging tile apart, so the producer fills the rings for the
// next unit during the epilogue; the others (BN = 128 in halo mode, two
// blocks per SM, one unit each) stage the output in the rings.
constexpr int K4_STAGE_W = 128 + 8;

__host__ __device__ constexpr bool k4_persistent(int bn, bool halo) { return bn == 256 || !halo; }

template <int BN, bool HALO>
struct K4Smem {
  static constexpr bool PERSIST = k4_persistent(BN, HALO);
  static constexpr int B_BYTES = BN * BK;
  static constexpr int NA = HALO ? 2 : (BN == 128 ? 8 : 6);
  static constexpr int NB = HALO ? 8 : NA;
  static constexpr int A_BYTES = HALO ? 13312 : BM * BK;  // 4 x 3200 rounded to 1024, or 8 KB
  static constexpr int RING = NA * A_BYTES + NB * B_BYTES;
  static constexpr int STAGING = BM * K4_STAGE_W * 4;
  static constexpr int APART = PERSIST ? STAGING : 0;  // staging bytes beside the rings
  // 1024 bytes of alignment slack, the rings, the staging tile, the barriers
  static constexpr int BYTES = 1024 + RING + APART + 8 * 2 * (HALO ? NA + NB : NA);
  static_assert(PERSIST ? BYTES <= 232448 - 16 : 2 * (BYTES + 1024 + 16) <= 233472,
                "one block per SM, or two");
  static_assert(PERSIST || STAGING <= RING, "the staging tile fits in the rings");
};

struct K4Args {
  const float* scale;  // (O,), or null (bf16 twin)
  const float* bias;   // (O,)
  const void* res;     // (B, H, W, O) of the output type, or null
  void* y;             // (B, H, W, O) bf16 or f32
  void* ws;            // split partials: (tiles, splits, BM * BN) int32 / f32
  int* counters;       // one a tile, 0 between launches on a stream
  int B, H, W, O;
  int box_w, box_h, box_b;        // the tile's pixels along w, h and the batch
  int tiles_w, tiles_h, n_tiles;  // tiles along w and h; BN-channel tiles
  int chunks;                     // 64-byte K chunks per tap
  int stages;                     // pipeline stages: chunks (halo mode), 9 * chunks (per tap)
  int splits;
  int units;                      // tiles x splits
  int out_bf16, has_res;
};

template <bool INT8>
struct VecT {
  using type = int4;
};
template <>
struct VecT<false> {
  using type = float4;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Waits for the barrier's phase of the given parity to complete. A wait
// that outlasts 2^33 clocks (seconds) traps, so a stage that never lands
// fails the launch instead of hanging the stream.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  for (unsigned spins = 1;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if ((spins & 1023) == 0) {
      if (t0 == 0) {
        t0 = clock64();
      } else if (clock64() - t0 > (1ll << 33)) {
        __trap();
      }
    }
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// TMA tile loads into shared memory; completion counted on the barrier
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma descriptor of a K-major tile in the 64-byte swizzle the TMA writes:
// rows of 64 bytes, 8-row groups 512 bytes apart (SBO), LBO unused, layout
// type 2 (64B swizzle). The tile starts on a 512-byte boundary; the second
// 32 bytes of K start 32 bytes further, as the swizzle is a function of the
// address.
__device__ __forceinline__ uint64_t desc_sw64(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(512 >> 4) << 32) |
         ((uint64_t)2 << 62);
}

// wgmma descriptor of a K-major tile without swizzle: 8-row core matrices
// of 16-byte rows (128 contiguous bytes), the next 16 bytes of K lbo bytes
// further, the next 8 rows sbo bytes further.
__device__ __forceinline__ uint64_t desc_plain(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator accesses across the
// asynchronous products
__device__ __forceinline__ void acc_fence(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
__device__ __forceinline__ void acc_fence(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, this warpgroup's 64 rows) += A (64 x 32 bytes) . B (128 x 32
// bytes)^T, both K-major in shared memory. Accumulator i of a thread (lane
// = 4 g + q of warp w of the warpgroup): row 16 w + g + 8 ((i >> 1) & 1),
// column 8 (i >> 2) + 2 q + (i & 1).
__device__ __forceinline__ void wgmma_128(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]),
        "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// Second half of kernel 4's epilogue: the 256 consumer threads write the
// staged 128 x 128 f32 tile (pixels of the box at (w0, h0, b0), channels
// n0 ..): thread tid takes channels n0 + 8 (tid % 16) .. + 7 of rows
// tid / 16, + 16, ...: y = acc * scale[o] + bias[o] (+ residual) in f32
// (__fmul_rn, __fadd_rn), rounded to bf16 or kept f32, 16-byte loads and
// stores where O % 8 == 0; pixels outside the image and channels past O
// are masked.
__device__ __forceinline__ void epilogue_rows(const K4Args& p, const float* stage_f, int w0, int h0,
                                              int b0, int n0, int tid) {
  const int c0 = (tid % 16) * 8, n = n0 + c0;
  if (n >= p.O) return;
  const bool vec = (p.O & 7) == 0;  // 8-channel groups are whole and 16-byte aligned
  const int cnt = vec ? 8 : min(8, p.O - n);
  float sc[8], bi[8];  // this thread's channels are the same in every row
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    sc[e] = p.scale != nullptr && e < cnt ? p.scale[n + e] : 1.0f;
    bi[e] = e < cnt ? p.bias[n + e] : 0.0f;
  }
  const int lw = __ffs(p.box_w) - 1, lh = __ffs(p.box_h) - 1;  // the box sides are powers of 2
  for (int r = tid / 16; r < BM; r += K4_CONSUMERS / 16) {
    const int rest = r >> lw;  // row r of the tile: (bt, ht, wt)
    const int b = b0 + (rest >> lh), h = h0 + (rest & (p.box_h - 1)), w = w0 + (r & (p.box_w - 1));
    if (b >= p.B || h >= p.H || w >= p.W) continue;
    const size_t off = (((size_t)b * p.H + h) * p.W + w) * p.O + n;
    const float4 lo = *reinterpret_cast<const float4*>(stage_f + r * K4_STAGE_W + c0);
    const float4 hi = *reinterpret_cast<const float4*>(stage_f + r * K4_STAGE_W + c0 + 4);
    float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    float rv[8] = {};
    if (p.has_res) {
      if (vec && p.out_bf16) {
        const uint4 raw =
            *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(p.res) + off);
        const __nv_bfloat162* rb = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          rv[2 * k] = __low2float(rb[k]);
          rv[2 * k + 1] = __high2float(rb[k]);
        }
      } else if (vec) {
        const float4* rf = reinterpret_cast<const float4*>(static_cast<const float*>(p.res) + off);
        const float4 r0 = rf[0], r1 = rf[1];
        rv[0] = r0.x, rv[1] = r0.y, rv[2] = r0.z, rv[3] = r0.w;
        rv[4] = r1.x, rv[5] = r1.y, rv[6] = r1.z, rv[7] = r1.w;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (e < cnt)
            rv[e] = p.out_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.res)[off + e])
                               : static_cast<const float*>(p.res)[off + e];
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (e < cnt) {
        if (p.scale != nullptr) v[e] = __fmul_rn(v[e], sc[e]);
        v[e] = __fadd_rn(v[e], bi[e]);
        if (p.has_res) v[e] = __fadd_rn(v[e], rv[e]);
      }
    }
    if (p.out_bf16) {
      __nv_bfloat16* yo = static_cast<__nv_bfloat16*>(p.y) + off;
      if (vec) {
        uint4 out;
        uint32_t* ow = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const __nv_bfloat162 pr = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
          ow[k] = *reinterpret_cast<const uint32_t*>(&pr);
        }
        *reinterpret_cast<uint4*>(yo) = out;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (e < cnt) yo[e] = __float2bfloat16_rn(v[e]);
      }
    } else {
      float* yo = static_cast<float*>(p.y) + off;
      if (vec) {
        reinterpret_cast<float4*>(yo)[0] = make_float4(v[0], v[1], v[2], v[3]);
        reinterpret_cast<float4*>(yo)[1] = make_float4(v[4], v[5], v[6], v[7]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (e < cnt) yo[e] = v[e];
      }
    }
  }
}

template <bool INT8, int BN, bool HALO>
__global__ void __launch_bounds__(K4_THREADS, k4_persistent(BN, HALO) ? 1 : 2)
conv3x3_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
               const __grid_constant__ K4Args p) {
  using Acc = typename AccT<INT8>::type;
  using Vec = typename VecT<INT8>::type;
  using L = K4Smem<BN, HALO>;
  constexpr int NSUB = BN / 128;          // m64n128 products per 32 bytes of K
  constexpr int CH = INT8 ? BK : BK / 2;  // tensor elements per 64-byte chunk
  extern __shared__ uint8_t smem_raw[];
  __shared__ int last_part;
  const uint32_t sA = (smem_u32(smem_raw) + 1023) & ~1023u;  // NA x A_BYTES
  const uint32_t sB = sA + L::NA * L::A_BYTES;               // NB x B_BYTES
  const uint32_t sC = L::PERSIST ? sA + L::RING : sA;        // the output staging tile
  const uint32_t bars = sA + L::RING + L::APART;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // halo mode: a slice holds (box_h + 2) x 10 x box_b pixels of 16 bytes
  const int halo_rows = K4_HALO_W * (p.box_h + 2) * p.box_b;
  const int slice = (halo_rows * 16 + 127) & ~127;

  // barriers: full then empty for each ring (per-tap mode: one ring)
  const uint32_t full_a = bars, empty_a = bars + 8 * L::NA;
  const uint32_t full_b = HALO ? bars + 16 * L::NA : full_a;
  const uint32_t empty_b = HALO ? full_b + 8 * L::NB : empty_a;
  if (tid == 0) {
    for (int s = 0; s < L::NA; ++s) {
      mbar_init(full_a + 8 * s, 1);   // the producer's expect_tx
      mbar_init(empty_a + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    if (HALO) {
      for (int s = 0; s < L::NB; ++s) {
        mbar_init(full_b + 8 * s, 1);
        mbar_init(empty_b + 8 * s, 2);
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the block walks work units u = blockIdx.x, + gridDim.x, ...: unit u is
  // split part u % splits of tile u / splits, the tiles N fastest
  struct Unit {
    int split, tile, w0, h0, b0, n0, k_begin, k_end;
  };
  auto unit = [&](int u) {
    Unit t;
    t.split = u % p.splits;
    t.tile = u / p.splits;
    const int n_tile = t.tile % p.n_tiles, m_tile = t.tile / p.n_tiles;
    t.w0 = m_tile % p.tiles_w * p.box_w;
    t.h0 = m_tile / p.tiles_w % p.tiles_h * p.box_h;
    t.b0 = m_tile / (p.tiles_w * p.tiles_h) * p.box_b;
    t.n0 = n_tile * BN;
    t.k_begin = (int)((long long)t.split * p.stages / p.splits);
    t.k_end = (int)((long long)(t.split + 1) * p.stages / p.splits);
    return t;
  };

  if (warp == K4_CONSUMERS / 32) {  // the producer warp
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&xmap))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&wmap))
                   : "memory");
      // ring positions run on across units; the first round of each ring
      // passes its empty barrier at once
      int ia = 0, ib = 0;
      for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
        const Unit t = unit(u);
        if constexpr (HALO) {
          // per channel chunk: its halo in four 16-byte slices, then the
          // nine taps' weight tiles
          for (int c = t.k_begin; c < t.k_end; ++c, ++ia) {
            const int sa = ia % L::NA;
            mbar_wait(empty_a + 8 * sa, ((ia / L::NA) & 1) ^ 1);
            mbar_expect_tx(full_a + 8 * sa, 4 * halo_rows * 16);
            for (int sl = 0; sl < 4; ++sl)
              tma_load_4d(sA + sa * L::A_BYTES + sl * slice, &xmap, full_a + 8 * sa,
                          c * CH + sl * (CH / 4), t.w0 - 1, t.h0 - 1, t.b0);
            for (int tap = 0; tap < 9; ++tap, ++ib) {
              const int sb = ib % L::NB;
              mbar_wait(empty_b + 8 * sb, ((ib / L::NB) & 1) ^ 1);
              mbar_expect_tx(full_b + 8 * sb, L::B_BYTES);
              tma_load_2d(sB + sb * L::B_BYTES, &wmap, full_b + 8 * sb,
                          (tap * p.chunks + c) * CH, t.n0);
            }
          }
        } else {
          int tap = t.k_begin / p.chunks, chunk = t.k_begin - tap * p.chunks;
          for (int kt = t.k_begin; kt < t.k_end; ++kt, ++ia) {
            const int st = ia % L::NA;
            mbar_wait(empty_a + 8 * st, ((ia / L::NA) & 1) ^ 1);
            mbar_expect_tx(full_a + 8 * st, L::A_BYTES + L::B_BYTES);
            tma_load_4d(sA + st * L::A_BYTES, &xmap, full_a + 8 * st, chunk * CH,
                        t.w0 + tap % 3 - 1, t.h0 + tap / 3 - 1, t.b0);
            tma_load_2d(sB + st * L::B_BYTES, &wmap, full_a + 8 * st, kt * CH, t.n0);
            if (++chunk == p.chunks) {
              chunk = 0;
              ++tap;
            }
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg computes the tile's pixels 64 wg .. 64 wg + 63
  const int wg = warp >> 2;
  const bool signals = (tid & 127) == 0;  // the thread that arrives for its warpgroup
  Acc acc[NSUB][64];
  // one stage's products: 2 x 32 bytes of K (the A descriptor advances by
  // da_k 16-byte units per 32 bytes), NSUB x 128 channels; then waits for
  // the previous stage's products, whose slots the caller frees
  auto products = [&](uint64_t da, uint32_t da_k, uint64_t db) {
#pragma unroll
    for (int ns = 0; ns < NSUB; ++ns) acc_fence(acc[ns]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int ns = 0; ns < NSUB; ++ns)
        wgmma_128(acc[ns], da + kk * da_k, db + ns * ((128 * BK) >> 4) + 2 * kk);
    wgmma_commit();
#pragma unroll
    for (int ns = 0; ns < NSUB; ++ns) acc_fence(acc[ns]);
    wgmma_wait<1>();
  };
  // halo mode: the warpgroup's 64 pixels are 8 rows of 8 of one image; for
  // tap (dy, dx) its row i reads halo pixels (bt (box_h + 2) + ht0 + i + dy)
  // * 10 + dx .. + 7: 8-row core matrices 160 bytes apart, and slice 2 kk +
  // 1 (one slice further) holds the second 16 bytes of K step kk
  const int row0 = ((wg * 8) / p.box_h * (p.box_h + 2) + (wg * 8) % p.box_h) * K4_HALO_W;
  const uint64_t db0 = desc_sw64(sB), da0 = desc_sw64(sA + wg * 64 * BK);
  float* stage_f = reinterpret_cast<float*>(smem_raw + (sC - smem_u32(smem_raw)));
  int ia = 0, ib = 0;
  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    int k_begin, k_end;
    {
      const Unit t = unit(u);
      k_begin = t.k_begin;
      k_end = t.k_end;
    }
#pragma unroll
    for (int ns = 0; ns < NSUB; ++ns)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[ns][i] = 0;
    if constexpr (HALO) {
      const int ia0 = ia, ib0 = ib;
      for (int c = k_begin; c < k_end; ++c, ++ia) {
        const int sa = ia % L::NA;
        mbar_wait(full_a + 8 * sa, (ia / L::NA) & 1);
        const uint32_t a_base = sA + sa * L::A_BYTES + row0 * 16;
        for (int tap = 0; tap < 9; ++tap, ++ib) {
          const int sb = ib % L::NB;
          mbar_wait(full_b + 8 * sb, (ib / L::NB) & 1);
          const int shift = (tap / 3) * K4_HALO_W + tap % 3;  // (dy, dx) in halo pixels
          products(desc_plain(a_base + shift * 16, slice, K4_HALO_W * 16), (2 * slice) >> 4,
                   db0 + ((sb * L::B_BYTES) >> 4));
          if (signals) {
            if (ib > ib0) mbar_arrive(empty_b + 8 * ((ib - 1) % L::NB));
            if (tap == 0 && ia > ia0) mbar_arrive(empty_a + 8 * ((ia - 1) % L::NA));
          }
        }
      }
      wgmma_wait<0>();
      if (signals) {  // the unit's last stages
        mbar_arrive(empty_b + 8 * ((ib - 1) % L::NB));
        mbar_arrive(empty_a + 8 * ((ia - 1) % L::NA));
      }
    } else {
      const int ia0 = ia;
      for (int kt = k_begin; kt < k_end; ++kt, ++ia) {
        const int st = ia % L::NA;
        mbar_wait(full_a + 8 * st, (ia / L::NA) & 1);
        products(da0 + ((st * L::A_BYTES) >> 4), 2, db0 + ((st * L::B_BYTES) >> 4));
        if (signals && ia > ia0) mbar_arrive(empty_a + 8 * ((ia - 1) % L::NA));
      }
      wgmma_wait<0>();
      if (signals) mbar_arrive(empty_a + 8 * ((ia - 1) % L::NA));
    }
#pragma unroll
    for (int ns = 0; ns < NSUB; ++ns) acc_fence(acc[ns]);
    int uu = u;
    asm volatile("" : "+r"(uu));  // recomputed, not kept live across the products
    const Unit t = unit(uu);

    if (p.splits > 1) {
      // every part stores its partial tile in register order (vector v of
      // thread t at (v * 256 + t) * 16 bytes); the last part to arrive reads
      // them back, sums them in the order 0 .. splits - 1 and writes the
      // output
      constexpr int NV = NSUB * 16;  // 16-byte vectors a thread
      Vec* ws = static_cast<Vec*>(p.ws);
      const size_t tile_v = (size_t)t.tile * p.splits * NV;
#pragma unroll
      for (int ns = 0; ns < NSUB; ++ns)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          Vec v;
          v.x = acc[ns][4 * j];
          v.y = acc[ns][4 * j + 1];
          v.z = acc[ns][4 * j + 2];
          v.w = acc[ns][4 * j + 3];
          ws[(tile_v + (size_t)t.split * NV + ns * 16 + j) * K4_CONSUMERS + tid] = v;
        }
      __threadfence();
      asm volatile("bar.sync 1, 256;\n" ::: "memory");  // the consumers only
      if (tid == 0) {
        const int arrived = atomicAdd(p.counters + t.tile, 1);
        last_part = arrived == p.splits - 1;
        if (last_part) p.counters[t.tile] = 0;  // every part of the tile has counted
      }
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
      if (!last_part) continue;
      __threadfence();
      // part 0, then each further part added in order (a runtime loop over
      // the parts outside the unrolled one over registers, so only the
      // accumulators stay live)
#pragma unroll
      for (int ns = 0; ns < NSUB; ++ns)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const Vec r = __ldcg(ws + (tile_v + ns * 16 + j) * K4_CONSUMERS + tid);
          acc[ns][4 * j] = r.x;
          acc[ns][4 * j + 1] = r.y;
          acc[ns][4 * j + 2] = r.z;
          acc[ns][4 * j + 3] = r.w;
        }
      for (int part = 1; part < p.splits; ++part) {
#pragma unroll
        for (int ns = 0; ns < NSUB; ++ns)
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const Vec r =
                __ldcg(ws + (tile_v + (size_t)part * NV + ns * 16 + j) * K4_CONSUMERS + tid);
            acc[ns][4 * j] += r.x;
            acc[ns][4 * j + 1] += r.y;
            acc[ns][4 * j + 2] += r.z;
            acc[ns][4 * j + 3] += r.w;
          }
      }
    }

    // epilogue, 128 channels at a time, through the staging tile (the
    // producer meanwhile fills the rings for the next unit): the f32 sums
    // go to a 128 x 128 tile, rows 136 floats apart (8 rows of float2
    // stores hit distinct banks); then each thread takes 8 consecutive
    // channels of a row: y = acc * scale[o] + bias[o] (+ residual) in f32,
    // rounded, stored 16 bytes at a time
#pragma unroll
    for (int ns = 0; ns < NSUB; ++ns) {
      asm volatile("bar.sync 1, 256;\n" ::: "memory");  // the tile is free
      {
        const int g = lane >> 2, q = lane & 3;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float* dst =
              stage_f + (wg * 64 + (warp & 3) * 16 + g + 8 * half) * K4_STAGE_W + 2 * q;
#pragma unroll
          for (int j = 0; j < 16; ++j)
            *reinterpret_cast<float2*>(dst + j * 8) =
                make_float2(to_f(acc[ns][4 * j + 2 * half]), to_f(acc[ns][4 * j + 2 * half + 1]));
        }
      }
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
      epilogue_rows(p, stage_f, t.w0, t.h0, t.b0, t.n0 + ns * 128, tid);
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

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    const bool ok = err == cudaSuccess && found == cudaDriverEntryPointSuccess;
    return ok ? reinterpret_cast<EncodeTiled>(f) : nullptr;
  }();
  return fn;
}

// A tensor map of uint8 (es = 1) or bf16 (es = 2) elements, innermost
// dimension first, zero fill outside the tensor. Returns 0, or the negated
// CUresult of the encode.
int encode_map(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
               const cuuint64_t* strides, const cuuint32_t* box, int es,
               CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapDataType type =
      es == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUresult r =
      fn(map, type, (cuuint32_t)rank, const_cast<void*>(ptr), dims, strides, box, unit,
         CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(int)r;
}

// Tensor maps, cached: a map depends only on what the key holds (the
// pointer, the element size, the shape, the box and the swizzle; the
// strides follow from the shape), so a hit is always the map a new encode
// would give. Weights hit from their second call on, and activations do as
// the caching allocator hands the same blocks out again.
struct MapKey {
  const void* ptr;
  int rank, es, swizzle;
  cuuint64_t dims[4];
  cuuint32_t box[4];
  bool operator==(const MapKey& o) const {
    if (ptr != o.ptr || rank != o.rank || es != o.es || swizzle != o.swizzle) return false;
    for (int i = 0; i < rank; ++i)
      if (dims[i] != o.dims[i] || box[i] != o.box[i]) return false;
    return true;
  }
};
struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    size_t h = std::hash<const void*>()(k.ptr) ^ ((size_t)k.es * 31u + (size_t)k.swizzle * 7u);
    for (int i = 0; i < k.rank; ++i)
      h = h * 1000003u ^ (size_t)k.dims[i] ^ ((size_t)k.box[i] << 40);
    return h;
  }
};

int cached_map(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
               const cuuint64_t* strides, const cuuint32_t* box, int es,
               CUtensorMapSwizzle swizzle) {
  static std::mutex mu;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> cache;
  MapKey key{ptr, rank, es, (int)swizzle, {0, 0, 0, 0}, {0, 0, 0, 0}};
  for (int i = 0; i < rank; ++i) {
    key.dims[i] = dims[i];
    key.box[i] = box[i];
  }
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *map = hit->second;
    return 0;
  }
  const int err = encode_map(map, ptr, rank, dims, strides, box, es, swizzle);
  if (err == 0) {
    if (cache.size() >= 4096) cache.clear();
    cache.emplace(key, *map);
  }
  return err;
}

// wq (O, 9C) as rows of 9C elements: boxes of 64 bytes of K by bn rows
int weight_map(CUtensorMap* map, const void* w, int O, int C, int es, int bn) {
  const cuuint64_t dims[2] = {(cuuint64_t)9 * C, (cuuint64_t)O};
  const cuuint64_t strides[1] = {(cuuint64_t)9 * C * es};
  const cuuint32_t box[2] = {(cuuint32_t)(BK / es), (cuuint32_t)bn};
  return cached_map(map, w, 2, dims, strides, box, es, CU_TENSOR_MAP_SWIZZLE_64B);
}

template <bool INT8, int BN, bool HALO>
int launch_conv(const CUtensorMap& xmap, const CUtensorMap& wmap, const K4Args& args, int grid,
                cudaStream_t stream) {
  constexpr int smem = K4Smem<BN, HALO>::BYTES;
  static std::atomic<unsigned> ready{0};  // one bit per device: the attribute is set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned bit = 1u << (dev & 31);
  if (!(ready.load() & bit)) {
    err = cudaFuncSetAttribute(conv3x3_kernel<INT8, BN, HALO>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    ready.fetch_or(bit);
  }
  conv3x3_kernel<INT8, BN, HALO><<<grid, K4_THREADS, smem, stream>>>(xmap, wmap, args);
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
// bf16. All contiguous on one device, x and w on 16-byte boundaries. The
// tiling, from ops/conv.py::conv3x3_plan: a box of (box_w, box_h, box_b)
// pixels, powers of 2 with box_w * box_h * box_b = 128 (halo = 1: box_w = 8 and box_h 8
// or 16), bn = 128 or 256 channels, and splits K ranges of whole stages (a
// stage is a 64-byte channel chunk with halo = 1, else one tap's chunk);
// with splits > 1, ws holds tiles x splits x 128 x bn int32 (f32 for bf16)
// and counters one zeroed int32 per tile, tiles = ceil(W / box_w)
// ceil(H / box_h) ceil(B / box_b) ceil(O / bn); grid blocks walk the tiles
// x splits work units (one block per unit for BN = 128 in halo mode, else
// at most one block per SM). Returns 0 once launched,
// cudaErrorInvalidValue for a tiling it cannot take, the negated CUresult
// if a tensor map cannot be encoded, or cudaGetLastError() of the launch.
extern "C" int conv3x3_launch(const void* x, const void* w, const void* scale, const void* bias,
                              const void* res, void* y, void* ws, void* counters, int B, int H,
                              int W, int C, int O, int in_bf16, int out_bf16, int has_res,
                              int box_w, int box_h, int box_b, int halo, int bn, int splits,
                              int grid, void* stream) {
  if (B == 0 || H == 0 || W == 0 || O == 0) return 0;
  const int es = in_bf16 ? 2 : 1;
  const int chunks = C * es / BK, stages = halo ? chunks : 9 * chunks;
  const auto pow2 = [](int v) { return v >= 1 && v <= 128 && (v & (v - 1)) == 0; };
  const bool box_ok = pow2(box_w) && pow2(box_h) && pow2(box_b) && box_w * box_h * box_b == BM &&
                      (!halo || (box_w == 8 && (box_h == 8 || box_h == 16)));
  if (C <= 0 || (C * es) % BK || !box_ok || (bn != 128 && bn != 256) || splits < 1 ||
      splits > stages || (splits > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  K4Args a;
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.res = has_res ? res : nullptr;
  a.y = y;
  a.ws = ws;
  a.counters = static_cast<int*>(counters);
  a.B = B;
  a.H = H;
  a.W = W;
  a.O = O;
  a.box_w = box_w;
  a.box_h = box_h;
  a.box_b = box_b;
  a.tiles_w = (W + box_w - 1) / box_w;
  a.tiles_h = (H + box_h - 1) / box_h;
  a.n_tiles = (O + bn - 1) / bn;
  a.chunks = chunks;
  a.stages = stages;
  a.splits = splits;
  a.out_bf16 = out_bf16;
  a.has_res = has_res;
  const long long units = (long long)a.tiles_w * a.tiles_h * ((B + box_b - 1) / box_b) *
                          a.n_tiles * splits;
  if (units > 0x7fffffffLL || grid < 1 || grid > units ||
      (!k4_persistent(bn, halo != 0) && grid != units))
    return (int)cudaErrorInvalidValue;
  a.units = (int)units;

  // x as (C, W, H, B): per-tap boxes of 64 bytes x (box_w, box_h, box_b)
  // in the 64-byte swizzle, or halo boxes of 16 bytes x (10, box_h + 2,
  // box_b) without swizzle
  CUtensorMap xmap, wmap;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * es, (cuuint64_t)W * C * es,
                                 (cuuint64_t)H * W * C * es};
  const cuuint32_t tap_box[4] = {(cuuint32_t)(BK / es), (cuuint32_t)box_w, (cuuint32_t)box_h,
                                 (cuuint32_t)box_b};
  const cuuint32_t halo_box[4] = {(cuuint32_t)(16 / es), (cuuint32_t)K4_HALO_W,
                                  (cuuint32_t)(box_h + 2), (cuuint32_t)box_b};
  int err = halo ? cached_map(&xmap, x, 4, dims, strides, halo_box, es, CU_TENSOR_MAP_SWIZZLE_NONE)
                 : cached_map(&xmap, x, 4, dims, strides, tap_box, es, CU_TENSOR_MAP_SWIZZLE_64B);
  if (err == 0) err = weight_map(&wmap, w, O, C, es, bn);
  if (err != 0) return err;
  cudaStream_t s = (cudaStream_t)stream;
  const int n = grid;
  if (in_bf16) {
    if (halo)
      return bn == 256 ? launch_conv<false, 256, true>(xmap, wmap, a, n, s)
                       : launch_conv<false, 128, true>(xmap, wmap, a, n, s);
    return bn == 256 ? launch_conv<false, 256, false>(xmap, wmap, a, n, s)
                     : launch_conv<false, 128, false>(xmap, wmap, a, n, s);
  }
  if (halo)
    return bn == 256 ? launch_conv<true, 256, true>(xmap, wmap, a, n, s)
                     : launch_conv<true, 128, true>(xmap, wmap, a, n, s);
  return bn == 256 ? launch_conv<true, 256, false>(xmap, wmap, a, n, s)
                   : launch_conv<true, 128, false>(xmap, wmap, a, n, s);
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
