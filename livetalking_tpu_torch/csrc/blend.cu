// Paste-back for Hopper: bilinear resize of each predicted (S, S) mouth crop
// into its box, alpha blend over the avatar's frame, and the finished full
// frame written once.
//
// Replaces both TPU kernels of livetalking_tpu/ops/pallas_blend.py:
//   _blend_kernel (behind make_resize_paste_fn): alpha from a feathered rect;
//   _blend_kernel_input_mask (behind make_masked_paste_fn): alpha from a
//     per-cycle-index uint8 mask.
// One templated kernel covers both alpha sources and two forms:
//   fused:    out[b] = paste(frames[idxs[b]]), the whole (H, W, 3) frame. The
//             kernel reads the cycle frame by index itself, so no gathered
//             copy is made first, and writes each output frame once; the
//             JAX step's gather + blend + dynamic_update_slice in one pass.
//   in place: out holds gathered frames; only the box's pixels are rewritten.
//
// Arithmetic per pixel (as the reference, for item b and its geometry):
//   rect: h = clip(y2-y1, 1, Ho)  w = clip(x2-x1, 1, Wo)  oy = clip(y1, 0, H-Ho)
//         ox = clip(x1, 0, W-Wo)  dy = y1-oy  dx = x1-ox
//         alpha = ay*ax, a = clip((min(i, n-1-i)+1)/feather, 0, 1) in the box
//   mask: (oy, ox) = origins[k] clamped, (h, w, dy, dx) = scalars[k],
//         alpha = masks[k, y, x] / 255; where the mask is 0 the byte stays.
//         The mask is zero outside the box (make_masked_paste_fn's contract,
//         which prepare_masked_paste_data keeps), so only the box is blended.
//   source position of crop row i: clip((i+0.5)*S/max(h,1) - 0.5, 0, S-1),
//   weights max(0, 1 - |pos - j|) (the unit tent), rows first, then columns
//   (the reference's Rv.pred.Rh order), every product and sum rounded on its
//   own (explicit _rn intrinsics, so no FMA contraction changes a result);
//   out = rint(alpha*resized + (1-alpha)*bg), clamped to [0, 255].
//
// What bounds it: bytes. Fused, per item it writes the whole frame (H*W*3
// bytes, 921,600 at 480x640) and reads the cycle frame (at least once per
// distinct index), the pred crop (3*S*S) and the index's geometry (and mask).
// At B=128 on 480x640 frames: about 236 MB (70 us at 3.35 TB/s) when the
// indices are distinct, as sessions stepping through long cycles give them;
// about 150 MB (45 us) when they repeat 8 frames. In place,
// it reads and writes the box and reads the crop: about 63 MB at B=128. The
// operations (about 13 per channel per blended pixel) are below the card's
// rates but not far: the blend is bound by issued instructions unless their
// count per pixel stays low. PERF.md holds the measured times.
//
// Design. One launch, two kinds of block per item:
//   blend blocks: kRows frame rows of the box. The background segment of each
//     row (its 16-byte aligned superset, as ox*3 is arbitrary) and for the
//     mask kind the mask row segment are staged in shared memory with
//     cp.async, many copies in flight per thread. Meanwhile the vertical pass
//     t = wr0*pred[r0] + wr1*pred[r1] runs over the S*3 source values of each
//     row (16-byte loads, floats in shared memory). After one barrier a
//     thread owns a column: its taps and weights in registers, it runs the
//     horizontal pass and the blend down the kRows rows in shared memory.
//     After a second barrier the segments go back as 16-byte stores, their
//     head and tail bytes one by one. A hard rect (feather 0) has alpha 1,
//     so out = resized and no background is staged.
//   copy blocks (fused only): whole rows of the item's frame, about 32 KB a
//     block, a row per warp, from frames[idxs[b]] to out[b] with 16-byte
//     loads issued before the box is known and streaming 16-byte stores,
//     neighbouring lanes on neighbouring addresses. A chunk inside a box
//     segment is skipped; one that straddles its edge is copied byte by byte
//     outside it. So every output byte has one writer.
//   Byte and float conversions use the 2^23 trick (a byte permute or an OR,
//     and an add) instead of conversion instructions, which run at an eighth
//     of the fp32 rate; m/255 is a product corrected by one fma.
//   Order: an item's blend bands, then its copy parts (so blending overlaps
//     copying), item after item.
// Frames whose rows are not 16-byte aligned (W*3 % 16 != 0, or a base
// pointer off 16), masks whose rows are not, and strided pred rows off 16
// bytes take the same path byte by byte. The kernel allocates nothing and
// launches on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;          // bucket rows per blend block
constexpr int kCopyChunks = 2;    // 16-byte loads in flight per thread of a copy block
constexpr int kCopyBytes = 32768; // about this many bytes, whole rows, per copy block

struct Args {
  const uint8_t* pred;
  long long pred_sb, pred_sy;  // item and row strides of pred, in bytes
  const uint8_t* src;          // fused: frames (N,H,W,3); in place: out
  uint8_t* out;                // (B,H,W,3)
  const void* idxs;            // (B,) cycle indices, int32 or int64; null: item b
  const int32_t* boxes;        // rect: (N,4) y1,y2,x1,x2 by index
  const int32_t* origins;      // mask: (N,2) oy, ox
  const int32_t* scalars;      // mask: (N,4) h, w, dy, dx
  const uint8_t* masks;        // mask: (N,Ho,Wo)
  int idx64, S, H, W, Ho, Wo, feather;
  int n_blend;                 // blend blocks per item (then the copy blocks)
  int copy_rows;               // frame rows per copy block
  int vec;                     // frames and out rows start on 16 bytes
  int pred_vec;                // pred rows start on 16 bytes, S*3 % 16 == 0
  int mask_vec;                // mask rows start on 16 bytes
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__device__ __forceinline__ void copy16_async(uint8_t* dst_shared, const uint8_t* src) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(dst_shared);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Shared bytes of a staged row: a box segment of at most Wo pixels (3*Wo
// bytes) or mask bytes, and the alignment of its 16-byte superset.
__host__ __device__ __forceinline__ int seg_row_bytes(int Wo) { return (Wo * 3 + 30 + 15) & ~15; }
__host__ __device__ __forceinline__ int mask_row_bytes(int Wo) { return (Wo + 15) & ~15; }

// Source tap of crop row/col i: first tap, its weight and the next one's.
struct Tap {
  int i0;
  float w0, w1;
};

__device__ __forceinline__ Tap src_tap(int i, float scale, int S) {
  float p = __fsub_rn(__fmul_rn(__fadd_rn((float)i, 0.5f), scale), 0.5f);
  p = fminf(fmaxf(p, 0.0f), (float)(S - 1));
  Tap t;
  t.i0 = (int)floorf(p);
  t.w0 = fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(p, (float)t.i0))));
  t.w1 = (t.i0 + 1 < S) ? fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(p, (float)(t.i0 + 1)))))
                        : 0.0f;
  return t;
}

// x in [0, 255] as a float, exactly, without a conversion instruction (those
// run at an eighth of the fp32 rate): 2^23 + x has x in its low mantissa bits.
__device__ __forceinline__ float u8_to_f(uint32_t x) {
  return __fsub_rn(__int_as_float(0x4B000000u | x), 8388608.0f);
}

// rint(clamp(v, 0, 255)) as a byte, rounding half to even as rintf does:
// adding 2^23 rounds v to an integer in the low mantissa bits.
__device__ __forceinline__ uint8_t f_to_u8(float v) {
  return (uint8_t)__float_as_int(__fadd_rn(fminf(fmaxf(v, 0.0f), 255.0f), 8388608.0f));
}

// byte j of w as a float, likewise: one byte permute builds 2^23 + byte.
__device__ __forceinline__ float byte_to_f(uint32_t w, int j) {
  return __fsub_rn(__int_as_float(__byte_perm(w, 0x4B000000u, 0x7540 + j)), 8388608.0f);
}

// m / 255 correctly rounded, as __fdiv_rn gives it, without a division: one
// fma step corrects the product by the reciprocal (exact for every byte m).
__device__ __forceinline__ float alpha_of(uint32_t m) {
  const float x = u8_to_f(m), r = 1.0f / 255.0f, q = __fmul_rn(x, r);
  return __fmaf_rn(__fmaf_rn(-q, 255.0f, x), r, q);
}

__device__ __forceinline__ float feather_alpha(int i, int n, int feather) {
  if (feather <= 0) return 1.0f;
  const float d = (float)min(i, n - 1 - i);
  return fminf(fmaxf(__fdiv_rn(d + 1.0f, (float)feather), 0.0f), 1.0f);
}

// Stage bytes [lo, hi) of n global rows (row r at src + r*gstride) into
// shared rows of sstride bytes: with vec, the 16-byte aligned superset by
// cp.async (the bytes start at offset lo & 15 of each shared row); else byte
// by byte (offset 0). Returns the offset. The caller waits and syncs.
__device__ __forceinline__ int stage_rows(uint8_t* dst, int sstride, const uint8_t* src,
                                          size_t gstride, int n, int lo, int hi, bool vec,
                                          int tid) {
  if (vec) {
    const int lo_al = lo & ~15, nq = (((hi + 15) & ~15) - lo_al) >> 4;
    for (int t = tid; t < n * nq; t += kThreads) {
      const int r = t / nq, q = (t - r * nq) << 4;
      copy16_async(dst + r * sstride + q, src + r * gstride + lo_al + q);
    }
    return lo - lo_al;
  }
  const int nb = hi - lo;
  for (int t = tid; t < n * nb; t += kThreads) {
    const int r = t / nb, q = t - r * nb;
    dst[r * sstride + q] = src[r * gstride + lo + q];
  }
  return 0;
}

// The in-place mask kind is held to 40 registers (six blocks per SM); the
// others keep the compiler's choice (40 or 48), which measured faster.
template <bool MASKED, bool FUSED>
__global__ void __launch_bounds__(kThreads, MASKED && !FUSED ? 6 : 0) paste_kernel(const Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x;
  // grid (parts, items): each item's blend bands, then its copy parts
  const int b = blockIdx.y, part = blockIdx.x;
  const int S = a.S, H = a.H, W = a.W, Ho = a.Ho, Wo = a.Wo;

  int k = b;  // cycle index of item b
  if (a.idxs != nullptr)
    k = a.idx64 ? (int)((const long long*)a.idxs)[b] : ((const int*)a.idxs)[b];

  int oy, ox, h, w, dy, dx;  // bucket origin; box size and offset in the bucket
  if (MASKED) {
    oy = clampi(a.origins[2 * k], 0, H - Ho);
    ox = clampi(a.origins[2 * k + 1], 0, W - Wo);
    h = a.scalars[4 * k];
    w = a.scalars[4 * k + 1];
    dy = a.scalars[4 * k + 2];
    dx = a.scalars[4 * k + 3];
  } else {
    const int32_t* box = a.boxes + 4 * (size_t)k;  // in place: boxes per item (k = b)
    const int y1 = box[0], y2 = box[1], x1 = box[2], x2 = box[3];
    h = clampi(y2 - y1, 1, Ho);
    w = clampi(x2 - x1, 1, Wo);
    oy = clampi(y1, 0, H - Ho);
    ox = clampi(x1, 0, W - Wo);
    dy = y1 - oy;
    dx = x1 - ox;
  }
  // the box inside the bucket: bucket rows [ry0, ry1), columns [rx0, rx1)
  const int ry0 = max(dy, 0), ry1 = min(dy + h, Ho), rx0 = max(dx, 0), rx1 = min(dx + w, Wo);
  const int rowb = W * 3;
  const size_t frame_bytes = (size_t)H * rowb;
  const uint8_t* src = a.src + (FUSED ? (size_t)k : (size_t)b) * frame_bytes;
  uint8_t* out = a.out + (size_t)b * frame_bytes;
  const int s = 3 * (ox + rx0), e = 3 * (ox + rx1);  // box segment of a row, bytes
  const int yb0 = oy + ry0, yb1 = rx0 < rx1 ? oy + ry1 : yb0;  // frame rows of the box

  if (FUSED && part >= a.n_blend) {
    // copy block: frame rows [cy0, cy1), a row per warp at a time
    const int cy0 = (part - a.n_blend) * a.copy_rows, cy1 = min(cy0 + a.copy_rows, H);
    const int lane = tid & 31;
    if (a.vec) {
      const int nq = rowb >> 4;
      for (int y = cy0 + (tid >> 5); y < cy1; y += kThreads / 32) {
        // chunks [qa, qb) lie inside the box segment; qs, qe straddle its edges
        const bool boxed = y >= yb0 && y < yb1;
        const int qa = boxed ? (s + 15) >> 4 : nq, qb = boxed ? e >> 4 : nq;
        const int qs = boxed && (s & 15) ? s >> 4 : -1, qe = boxed && (e & 15) ? e >> 4 : -1;
        const uint8_t* g = src + (size_t)y * rowb;
        uint8_t* o = out + (size_t)y * rowb;
        for (int q0 = lane; q0 < nq; q0 += 32 * kCopyChunks) {
          uint4 v[kCopyChunks];
#pragma unroll
          for (int u = 0; u < kCopyChunks; ++u) {
            const int q = q0 + 32 * u;
            if (q < nq) v[u] = __ldg((const uint4*)(g + 16 * q));
          }
#pragma unroll
          for (int u = 0; u < kCopyChunks; ++u) {
            const int q = q0 + 32 * u;
            if (q >= nq || (q >= qa && q < qb)) continue;
            if (q == qs || q == qe) {
              for (int j = 16 * q; j < 16 * q + 16; ++j)
                if (j < s || j >= e) o[j] = g[j];
            } else {
              __stcs((uint4*)(o + 16 * q), v[u]);
            }
          }
        }
      }
    } else {
      const int total = (cy1 - cy0) * rowb;
      for (int t = tid; t < total; t += kThreads) {
        const int y = cy0 + t / rowb, col = t % rowb;
        if (y >= yb0 && y < yb1 && col >= s && col < e) continue;
        out[(size_t)y * rowb + col] = src[(size_t)y * rowb + col];
      }
    }
    return;
  }

  // blend block: rows [by0, by0 + n) of the frame, all inside the box
  const int by0 = yb0 + part * kRows;
  const int n = min(yb1 - by0, kRows);
  if (n <= 0) return;  // block-uniform
  const int rowlen = S * 3;
  const int npx = rx1 - rx0;
  const int seg_stride = seg_row_bytes(Wo), mask_stride = mask_row_bytes(Wo);
  float* tbuf = (float*)smem;                          // [kRows][S*3]: rows-first sums
  float* ay = tbuf + kRows * rowlen;                   // [kRows]: rect row alpha
  uint8_t* seg = (uint8_t*)(ay + kRows);               // [kRows][seg_stride]
  uint8_t* mrow = seg + kRows * seg_stride;            // [kRows][mask_stride]
  const float scale_y = __fdiv_rn((float)S, fmaxf((float)h, 1.0f));
  const float scale_x = __fdiv_rn((float)S, fmaxf((float)w, 1.0f));
  const int i_first = by0 - oy - dy;  // row inside the box of the band's first row
  // alpha is 1 everywhere for a hard rect: out = resized, no background needed
  const bool blend_bg = MASKED || a.feather > 0;

  // stage the background and the mask rows (cp.async), then the vertical
  // pass t = wr0*pred[r0] + wr1*pred[r1] over the S*3 values of each row
  // byte s of a row sits at seg_off of its shared row, as stage_rows puts it
  const int seg_off = a.vec ? s & 15 : 0;
  int mask_off = 0;
  if (blend_bg) stage_rows(seg, seg_stride, src + (size_t)by0 * rowb, rowb, n, s, e, a.vec, tid);
  if (MASKED) {
    mask_off = stage_rows(mrow, mask_stride, a.masks + ((size_t)k * Ho + (by0 - oy)) * Wo, Wo,
                          n, rx0, rx1, a.mask_vec, tid);
  } else if (tid < n) {
    ay[tid] = feather_alpha(i_first + tid, h, a.feather);
  }
  const uint8_t* pb = a.pred + (size_t)b * a.pred_sb;
  if (a.pred_vec) {
    const int nq = rowlen >> 4;
    for (int t = tid; t < n * nq; t += kThreads) {
      const int r = t / nq, q = (t - r * nq) << 4;
      const Tap ty = src_tap(i_first + r, scale_y, S);
      const uint4 v0 = __ldg((const uint4*)(pb + (size_t)ty.i0 * a.pred_sy + q));
      const uint4 v1 = __ldg((const uint4*)(pb + (size_t)min(ty.i0 + 1, S - 1) * a.pred_sy + q));
      const uint32_t w0[4] = {v0.x, v0.y, v0.z, v0.w}, w1[4] = {v1.x, v1.y, v1.z, v1.w};
      float4* tr = (float4*)(tbuf + r * rowlen + q);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float f[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          f[j] = __fadd_rn(__fmul_rn(ty.w0, byte_to_f(w0[u], j)),
                           __fmul_rn(ty.w1, byte_to_f(w1[u], j)));
        tr[u] = make_float4(f[0], f[1], f[2], f[3]);
      }
    }
  } else {
    for (int t = tid; t < n * rowlen; t += kThreads) {
      const int r = t / rowlen, q = t - r * rowlen;
      const Tap ty = src_tap(i_first + r, scale_y, S);
      tbuf[r * rowlen + q] =
          __fadd_rn(__fmul_rn(ty.w0, u8_to_f(pb[(size_t)ty.i0 * a.pred_sy + q])),
                    __fmul_rn(ty.w1, u8_to_f(pb[(size_t)min(ty.i0 + 1, S - 1) * a.pred_sy + q])));
    }
  }
  wait_async();
  __syncthreads();

  // horizontal pass and blend: a column per thread, its taps in registers
  for (int c = tid; c < npx; c += kThreads) {
    const int j = rx0 + c - dx;  // column inside the box
    const Tap tx = src_tap(j, scale_x, S);
    const int o0 = 3 * tx.i0, o1 = 3 * min(tx.i0 + 1, S - 1);
    const float ax = MASKED ? 0.0f : feather_alpha(j, w, a.feather);
    for (int r = 0; r < n; ++r) {
      float alpha = 1.0f;
      if (MASKED) {
        const uint8_t m = mrow[r * mask_stride + mask_off + c];
        alpha = alpha_of(m);
      } else if (blend_bg) {
        alpha = __fmul_rn(ay[r], ax);
      }
      const float* tr = tbuf + r * rowlen;
      uint8_t* px = seg + r * seg_stride + seg_off + 3 * c;
      if (!blend_bg) {  // alpha 1: out = resized
#pragma unroll
        for (int ch = 0; ch < 3; ++ch)
          px[ch] = f_to_u8(__fadd_rn(__fmul_rn(tx.w0, tr[o0 + ch]), __fmul_rn(tx.w1, tr[o1 + ch])));
      } else {
        const float beta = __fsub_rn(1.0f, alpha);
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          const float resized =
              __fadd_rn(__fmul_rn(tx.w0, tr[o0 + ch]), __fmul_rn(tx.w1, tr[o1 + ch]));
          px[ch] = f_to_u8(__fadd_rn(__fmul_rn(alpha, resized), __fmul_rn(beta, u8_to_f(px[ch]))));
        }
      }
    }
  }
  __syncthreads();

  // the segments back: whole 16-byte chunks as vectors, head and tail bytes alone
  if (a.vec) {
    const int s_al = s & ~15, nq = (((e + 15) & ~15) - s_al) >> 4;
    for (int t = tid; t < n * nq; t += kThreads) {
      const int rr = t / nq, q = (t - rr * nq) << 4;
      const int lo = s_al + q;
      uint8_t* g = out + (size_t)(by0 + rr) * rowb + lo;
      const uint8_t* sm = seg + rr * seg_stride + q;
      if (lo >= s && lo + 16 <= e) {
        *(uint4*)g = *(const uint4*)sm;
      } else {
        for (int u = max(s - lo, 0); u < min(e - lo, 16); ++u) g[u] = sm[u];
      }
    }
  } else {
    const int nb = e - s;
    for (int t = tid; t < n * nb; t += kThreads) {
      const int rr = t / nb, q = t - rr * nb;
      out[(size_t)(by0 + rr) * rowb + s + q] = seg[rr * seg_stride + q];
    }
  }
}

size_t smem_bytes(bool masked, int S, int Wo) {
  return (size_t)kRows * S * 3 * 4 + 4 * kRows + (size_t)kRows * seg_row_bytes(Wo) +
         (masked ? (size_t)kRows * mask_row_bytes(Wo) : 0);
}

template <bool MASKED, bool FUSED>
int launch(Args& a, int B, void* stream) {
  a.n_blend = (a.Ho + kRows - 1) / kRows;
  a.copy_rows = max(kThreads / 32, (kCopyBytes / (a.W * 3)) & ~(kThreads / 32 - 1));
  const int parts = a.n_blend + (FUSED ? (a.H + a.copy_rows - 1) / a.copy_rows : 0);
  const dim3 grid(parts, B);
  const size_t smem = smem_bytes(MASKED, a.S, a.Wo);
  if (smem > 48 * 1024) {  // set on every such launch: the attribute is per device
    const cudaError_t err = cudaFuncSetAttribute(
        paste_kernel<MASKED, FUSED>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  paste_kernel<MASKED, FUSED><<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point for ctypes. masked: 0 rect (boxes), 1 mask (origins, scalars,
// masks). fused: 1 writes out (B,H,W,3) whole from frames (N,H,W,3) at idxs;
// 0 blends into out (B,H,W,3) in place (src ignored; rect: boxes (B,4) per
// item and idxs null; mask: idxs into the planes). pred (B,S,S,3) u8 with
// item and row strides in bytes, pixels of 3 contiguous bytes. idxs int32,
// or int64 with idx64. The caller guarantees 0 <= idxs < N, 0 < Ho <= H,
// 0 < Wo <= W, feather >= 0, and contiguous frames, out, idxs and planes on
// one device. Returns cudaGetLastError() of the launch (0 = launched).
extern "C" int paste_launch(int masked, int fused, const void* pred, long long pred_sb,
                            long long pred_sy, const void* src, void* out, const void* idxs,
                            int idx64, const void* boxes, const void* origins,
                            const void* scalars, const void* masks, int B, int S, int H, int W,
                            int Ho, int Wo, int feather, void* stream) {
  if (B == 0) return 0;
  if ((long long)H * W * 3 >= (1LL << 31)) return (int)cudaErrorInvalidValue;  // 32-bit offsets
  Args a;
  a.pred = (const uint8_t*)pred;
  a.pred_sb = pred_sb;
  a.pred_sy = pred_sy;
  a.src = (const uint8_t*)(fused ? src : out);
  a.out = (uint8_t*)out;
  a.idxs = idxs;
  a.boxes = (const int32_t*)boxes;
  a.origins = (const int32_t*)origins;
  a.scalars = (const int32_t*)scalars;
  a.masks = (const uint8_t*)masks;
  a.idx64 = idx64;
  a.S = S, a.H = H, a.W = W, a.Ho = Ho, a.Wo = Wo, a.feather = feather;
  a.vec = ((uintptr_t)a.src % 16 == 0) && ((uintptr_t)out % 16 == 0) && ((W * 3) % 16 == 0);
  a.pred_vec = ((uintptr_t)pred % 16 == 0) && (pred_sb % 16 == 0) && (pred_sy % 16 == 0) &&
               ((S * 3) % 16 == 0);
  a.mask_vec = ((uintptr_t)masks % 16 == 0) && (Wo % 16 == 0);
  if (fused)
    return masked ? launch<true, true>(a, B, stream) : launch<false, true>(a, B, stream);
  return masked ? launch<true, false>(a, B, stream) : launch<false, false>(a, B, stream);
}
