// Rect paste-back for Hopper: bilinear resize of a predicted (S, S) mouth
// crop into its bbox, feathered alpha blend over the frame, paste in place.
//
// Replaces livetalking_tpu/ops/pallas_blend.py::_blend_kernel (the TPU
// kernel behind _blend_pallas / _paste_step). Same function as _paste_step
// after its full-frame gather, with the same arithmetic:
//   h = clip(y2-y1, 1, Ho)   w = clip(x2-x1, 1, Wo)
//   oy = clip(y1, 0, H-Ho)   ox = clip(x1, 0, W-Wo)   dy = y1-oy   dx = x1-ox
//   source position of crop row i: clip((i+0.5)*S/max(h,1) - 0.5, 0, S-1)
//   weight of source row j: max(0, 1 - |pos - j|)   (bilinear = unit tent)
//   alpha = ay*ax, a = clip((min(i, h-1-i)+1)/feather, 0, 1) inside the bbox
//   out = rint(alpha*resized + (1-alpha)*bg), clamped to [0, 255]
//
// Design. The TPU kernel builds dense interpolation matrices Rv (Ho,S) and
// Rh (S,Wo) and runs Rv*pred*Rh on the matrix unit. Each output pixel has at
// most 2x2 non-zero weights, so here one thread owns one crop pixel and
// reads its four taps directly, all three channels per thread. No shared
// memory, no matrices.
//
// What bounds it: memory. Per item it must read the predicted crop
// (3*S*S bytes, an upper bound), read the background inside the bbox and
// write it back (2*3*h*w bytes). At S=256 and a 240x256 bucket that is about
// 565 KB per item: B=16 moves 9.0 MB (about 2.7 us at the H100 SXM's
// 3.35 TB/s, a launch-latency regime), B=128 moves 72 MB (about 22 us).
// These figures are computed from the shapes, not measured; PERF.md holds
// the measured times.
//
// In place: `out` holds the gathered full frames (B, H, W, 3) uint8 and the
// kernel overwrites the pixels inside each item's bbox. Pixels outside the
// bbox have alpha 0 and equal their background exactly, so they are never
// written. The kernel allocates nothing and launches on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// Source position of crop row/col i for an S -> n resize (cv2 INTER_LINEAR
// half-pixel centres, clamped to the edge). Rounded step by step, as the
// reference computes it, so no FMA contraction changes the taps.
__device__ __forceinline__ float src_pos(int i, int n, int S) {
  float scale = __fdiv_rn((float)S, fmaxf((float)n, 1.0f));
  float p = __fsub_rn(__fmul_rn(__fadd_rn((float)i, 0.5f), scale), 0.5f);
  return fminf(fmaxf(p, 0.0f), (float)(S - 1));
}

__device__ __forceinline__ float feather_alpha(int i, int n, int feather) {
  if (feather <= 0) return 1.0f;
  float d = (float)min(i, n - 1 - i);
  return fminf(fmaxf(__fdiv_rn(d + 1.0f, (float)feather), 0.0f), 1.0f);
}

__global__ void blend_rect_kernel(const uint8_t* __restrict__ pred,
                                  uint8_t* __restrict__ out,
                                  const int32_t* __restrict__ boxes,
                                  int S, int H, int W, int Ho, int Wo,
                                  int feather) {
  const int b = blockIdx.z;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;  // row in the bucket
  const int x = blockIdx.x * blockDim.x + threadIdx.x;  // col in the bucket
  if (y >= Ho || x >= Wo) return;

  const int32_t* box = boxes + 4 * b;  // y1, y2, x1, x2
  const int y1 = box[0], y2 = box[1], x1 = box[2], x2 = box[3];
  const int h = clampi(y2 - y1, 1, Ho);
  const int w = clampi(x2 - x1, 1, Wo);
  const int oy = clampi(y1, 0, H - Ho);
  const int ox = clampi(x1, 0, W - Wo);
  const int i = y - (y1 - oy);  // row inside the bbox
  const int j = x - (x1 - ox);  // col inside the bbox
  if (i < 0 || i >= h || j < 0 || j >= w) return;  // alpha 0: bg unchanged

  const float py = src_pos(i, h, S);
  const float px = src_pos(j, w, S);
  const int r0 = (int)floorf(py);
  const int c0 = (int)floorf(px);
  const int r1 = min(r0 + 1, S - 1);
  const int c1 = min(c0 + 1, S - 1);
  const float wr0 = fmaxf(0.0f, 1.0f - fabsf(py - (float)r0));
  const float wr1 = (r0 + 1 < S) ? fmaxf(0.0f, 1.0f - fabsf(py - (float)(r0 + 1))) : 0.0f;
  const float wc0 = fmaxf(0.0f, 1.0f - fabsf(px - (float)c0));
  const float wc1 = (c0 + 1 < S) ? fmaxf(0.0f, 1.0f - fabsf(px - (float)(c0 + 1))) : 0.0f;

  const float alpha = feather_alpha(i, h, feather) * feather_alpha(j, w, feather);

  const size_t pb = (size_t)b * S * S * 3;
  const uint8_t* p00 = pred + pb + ((size_t)r0 * S + c0) * 3;
  const uint8_t* p01 = pred + pb + ((size_t)r0 * S + c1) * 3;
  const uint8_t* p10 = pred + pb + ((size_t)r1 * S + c0) * 3;
  const uint8_t* p11 = pred + pb + ((size_t)r1 * S + c1) * 3;
  uint8_t* o = out + (((size_t)b * H + (oy + y)) * W + (ox + x)) * 3;

#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float top = wc0 * (float)p00[c] + wc1 * (float)p01[c];
    const float bot = wc0 * (float)p10[c] + wc1 * (float)p11[c];
    const float resized = wr0 * top + wr1 * bot;
    const float v = alpha * resized + (1.0f - alpha) * (float)o[c];
    o[c] = (uint8_t)fminf(fmaxf(rintf(v), 0.0f), 255.0f);
  }
}

}  // namespace

// C entry point for ctypes. pred (B,S,S,3) u8, out (B,H,W,3) u8 updated in
// place, boxes (B,4) i32 (y1,y2,x1,x2) already gathered per item. The caller
// guarantees 0 < Ho <= H, 0 < Wo <= W and contiguous buffers on one device.
// Returns the launch's cudaGetLastError() as an int (0 = launched).
extern "C" int blend_rect_launch(const void* pred, void* out, const void* boxes,
                                 int B, int S, int H, int W, int Ho, int Wo,
                                 int feather, void* stream) {
  if (B == 0) return 0;
  const dim3 block(32, 8);
  const dim3 grid((Wo + block.x - 1) / block.x, (Ho + block.y - 1) / block.y, B);
  blend_rect_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)pred, (uint8_t*)out, (const int32_t*)boxes,
      S, H, W, Ho, Wo, feather);
  return (int)cudaGetLastError();
}
