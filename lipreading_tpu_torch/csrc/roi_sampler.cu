// Mouth-ROI sampler: bilinear crop-resize of each gray frame to R x R, then
// (x / 255 - mean) / std.
//
// Replaces the Pallas kernel `_roi_kernel` / `sample_rois_pallas` in
// lipreading_tpu/ops/roi.py. That kernel builds two dense interpolation
// matrices per frame, W_y [R, H] and W_x [R, W], and takes W_y . g . W_x^T on
// the matrix unit. Each row of those matrices has two nonzero taps, so here
// every output pixel is a direct two-by-two gather and lerp:
//
//     roi[r, c] = wx0 * (wy0 * g[y0, x0]     + wy1 * g[y0 + 1, x0])
//               + wx1 * (wy0 * g[y0, x0 + 1] + wy1 * g[y0 + 1, x0 + 1])
//
// (first the rows, W_y . g, then the columns, as the dense product groups
// them; the result differs from the dense float32 product only where that
// product fuses a multiply-add, by a float32 ulp or so).
//
// Bound on the H100: memory. The function writes N*R*R*4 bytes of ROI and
// reads at most N*H*W*4 bytes of gray: only the rows and columns that the
// taps touch are needed (a 40-pixel mouth box in a 160x160 frame is about
// 7% of it). It does ~10 float32 operations per output pixel, far below the
// card's ~20 operations a byte. Design: one block per frame, one thread per
// output pixel in a strided loop; the block's threads first compute the tap
// index and fraction of each output row and column once into shared memory
// (the same fp32 arithmetic as `_roi_kernel`, each step rounded on its own
// (__fmul_rn, __fdiv_rn, ...) so no fused multiply-add moves the floor()
// that picks a tap), then every thread walks output pixels with
// neighbouring threads on neighbouring columns: the stores are coalesced and
// the two-tap loads of a warp fall in a few cache lines of the crop. No
// matrix unit, no dense weights, nothing outside the crop is read.
//
// Box modes (boxes [N, 3] = x0, y0, size):
//   integer (int32 boxes): floor in crop coordinates, then shift by the
//     origin and clamp into the frame;
//   subpixel (float32 boxes): shift to frame coordinates first, then floor.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// Tap index i0 (the second tap is i0 + 1) and the weight of the second tap.
template <bool kSubpixel>
__device__ __forceinline__ void interp_tap(int j, float start, float size,
                                           int src_dim, int out_size,
                                           int* i0_out, float* frac_out) {
  // src = (j + 0.5) * (size / out) - 0.5, clipped to the crop interior
  float src = __fsub_rn(__fmul_rn(__fadd_rn((float)j, 0.5f),
                                  __fdiv_rn(size, (float)out_size)),
                        0.5f);
  src = fminf(fmaxf(src, 0.0f), __fsub_rn(size, 1.0f));
  float i0, frac;
  if (kSubpixel) {
    src = fminf(fmaxf(__fadd_rn(src, start), 0.0f), (float)(src_dim - 1));
    i0 = fminf(fmaxf(floorf(src), 0.0f), (float)(src_dim - 2));
    frac = __fsub_rn(src, i0);
  } else {
    i0 = fminf(floorf(src), fmaxf(__fsub_rn(size, 2.0f), 0.0f));
    frac = __fsub_rn(src, i0);
    i0 = fminf(fmaxf(__fadd_rn(i0, start), 0.0f), (float)(src_dim - 2));
  }
  *i0_out = (int)i0;
  *frac_out = frac;
}

template <bool kSubpixel, typename BoxT>
__global__ void __launch_bounds__(kThreads)
roi_sample_kernel(const float* __restrict__ gray, const BoxT* __restrict__ boxes,
                  float* __restrict__ out, int H, int W, int R, float mean,
                  float stddev, int normalize) {
  extern __shared__ unsigned char smem_raw[];
  int* ty = reinterpret_cast<int*>(smem_raw);   // [R] row tap
  int* tx = ty + R;                             // [R] column tap
  float* fy = reinterpret_cast<float*>(tx + R); // [R] row fraction
  float* fx = fy + R;                           // [R] column fraction

  const int n = blockIdx.x;
  const float x0 = (float)boxes[3 * n + 0];
  const float y0 = (float)boxes[3 * n + 1];
  const float size = (float)boxes[3 * n + 2];
  for (int j = threadIdx.x; j < R; j += blockDim.x) {
    interp_tap<kSubpixel>(j, y0, size, H, R, &ty[j], &fy[j]);
    interp_tap<kSubpixel>(j, x0, size, W, R, &tx[j], &fx[j]);
  }
  __syncthreads();

  const float* g = gray + (size_t)n * H * W;
  float* o = out + (size_t)n * R * R;
  for (int p = threadIdx.x; p < R * R; p += blockDim.x) {
    const int r = p / R;
    const int c = p - r * R;
    const float* row0 = g + (size_t)ty[r] * W + tx[c];
    const float* row1 = row0 + W;
    const float wy1 = fy[r], wy0 = __fsub_rn(1.0f, wy1);
    const float wx1 = fx[c], wx0 = __fsub_rn(1.0f, wx1);
    // rows first (W_y . g), then columns (. W_x^T)
    const float a = __fadd_rn(__fmul_rn(wy0, __ldg(row0)),
                              __fmul_rn(wy1, __ldg(row1)));
    const float b = __fadd_rn(__fmul_rn(wy0, __ldg(row0 + 1)),
                              __fmul_rn(wy1, __ldg(row1 + 1)));
    float v = __fadd_rn(__fmul_rn(a, wx0), __fmul_rn(b, wx1));
    if (normalize) {
      v = __fdiv_rn(__fsub_rn(__fdiv_rn(v, 255.0f), mean), stddev);
    }
    o[p] = v;
  }
}

}  // namespace

// gray [N, H, W] f32, boxes [N, 3] (int32, or f32 when subpixel),
// out [N, R, R] f32; all contiguous on the device of `stream`.
extern "C" int roi_sample(const void* gray, const void* boxes, void* out,
                          int N, int H, int W, int R, float mean, float stddev,
                          int normalize, int subpixel, void* stream) {
  cudaGetLastError();  // clear an earlier, unrelated error
  if (N == 0) return 0;
  const size_t smem = (size_t)R * (2 * sizeof(int) + 2 * sizeof(float));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gray);
  float* o = static_cast<float*>(out);
  if (subpixel) {
    roi_sample_kernel<true, float><<<N, kThreads, smem, s>>>(
        g, static_cast<const float*>(boxes), o, H, W, R, mean, stddev,
        normalize);
  } else {
    roi_sample_kernel<false, int32_t><<<N, kThreads, smem, s>>>(
        g, static_cast<const int32_t*>(boxes), o, H, W, R, mean, stddev,
        normalize);
  }
  return (int)cudaGetLastError();
}
