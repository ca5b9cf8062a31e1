// Mouth-ROI sampler: bilinear crop-resize of each gray frame to R x R, then
// (x / 255 - mean) / std.
//
// Replaces the Pallas kernel `_roi_kernel` (lipreading_tpu/ops/roi.py:107,
// via `sample_rois_pallas` :154, `pallas_call` :181). That kernel builds two
// dense interpolation matrices per frame, W_y [R, H] and W_x [R, W], and
// takes W_y . g . W_x^T on the matrix unit. Each row of those matrices has
// two nonzero taps, so here every output pixel is a direct two-by-two
// gather and lerp:
//
//     roi[r, c] = wx0 * (wy0 * g[y0, x0]     + wy1 * g[y0 + 1, x0])
//               + wx1 * (wy0 * g[y0, x0 + 1] + wy1 * g[y0 + 1, x0 + 1])
//
// (first the rows, W_y . g, then the columns, as the dense product groups
// them; the result differs from the dense float32 product only where that
// product fuses a multiply-add, by a float32 ulp or so).
//
// Bound on the H100: the bytes are N R^2 4 of ROI written and the gray the
// taps touch read (a ~33-pixel mouth box of a 160x160 frame: 31.7 MB at the
// serving batch of 768 frames, 0.0095 ms at 3.35 TB/s), but a kernel that
// spends ~80 instructions a pixel is bound by instruction issue long before
// that: 7.08 M pixels at 132 SMs x 4 schedulers is ~20 us of issue alone.
// So the design cuts the instructions a pixel:
//
// * A thread computes 4 adjacent columns of one output row and writes them
//   with one 16-byte store (a scalar store per column where R is not a
//   multiple of 4). Its 4 column taps and fractions are read once, as two
//   16-byte shared loads, and stay in registers for every row it does.
// * No integer division a pixel: a thread's column quad and first row come
//   from its index once (a 2-D mapping: `tpr` threads across a row, `rpp`
//   rows a pass), the rows advance by `rpp`.
// * Row tap and weight are read once a row; 1 - w is formed once a row and
//   once a column, not once a pixel.
// * A block covers a band of up to 10 row passes of one frame: at R 96,
//   10 rows a pass, the whole frame. The launch (threads across a row, rows
//   a pass, the band, threads and shared memory a block) is ops/roi.py
//   `roi_plan`, handed to the C entry, which refuses a plan that would miss
//   a pixel or write one twice. A block pays a fixed prologue (the box, its
//   taps, the staged copy), and on the card fewer, longer blocks ran faster
//   than bands of 1-5 passes (PERF.md section 6). The serving batch, 768
//   frames, is one wave of 6 blocks an SM; larger batches take the frames as
//   SMs free up.
// * The tap arithmetic is `_roi_kernel`'s, each step rounded on its own
//   (__fmul_rn, __fdiv_rn, ...): a fused multiply-add would move the
//   floor() that picks a tap. The lerp order and its roundings are those of
//   the dense product's rows-then-columns grouping.
// * The normalisation stays (v / 255 - mean) / std with both quotients
//   correctly rounded, but / 255 is a multiply by the reciprocal and one
//   fused correction (`div255`), equal to the division on every float
//   (`roi_div255_check`, run by chip_smoke.py): the two divisions took
//   30 % of the old kernel's time at the serving batch. / std keeps
//   __fdiv_rn: its divisor comes from the config.
// * Gray loads: the band's touched source rectangle is copied into shared
//   memory first by `cp.async` (16 bytes where the frame's rows are 16-byte
//   aligned, else 4), and the two-by-two taps read it there. On the card
//   this read faster than gathering every tap through the read-only cache
//   (`__ldg`), at both timed batches (PERF.md section 6). A band whose
//   rectangle exceeds the staging buffer (a box much larger than the ROI)
//   gathers its taps with `__ldg` instead.
//
// What holds it now (PERF.md section 6): at 768 frames, one wave whose
// blocks all wait on their prologue at once; at 4096 frames, the store
// rate (68 % of the byte bound) and the divisions that remain.
//
// Box modes (boxes [N, 3] = x0, y0, size):
//   integer (int32 boxes): floor in crop coordinates, then shift by the
//     origin and clamp into the frame;
//   subpixel (float32 boxes): shift to frame coordinates first, then floor.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;  // a block: the kernel's launch bound
constexpr int kBadPlan = -1;      // returned for a plan the entry refuses

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

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(d), "l"(src) : "memory");
}

// x / 255, correctly rounded: the quotient by the reciprocal, then one
// fused correction by its exact residual, and x's sign (a zero quotient
// keeps it, as the division's does); an infinite x passes through (its
// residual would be inf - inf). 6 instructions where __fdiv_rn takes ~9
// and a branch to its slow path; `roi_div255_check` holds it equal to
// __fdiv_rn(x, 255) bit for bit on every float.
__device__ __forceinline__ float div255(float x) {
  constexpr float kRcp = 1.0f / 255.0f;   // rounded to the nearest float
  const float q = __fmul_rn(x, kRcp);
  const float r = copysignf(__fmaf_rn(__fmaf_rn(-q, 255.0f, x), kRcp, q), x);
  return isinf(x) ? x : r;
}

template <bool kShared>
__device__ __forceinline__ float load(const float* p) {
  return kShared ? *p : __ldg(p);
}

// One output pixel from the row pair p0, p1 (p1 = p0 + pitch) at column
// tap x: rows first, then columns, each product and sum rounded.
template <bool kShared>
__device__ __forceinline__ float lerp2x2(const float* p0, const float* p1,
                                         int x, float wy0, float wy1,
                                         float wx0, float wx1) {
  const float a = __fadd_rn(__fmul_rn(wy0, load<kShared>(p0 + x)),
                            __fmul_rn(wy1, load<kShared>(p1 + x)));
  const float b = __fadd_rn(__fmul_rn(wy0, load<kShared>(p0 + x + 1)),
                            __fmul_rn(wy1, load<kShared>(p1 + x + 1)));
  return __fadd_rn(__fmul_rn(a, wx0), __fmul_rn(b, wx1));
}

// The band's rows [r_lo, r_hi) from `src` (gray rows of `pitch` floats,
// column taps shifted by `x_off`, row taps by `y_off`).
template <bool kVec, bool kShared>
__device__ __forceinline__ void sample_band(
    const float* src, int pitch, int x_off, int y_off, const int* tx,
    const float* fx, const int* ty, const float* fy, float* o, int R, int Q,
    int tpr, int rpp, int r_lo, int r_hi, float mean, float stddev,
    int normalize) {
  const int qi = threadIdx.x % tpr;   // once a thread, not once a pixel
  const int ri = threadIdx.x / tpr;
  if (ri >= rpp) return;              // the block's last warp, rounded up
  for (int q = qi; q < Q; q += tpr) {
    const int c = 4 * q;
    const int4 xi = *reinterpret_cast<const int4*>(tx + c);
    const float4 w1 = *reinterpret_cast<const float4*>(fx + c);
    const int x0 = xi.x - x_off, x1 = xi.y - x_off;
    const int x2 = xi.z - x_off, x3 = xi.w - x_off;
    const float w0x = __fsub_rn(1.0f, w1.x), w0y = __fsub_rn(1.0f, w1.y);
    const float w0z = __fsub_rn(1.0f, w1.z), w0w = __fsub_rn(1.0f, w1.w);
    for (int r = r_lo + ri; r < r_hi; r += rpp) {
      const float wy1 = fy[r - r_lo], wy0 = __fsub_rn(1.0f, wy1);
      const float* p0 = src + (ty[r - r_lo] - y_off) * pitch;
      const float* p1 = p0 + pitch;
      float v[4] = {lerp2x2<kShared>(p0, p1, x0, wy0, wy1, w0x, w1.x),
                    lerp2x2<kShared>(p0, p1, x1, wy0, wy1, w0y, w1.y),
                    lerp2x2<kShared>(p0, p1, x2, wy0, wy1, w0z, w1.z),
                    lerp2x2<kShared>(p0, p1, x3, wy0, wy1, w0w, w1.w)};
      if (normalize) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          v[k] = __fdiv_rn(__fsub_rn(div255(v[k]), mean), stddev);
      }
      float* dst = o + r * R + c;
      if (kVec) {
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (c + k < R) dst[k] = v[k];
      }
    }
  }
}

// The launch (ops/roi.py `roi_plan`): N bands blocks of `threads`; block
// (n, i) covers rows [band i, band (i + 1)) of frame n. Dynamic shared
// memory: column taps and fractions [4 Q] each, row taps and fractions
// [band rounded up to 4] each, then a staging buffer of `stage_floats`.
template <bool kSubpixel, bool kVec, typename BoxT>
__global__ void __launch_bounds__(kMaxThreads)
roi_sample_kernel(const float* __restrict__ gray,
                  const BoxT* __restrict__ boxes, float* __restrict__ out,
                  int H, int W, int R, int Q, int tpr, int rpp, int band,
                  int bands, int stage_floats, float mean, float stddev,
                  int normalize) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_rect[3];   // staged: pitch (0: gathered), x_lo, y_lo
  const int band4 = (band + 3) & ~3;
  int* tx = reinterpret_cast<int*>(smem_raw);      // [4 Q] column tap
  float* fx = reinterpret_cast<float*>(tx + 4 * Q);  // [4 Q] column fraction
  int* ty = reinterpret_cast<int*>(fx + 4 * Q);    // [band4] row tap
  float* fy = reinterpret_cast<float*>(ty + band4);  // [band4] row fraction
  float* stage = fy + band4;                       // [stage_floats]

  const int n = blockIdx.x / bands;
  const int r_lo = (blockIdx.x - n * bands) * band;
  const int r_hi = min(r_lo + band, R);
  const float x0 = (float)boxes[3 * n + 0];
  const float y0 = (float)boxes[3 * n + 1];
  const float size = (float)boxes[3 * n + 2];
  const float* g = gray + (size_t)n * H * W;
  float* o = out + (size_t)n * R * R;

  if (threadIdx.x < 32) {
    // warp 0 stages the rectangle the band's taps touch (taps are monotone
    // in the output index: the first and last column, the band's first and
    // last row) while the other warps compute the taps
    const int lane = threadIdx.x;
    int i0 = 0;
    float f;
    if (lane < 2)
      interp_tap<kSubpixel>(lane ? R - 1 : 0, x0, size, W, R, &i0, &f);
    else if (lane < 4)
      interp_tap<kSubpixel>(lane == 2 ? r_lo : r_hi - 1, y0, size, H, R, &i0,
                            &f);
    const int x_first = __shfl_sync(0xffffffffu, i0, 0);
    const int x_last = __shfl_sync(0xffffffffu, i0, 1);
    const int y_lo = __shfl_sync(0xffffffffu, i0, 2);
    const int rows = __shfl_sync(0xffffffffu, i0, 3) + 2 - y_lo;
    // 16-byte copies where the frame's rows are 16-byte aligned
    const bool vec = ((W & 3) == 0) &&
                     ((reinterpret_cast<uintptr_t>(g) & 15) == 0);
    const int x_lo = vec ? (x_first & ~3) : x_first;
    const int pitch = (vec ? ((x_last + 2 + 3) & ~3) : x_last + 2) - x_lo;
    const bool fits = rows * pitch <= stage_floats;
    if (fits && vec) {
      const int per_row = pitch >> 2;
      for (int i = lane; i < rows * per_row; i += 32) {
        const int rr = i / per_row, cc = (i - rr * per_row) * 4;
        cp_async16(stage + rr * pitch + cc,
                   g + (size_t)(y_lo + rr) * W + x_lo + cc);
      }
    } else if (fits) {
      for (int i = lane; i < rows * pitch; i += 32) {
        const int rr = i / pitch, cc = i - rr * pitch;
        cp_async4(stage + rr * pitch + cc,
                  g + (size_t)(y_lo + rr) * W + x_lo + cc);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (lane == 0) {
      s_rect[0] = fits ? pitch : 0;
      s_rect[1] = x_lo;
      s_rect[2] = y_lo;
    }
  }
  // the last quad's columns past R repeat column R - 1 (never stored)
  for (int j = threadIdx.x; j < 4 * Q; j += blockDim.x)
    interp_tap<kSubpixel>(min(j, R - 1), x0, size, W, R, &tx[j], &fx[j]);
  for (int j = threadIdx.x; j < r_hi - r_lo; j += blockDim.x)
    interp_tap<kSubpixel>(r_lo + j, y0, size, H, R, &ty[j], &fy[j]);
  if (threadIdx.x < 32) asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();   // taps and the staged rectangle, for every thread

  if (s_rect[0] > 0) {
    sample_band<kVec, true>(stage, s_rect[0], s_rect[1], s_rect[2], tx, fx,
                            ty, fy, o, R, Q, tpr, rpp, r_lo, r_hi, mean,
                            stddev, normalize);
  } else {
    sample_band<kVec, false>(g, W, 0, 0, tx, fx, ty, fy, o, R, Q, tpr, rpp,
                             r_lo, r_hi, mean, stddev, normalize);
  }
}

// One launch's sizes: the frames, the plan's, and the normalisation.
struct RoiLaunch {
  int N, H, W, R, Q, tpr, rpp, band, bands, stage_floats, threads, smem;
  float mean, stddev;
  int normalize;
};

template <bool kSubpixel, bool kVec, typename BoxT>
int launch(const float* g, const BoxT* boxes, float* o, const RoiLaunch& l,
           cudaStream_t s) {
  if (l.smem > 48 * 1024) {   // the device refuses more than it has
    const cudaError_t e = cudaFuncSetAttribute(
        roi_sample_kernel<kSubpixel, kVec, BoxT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, l.smem);
    if (e != cudaSuccess) return (int)e;
  }
  roi_sample_kernel<kSubpixel, kVec, BoxT>
      <<<(unsigned)(l.N * l.bands), l.threads, l.smem, s>>>(
          g, boxes, o, l.H, l.W, l.R, l.Q, l.tpr, l.rpp, l.band, l.bands,
          l.stage_floats, l.mean, l.stddev, l.normalize);
  return (int)cudaGetLastError();
}

// Every float bit pattern: where div255 and __fdiv_rn(x, 255) give other
// bits (two NaNs count as equal), differ[0] counts x in [-256, 256] (the
// blends of gray values in [0, 255], which may round a little past 255),
// differ[1] the other finite x, differ[2] the infinities and NaNs.
__global__ void div255_check_kernel(unsigned* differ) {
  unsigned near = 0, far = 0, inf = 0;
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned long long i = blockIdx.x * blockDim.x + threadIdx.x;
       i < (1ull << 32); i += stride) {
    const float x = __uint_as_float((unsigned)i);
    const float a = div255(x), b = __fdiv_rn(x, 255.0f);
    const bool bad = __float_as_uint(a) != __float_as_uint(b) &&
                     !(a != a && b != b);
    near += bad && fabsf(x) <= 256.0f;
    far += bad && fabsf(x) > 256.0f && isfinite(x);
    inf += bad && !isfinite(x);
  }
  if (near) atomicAdd(differ, near);
  if (far) atomicAdd(differ + 1, far);
  if (inf) atomicAdd(differ + 2, inf);
}

}  // namespace

// gray [N, H, W] f32, boxes [N, 3] (int32, or f32 when subpixel),
// out [N, R, R] f32; all contiguous on the device of `stream`. The launch,
// from ops/roi.py `roi_plan`: `tpr` threads across a row (a column quad of
// 4 each), `rpp` rows a pass, bands of `band` rows, `threads` and `smem`
// bytes of dynamic shared memory a block. A plan that would miss a pixel
// (tpr rpp > threads), exceed the kernel's launch bound or leave no room for
// the taps is refused (kBadPlan) before any launch.
extern "C" int roi_sample(const void* gray, const void* boxes, void* out,
                          int N, int H, int W, int R, float mean, float stddev,
                          int normalize, int subpixel, int tpr, int rpp,
                          int band, int threads, int smem, void* stream) {
  cudaGetLastError();  // clear an earlier, unrelated error
  const int Q = (R + 3) / 4;
  const int band4 = (band + 3) & ~3;
  const int stage_floats = smem / 4 - 8 * Q - 2 * band4;
  if (tpr < 1 || rpp < 1 || band < 1 || threads % 32 != 0 ||
      tpr * rpp > threads || threads > kMaxThreads || smem % 16 != 0 ||
      stage_floats < 0)
    return kBadPlan;
  if (N == 0) return 0;
  const RoiLaunch l = {N, H, W, R, Q, tpr, rpp, band, (R + band - 1) / band,
                       stage_floats, threads, smem, mean, stddev, normalize};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gray);
  float* o = static_cast<float*>(out);
  // 16-byte stores need R a multiple of 4 and an aligned output
  const bool vec = (R % 4 == 0) && (reinterpret_cast<uintptr_t>(o) % 16 == 0);
  const float* bf = static_cast<const float*>(boxes);
  const int32_t* bi = static_cast<const int32_t*>(boxes);
  if (subpixel) {
    return vec ? launch<true, true>(g, bf, o, l, s)
               : launch<true, false>(g, bf, o, l, s);
  }
  return vec ? launch<false, true>(g, bi, o, l, s)
             : launch<false, false>(g, bi, o, l, s);
}

// differ: three uint32 on the device, zeroed by the caller (see
// div255_check_kernel).
extern "C" int roi_div255_check(void* differ, void* stream) {
  cudaGetLastError();  // clear an earlier, unrelated error
  div255_check_kernel<<<132 * 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned*>(differ));
  return (int)cudaGetLastError();
}
