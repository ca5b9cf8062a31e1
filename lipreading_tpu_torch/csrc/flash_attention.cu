// Flash attention for the transformer encoder's self-attention:
// length-masked, non-causal multi-head attention with an online softmax,
// and its two backwards.
//
// Replaces the Pallas kernels of lipreading_tpu/ops/flash_attention.py:
//   flash_fwd        <- `_flash_kernel` (:74, via `_flash_fwd_impl`)
//   flash_bwd_fused  <- `_bwd_fused_kernel` (:326, via `_flash_bwd_fused_impl`)
//   flash_bwd_dq     <- `_bwd_dq_kernel` (:228, via `_flash_bwd_impl`)
//   flash_bwd_dkv    <- `_bwd_dkv_kernel` (:274, via `_flash_bwd_impl`)
//
// q, k, v, dO, out, dq, dk, dv are [B, T, H, D] in the activation type (float
// or bf16), lengths [B] int32 (clamped to [0, T]), lse [B, H, T] float32,
// delta = rowsum(dO * out) [B, T, H] float32 (formed outside, in the
// activation type, as the JAX package forms it). With s = (q . k) / sqrt(D)
// in float32 from the upcast inputs and keys at or past the length set to
// -1e30:
//   forward:  out = sum_j exp(s_j - m) v_j / max(l, 1e-30), l = sum_j
//             exp(s_j - m), m the running max; exact zeros for a sample of
//             length 0; lse = m + log(max(l, 1e-30)) when asked;
//   backward: p = exp(s - lse), dp = dO . v, ds = p (dp - delta);
//             dq = sum_k ds k / sqrt(D), dk = sum_q ds q / sqrt(D),
//             dv = sum_q p dO.
// The Pallas kernels pad D to 128 lanes and T to the block; here every
// kernel indexes [B, T, H, D] in place, with bounds checks, any D <= 128.
//
// For bf16 inputs every entry runs the Hopper kernels of
// flash_attention_sm90.cu (wgmma, TMA): the kernels below serve float32
// only (and dq_finish casts the bf16 fused backward's dq). They stay on the
// CUDA cores, since no tensor-core type meets the float32 limit.
//
// Bound on the H100: operations. At T = 1024 a forward does 4 B H T^2 D
// multiply-adds' worth of FLOPs on 2 B T H D inputs, far above the card's
// ~295 FLOP/byte ridge in bf16. These kernels keep the design simple:
// float32 FMA on the CUDA cores (no tensor cores yet), 64 x 64 tiles in
// shared memory, each of 256 threads owning a 4 x 4 patch of the score tile
// (rows ty + 16 i, columns tx + 16 j) and the matching patch of the output
// (columns tx + 16 j of D), so each shared load feeds two FMAs. Rows of a
// score tile are reduced across their 16 lanes with warp shuffles. Tiles of
// keys wholly at or past the length are skipped: each masked term is
// exp(-1e30 - m) = 0 once a valid key has set m, so skipping is exact.
// The fused backward runs one block per (b h, k tile), keeps dk and dv in
// registers and adds dq into a float32 workspace with atomicAdd (so dq is
// reproducible only to rounding); a second, elementwise launch scales it
// and casts it to the activation type. No fast-math: expf and logf are the
// accurate versions and division is IEEE.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention_sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kTile = 64;         // rows of a q tile and of a k/v tile
constexpr int kThreads = 256;     // 16 x 16
constexpr int kSub = kTile / 16;  // rows (and columns) of a thread's patch
constexpr int kLdP = kTile + 1;   // padded row of a [64, 64] score tile

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch and JAX
}

// Rows [t0, t0 + 64) of one head (row t at x[t * row_stride]) -> float32
// tile [64, ld], zero past T.
__device__ void load_tile(float* tile, int ld, const float* __restrict__ x,
                          size_t row_stride, int t0, int Tn, int D) {
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    const int t = t0 + r;
    tile[r * ld + d] = t < Tn ? x[(size_t)t * row_stride + d] : 0.0f;
  }
}

// Reductions over the 16 lanes that hold one row of a score tile.
__device__ __forceinline__ float row_max(float x) {
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// s[i][j] = sum_d a[ty + 16 i][d] * b[tx + 16 j][d] over [64, ld] tiles.
__device__ __forceinline__ void tile_dot(float (&s)[kSub][kSub],
                                         const float* a, const float* b,
                                         int ld, int D, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int j = 0; j < kSub; ++j) s[i][j] = 0.0f;
  for (int d = 0; d < D; ++d) {
    float av[kSub], bv[kSub];
#pragma unroll
    for (int i = 0; i < kSub; ++i) av[i] = a[(ty + 16 * i) * ld + d];
#pragma unroll
    for (int j = 0; j < kSub; ++j) bv[j] = b[(tx + 16 * j) * ld + d];
#pragma unroll
    for (int i = 0; i < kSub; ++i)
#pragma unroll
      for (int j = 0; j < kSub; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// One block per (q tile, b h).
template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
                 const int32_t* __restrict__ lengths,
                 float* __restrict__ out, float* __restrict__ lse, int Tn,
                 int H, int D, float scale) {
  constexpr int kCols = DMAX / 16;
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* Qs = smem;
  float* Ks = Qs + kTile * ld;
  float* Vs = Ks + kTile * ld;
  float* Ps = Vs + kTile * ld;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kTile;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const int len = min(max(lengths[b], 0), Tn);
  const size_t rs = (size_t)H * D;
  const size_t base = ((size_t)b * Tn * H + h) * D;

  load_tile(Qs, ld, q + base, rs, q0, Tn, D);
  float m[kSub], l[kSub], acc[kSub][kCols];
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }

  const int nk = (len + kTile - 1) / kTile;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's Ks, Vs and Ps are consumed
    load_tile(Ks, ld, k + base, rs, k0, Tn, D);
    load_tile(Vs, ld, v + base, rs, k0, Tn, D);
    __syncthreads();
    float s[kSub][kSub];
    tile_dot(s, Qs, Ks, ld, D, ty, tx);
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        s[i][j] = (k0 + tx + 16 * j < len) ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float ps = 0.0f;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * kLdP + tx + 16 * j] = p;
        ps += p;
      }
      l[i] = l[i] * corr + row_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
    }
    __syncthreads();
    for (int c = 0; c < kTile; ++c) {
      float vv[kCols];
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) {
        const int d = tx + 16 * cc;
        vv[cc] = d < D ? Vs[c * ld + d] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        const float p = Ps[(ty + 16 * i) * kLdP + c];
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc)
          acc[i][cc] = fmaf(p, vv[cc], acc[i][cc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= Tn) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* orow = out + base + (size_t)t * rs;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) {
      const int d = tx + 16 * cc;
      if (d < D) orow[d] = len > 0 ? acc[i][cc] / den : 0.0f;
    }
    if (lse != nullptr && tx == 0)
      lse[(size_t)bh * Tn + t] = m[i] + logf(den);
  }
}

// Backward, first of the two passes: one block per (q tile, b h), looping
// over the k tiles below the length.
template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const int32_t* __restrict__ lengths,
                    const float* __restrict__ dout,
                    const float* __restrict__ delta,
                    const float* __restrict__ lse, float* __restrict__ dq,
                    int Tn, int H, int D, float scale) {
  constexpr int kCols = DMAX / 16;
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* Qs = smem;
  float* Gs = Qs + kTile * ld;  // dO
  float* Ks = Gs + kTile * ld;
  float* Vs = Ks + kTile * ld;
  float* Ss = Vs + kTile * ld;  // ds
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kTile;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const int len = min(max(lengths[b], 0), Tn);
  const size_t rs = (size_t)H * D;
  const size_t base = ((size_t)b * Tn * H + h) * D;

  load_tile(Qs, ld, q + base, rs, q0, Tn, D);
  load_tile(Gs, ld, dout + base, rs, q0, Tn, D);
  float lse_r[kSub], del_r[kSub], acc[kSub][kCols];
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int t = q0 + ty + 16 * i;
    lse_r[i] = t < Tn ? lse[(size_t)bh * Tn + t] : 0.0f;
    del_r[i] = t < Tn ? delta[((size_t)b * Tn + t) * H + h] : 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }

  const int nk = (len + kTile - 1) / kTile;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile(Ks, ld, k + base, rs, k0, Tn, D);
    load_tile(Vs, ld, v + base, rs, k0, Tn, D);
    __syncthreads();
    float s[kSub][kSub], dp[kSub][kSub];
    tile_dot(s, Qs, Ks, ld, D, ty, tx);
    tile_dot(dp, Gs, Vs, ld, D, ty, tx);
#pragma unroll
    for (int i = 0; i < kSub; ++i)
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const float p = (k0 + tx + 16 * j < len)
                            ? expf(s[i][j] * scale - lse_r[i])
                            : 0.0f;
        Ss[(ty + 16 * i) * kLdP + tx + 16 * j] = p * (dp[i][j] - del_r[i]);
      }
    __syncthreads();
    for (int c = 0; c < kTile; ++c) {
      float kv[kCols];
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) {
        const int d = tx + 16 * cc;
        kv[cc] = d < D ? Ks[c * ld + d] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        const float ds = Ss[(ty + 16 * i) * kLdP + c];
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc)
          acc[i][cc] = fmaf(ds, kv[cc], acc[i][cc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= Tn) continue;
    float* row = dq + base + (size_t)t * rs;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) {
      const int d = tx + 16 * cc;
      if (d < D) row[d] = acc[i][cc] * scale;
    }
  }
}

// dk, dv (the second pass) and, with FUSED, dq added into a float32
// workspace [B, T, H, D]: one block per (k tile, b h), looping over every
// q tile (queries are not masked, only keys).
template <int DMAX, bool FUSED>
__global__ void __launch_bounds__(kThreads)
flash_bwd_kv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const int32_t* __restrict__ lengths,
                    const float* __restrict__ dout,
                    const float* __restrict__ delta,
                    const float* __restrict__ lse, float* __restrict__ dq_ws,
                    float* __restrict__ dk, float* __restrict__ dv, int Tn,
                    int H, int D, float scale) {
  constexpr int kCols = DMAX / 16;
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* Ks = smem;
  float* Vs = Ks + kTile * ld;
  float* Qs = Vs + kTile * ld;
  float* Gs = Qs + kTile * ld;  // dO
  float* Ps = Gs + kTile * ld;  // p
  float* Ss = Ps + kTile * kLdP;  // ds
  float* Ls = Ss + kTile * kLdP;  // lse of the q tile's rows
  float* Es = Ls + kTile;         // delta of the q tile's rows
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.x * kTile;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const int len = min(max(lengths[b], 0), Tn);
  const size_t rs = (size_t)H * D;
  const size_t base = ((size_t)b * Tn * H + h) * D;

  // dk and dv of key rows ty + 16 i, columns tx + 16 cc
  float gk[kSub][kCols], gv[kSub][kCols];
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) gk[i][c] = gv[i][c] = 0.0f;

  if (k0 < len) {  // a tile wholly past the length has p = 0 everywhere
    load_tile(Ks, ld, k + base, rs, k0, Tn, D);
    load_tile(Vs, ld, v + base, rs, k0, Tn, D);
    const int nq = (Tn + kTile - 1) / kTile;
    for (int qt = 0; qt < nq; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();
      load_tile(Qs, ld, q + base, rs, q0, Tn, D);
      load_tile(Gs, ld, dout + base, rs, q0, Tn, D);
      if (threadIdx.x < kTile) {
        const int t = q0 + threadIdx.x;
        Ls[threadIdx.x] = t < Tn ? lse[(size_t)bh * Tn + t] : 0.0f;
        Es[threadIdx.x] = t < Tn ? delta[((size_t)b * Tn + t) * H + h] : 0.0f;
      }
      __syncthreads();
      float s[kSub][kSub], dp[kSub][kSub];
      tile_dot(s, Qs, Ks, ld, D, ty, tx);  // rows: queries, columns: keys
      tile_dot(dp, Gs, Vs, ld, D, ty, tx);
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < kSub; ++j) {
          const bool ok = (k0 + tx + 16 * j < len) && (q0 + r < Tn);
          const float p = ok ? expf(s[i][j] * scale - Ls[r]) : 0.0f;
          Ps[r * kLdP + tx + 16 * j] = p;
          Ss[r * kLdP + tx + 16 * j] = p * (dp[i][j] - Es[r]);
        }
      }
      __syncthreads();
      // dv[c] += sum_r p[r][c] dO[r];  dk[c] += sum_r ds[r][c] q[r]
      for (int r = 0; r < kTile; ++r) {
        float qv[kCols], gov[kCols];
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) {
          const int d = tx + 16 * cc;
          qv[cc] = d < D ? Qs[r * ld + d] : 0.0f;
          gov[cc] = d < D ? Gs[r * ld + d] : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          const float p = Ps[r * kLdP + ty + 16 * i];
          const float ds = Ss[r * kLdP + ty + 16 * i];
#pragma unroll
          for (int cc = 0; cc < kCols; ++cc) {
            gv[i][cc] = fmaf(p, gov[cc], gv[i][cc]);
            gk[i][cc] = fmaf(ds, qv[cc], gk[i][cc]);
          }
        }
      }
      if (FUSED) {
        // this k tile's share of dq for the q tile's rows ty + 16 i
        float part[kSub][kCols];
#pragma unroll
        for (int i = 0; i < kSub; ++i)
#pragma unroll
          for (int cc = 0; cc < kCols; ++cc) part[i][cc] = 0.0f;
        for (int c = 0; c < kTile; ++c) {
          float kv[kCols];
#pragma unroll
          for (int cc = 0; cc < kCols; ++cc) {
            const int d = tx + 16 * cc;
            kv[cc] = d < D ? Ks[c * ld + d] : 0.0f;
          }
#pragma unroll
          for (int i = 0; i < kSub; ++i) {
            const float ds = Ss[(ty + 16 * i) * kLdP + c];
#pragma unroll
            for (int cc = 0; cc < kCols; ++cc)
              part[i][cc] = fmaf(ds, kv[cc], part[i][cc]);
          }
        }
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          const int t = q0 + ty + 16 * i;
          if (t >= Tn) continue;
          float* row = dq_ws + base + (size_t)t * rs;
#pragma unroll
          for (int cc = 0; cc < kCols; ++cc) {
            const int d = tx + 16 * cc;
            if (d < D) atomicAdd(row + d, part[i][cc]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int t = k0 + ty + 16 * i;
    if (t >= Tn) continue;
    float* krow = dk + base + (size_t)t * rs;
    float* vrow = dv + base + (size_t)t * rs;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) {
      const int d = tx + 16 * cc;
      if (d < D) {
        krow[d] = gk[i][cc] * scale;
        vrow[d] = gv[i][cc];
      }
    }
  }
}

// dq = workspace * scale, cast to the activation type.
template <typename T>
__global__ void flash_dq_finish_kernel(const float* __restrict__ ws,
                                       T* __restrict__ dq, size_t n,
                                       float scale) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    dq[i] = from_f32<T>(ws[i] * scale);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

inline size_t tile_bytes(int D) { return (size_t)kTile * (D + 1) * sizeof(float); }
inline size_t score_bytes() { return (size_t)kTile * kLdP * sizeof(float); }
inline dim3 grid_for(int B, int Tn, int H) {
  return dim3((Tn + kTile - 1) / kTile, B * H);
}

template <int DMAX>
int fwd(const void* q, const void* k, const void* v, const void* lengths,
        void* out, void* lse, int B, int Tn, int H, int D, float scale,
        cudaStream_t st) {
  const size_t smem = 3 * tile_bytes(D) + score_bytes();
  auto kern = flash_fwd_kernel<DMAX>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid_for(B, Tn, H), kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int32_t*>(lengths),
      static_cast<float*>(out), static_cast<float*>(lse), Tn, H, D, scale);
  return (int)cudaGetLastError();
}

template <int DMAX>
int bwd_dq(const void* q, const void* k, const void* v, const void* lengths,
           const void* dout, const void* delta, const void* lse, void* dq,
           int B, int Tn, int H, int D, float scale, cudaStream_t st) {
  const size_t smem = 4 * tile_bytes(D) + score_bytes();
  auto kern = flash_bwd_dq_kernel<DMAX>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid_for(B, Tn, H), kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int32_t*>(lengths),
      static_cast<const float*>(dout), static_cast<const float*>(delta),
      static_cast<const float*>(lse), static_cast<float*>(dq), Tn, H, D, scale);
  return (int)cudaGetLastError();
}

// dq = workspace * scale in the activation type, after the fused sweep.
template <typename T>
int dq_finish(const void* dq_ws, void* dq, size_t n, float scale,
              cudaStream_t st) {
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  flash_dq_finish_kernel<T><<<blocks, 256, 0, st>>>(
      static_cast<const float*>(dq_ws), static_cast<T*>(dq), n, scale);
  return (int)cudaGetLastError();
}

template <int DMAX, bool FUSED>
int bwd_kv(const void* q, const void* k, const void* v, const void* lengths,
           const void* dout, const void* delta, const void* lse, void* dq_ws,
           void* dq, void* dk, void* dv, int B, int Tn, int H, int D,
           float scale, cudaStream_t st) {
  const size_t smem =
      4 * tile_bytes(D) + 2 * score_bytes() + 2 * kTile * sizeof(float);
  auto kern = flash_bwd_kv_kernel<DMAX, FUSED>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid_for(B, Tn, H), kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int32_t*>(lengths),
      static_cast<const float*>(dout), static_cast<const float*>(delta),
      static_cast<const float*>(lse), static_cast<float*>(dq_ws),
      static_cast<float*>(dk), static_cast<float*>(dv), Tn, H, D, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || !FUSED) return (int)e;
  return dq_finish<float>(dq_ws, dq, (size_t)B * Tn * H * D, scale, st);
}

constexpr int kMaxD = 128;

}  // namespace

// The kernels take D <= 128 (the path's D is 64); bf16 != 0 selects bf16
// inputs and outputs, else float32. scale = 1 / sqrt(D) as a float (of the
// head dim before any padding). The bf16 kernels need D % 8 == 0 and
// 16-byte aligned bases (flash_attention_sm90.cuh).

// q, k, v [B, T, H, D], lengths [B] -> out [B, T, H, D] and, when lse is
// not null, lse [B, H, T] float32.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* lengths, void* out, void* lse, int B,
                         int T, int H, int D, int bf16, float scale,
                         void* stream) {
  cudaGetLastError();
  if (B == 0 || T == 0 || H == 0) return 0;
  if (D < 1 || D > kMaxD) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return flash_fwd_bf16_sm90(q, k, v, lengths, out, lse, B, T, H, D, scale,
                               st);
  return D <= 64 ? fwd<64>(q, k, v, lengths, out, lse, B, T, H, D, scale, st)
                 : fwd<128>(q, k, v, lengths, out, lse, B, T, H, D, scale, st);
}

// The forward's inputs, dO [B, T, H, D], delta [B, T, H] and lse [B, H, T]
// float32 -> dq [B, T, H, D].
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* lengths, const void* dout,
                            const void* delta, const void* lse, void* dq,
                            int B, int T, int H, int D, int bf16, float scale,
                            void* stream) {
  cudaGetLastError();
  if (B == 0 || T == 0 || H == 0) return 0;
  if (D < 1 || D > kMaxD) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return flash_bwd_dq_bf16_sm90(q, k, v, lengths, dout, delta, lse, dq, B,
                                  T, H, D, scale, st);
  return D <= 64 ? bwd_dq<64>(q, k, v, lengths, dout, delta, lse, dq, B, T,
                              H, D, scale, st)
                 : bwd_dq<128>(q, k, v, lengths, dout, delta, lse, dq, B, T,
                               H, D, scale, st);
}

// As flash_bwd_dq -> dk, dv [B, T, H, D].
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* lengths, const void* dout,
                             const void* delta, const void* lse, void* dk,
                             void* dv, int B, int T, int H, int D, int bf16,
                             float scale, void* stream) {
  cudaGetLastError();
  if (B == 0 || T == 0 || H == 0) return 0;
  if (D < 1 || D > kMaxD) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return flash_bwd_dkv_bf16_sm90(q, k, v, lengths, dout, delta, lse, dk, dv,
                                   B, T, H, D, scale, st);
  return D <= 64 ? bwd_kv<64, false>(q, k, v, lengths, dout, delta, lse,
                                     nullptr, nullptr, dk, dv, B, T, H, D,
                                     scale, st)
                 : bwd_kv<128, false>(q, k, v, lengths, dout, delta, lse,
                                      nullptr, nullptr, dk, dv, B, T, H, D,
                                      scale, st);
}

// As flash_bwd_dq, with dq_ws a zeroed float32 [B, T, H, D] workspace ->
// dq, dk, dv [B, T, H, D] in one sweep over the k tiles (then one
// elementwise launch that scales and casts dq).
extern "C" int flash_bwd_fused(const void* q, const void* k, const void* v,
                               const void* lengths, const void* dout,
                               const void* delta, const void* lse,
                               void* dq_ws, void* dq, void* dk, void* dv,
                               int B, int T, int H, int D, int bf16,
                               float scale, void* stream) {
  cudaGetLastError();
  if (B == 0 || T == 0 || H == 0) return 0;
  if (D < 1 || D > kMaxD) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    const int e = flash_bwd_fused_bf16_sm90(q, k, v, lengths, dout, delta,
                                            lse, dq_ws, dk, dv, B, T, H, D,
                                            scale, st);
    if (e != 0) return e;
    return dq_finish<__nv_bfloat16>(dq_ws, dq, (size_t)B * T * H * D, scale,
                                    st);
  }
  return D <= 64 ? bwd_kv<64, true>(q, k, v, lengths, dout, delta, lse,
                                    dq_ws, dq, dk, dv, B, T, H, D, scale, st)
                 : bwd_kv<128, true>(q, k, v, lengths, dout, delta, lse,
                                     dq_ws, dq, dk, dv, B, T, H, D, scale,
                                     st);
}
