// Hopper (sm_90a) kernels for the bf16 flash-attention forward and fused
// backward: wgmma on the tensor cores for every product, TMA loads into a
// ring of shared-memory tiles with mbarriers, one producer warp.
//
// Replaces, for bf16 inputs, the Pallas kernels of
// lipreading_tpu/ops/flash_attention.py:
//   forward         <- `_flash_kernel` (:74, via `_flash_fwd_impl`)
//   fused backward  <- `_bwd_fused_kernel` (:326, via `_flash_bwd_fused_impl`)
// flash_attention.cu's C entries `flash_fwd` and `flash_bwd_fused` call
// these for bf16; the float32 instances stay on the CUDA cores there, since
// no tensor-core type meets the float32 limit (TF32 keeps ~3 digits).
//
// The function is the JAX kernels' (see flash_attention.cu's header):
// s = (q . k) / sqrt(Dh) in float32, keys at or past the length at -1e30,
// P = exp(s - m) and dS = P (dP - delta) in FLOAT32. On the tensor cores:
// q.k and dO.v take bf16 operands, whose products are exact in the float32
// accumulator. P.V, P^T.dO, dS^T.Q and dS.K have a float32 left operand:
// it is split into hi = bf16(x) and lo = bf16(x - hi), and both go through
// the tensor cores into one float32 accumulator. That keeps ~16 bits of P
// and dS (a single bf16 rounding would be another function), for 1.5x the
// forward's tensor-core work and 8/5 of the backward's.
//
// Bound on the H100: operations (at T 1024 a forward does ~4 B H T^2 Dh
// FLOPs on 4 B T H Dh 2-byte values, far above the bf16 ridge of ~295
// FLOP/byte).
//
// Layout. q, k, v, dO, out, dk, dv are [B, T, H, D] bf16 with D % 8 == 0
// and 16-byte aligned bases (the wrapper pads D otherwise), read through
// 4-D TMA maps with dims (D, H, T, B) and box (64, 1, 64, 1): 64 rows of
// 64 columns, one 128-byte row each, 128-byte swizzled, the pattern the
// wgmma descriptors name. A head dim up to 64 takes one box per tile, up to
// 128 two ("halves"); TMA fills columns past D and rows past T with zeros.
//
// Blocks: 2 consumer warpgroups (64 rows each) and a producer: one warp
// in the forward, a warpgroup in the backward (see kBwdThreads).
//   forward: one block per (128-query tile, b h). The producer loads the Q
//     tile once, then K/V tiles of 64 keys below the length into a 3-stage
//     ring. Each consumer: S = Q K^T (shared x shared), the online softmax
//     on the accumulator fragment in registers, O += P V with P's hi and lo
//     halves as register A operands (V is N-major: transposed B).
//   fused backward: one block per (128-key tile, b h), skipped past the
//     length; each warpgroup keeps dK, dV of its 64 keys in registers over
//     every 64-query tile (Q, dO, lse, delta in a 4-stage ring):
//     S^T = K Q^T, P^T, dV += P^T dO (split), dP^T = V dO^T,
//     dS^T = P^T (dP^T - delta), dK += dS^T Q (split); dS^T's hi and lo go
//     to shared memory, and one warpgroup in turn (by the q tile's parity)
//     forms dQ = dS K over the block's 128 keys and adds it into the
//     float32 workspace with float4 atomics. At Dh 128 a block takes 64
//     keys and its warpgroups split the columns instead (BwdSplit).
// Every mbarrier wait traps after ~2^26 polls, so a phase error fails the
// launch instead of hanging the card.

#include "flash_attention_sm90.cuh"

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kRows = 64;                  // rows of a box and of a wgmma
constexpr int kBoxBytes = kRows * 64 * 2;  // one [64, 64] bf16 box
constexpr int kConsumers = 2;              // warpgroups
// forward: the consumers and one producer warp
constexpr int kThreads = kConsumers * 128 + 32;
// backward: a producer warpgroup first (one warp of it loads), so that
// setmaxnreg can move registers from it to the consumers. ptxas allots
// registers for whole warpgroups: under __launch_bounds__(384, 1) the
// kernel is built for 168 a thread (65,536 / 384, in steps of 8), which
// the forward fits in. The backward's consumers need ~190 (ptxas, -Xptxas
// -v), so its producer drops to 56 and its consumers rise to 224:
// 128 x (168 - 56) = 256 x (224 - 168), the pool balances exactly.
constexpr int kBwdThreads = (1 + kConsumers) * 128;
constexpr int kBwdRegs = 168;
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;
static_assert(128 * (kBwdRegs - kProducerRegs) >=
                  kConsumers * 128 * (kConsumerRegs - kBwdRegs),
              "setmaxnreg would wait for registers that are never freed");
constexpr int kFwdStages = 3;
constexpr int kBwdStages = 4;
// wgmma shared-memory descriptor fields, in 16-byte units: a 128-byte
// swizzled tile steps 1024 bytes per 8 rows (SBO); an N-major (transposed)
// operand of two 64-column halves steps one box between them (LBO); a
// K-major operand's LBO is unused with this swizzle (1, as CUTLASS sets it)
constexpr uint32_t kSbo = 1024 >> 4;
constexpr uint32_t kLboHalf = kBoxBytes >> 4;
constexpr uint32_t kLboK = 1;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers and TMA ------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Add bytes to the transactions the current phase waits for, without an
// arrival.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// Wait for the phase of parity ``parity`` to complete.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  for (uint32_t n = 0; !mbar_try(a, parity); ++n)
    if (n == (1u << 26)) __trap();
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// --- wgmma ------------------------------------------------------------------

// Descriptor of a 128-byte swizzled operand tile starting at p (whose
// swizzle atom is 1024-byte aligned; p may sit 32 bytes per k step in).
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)lbo << 16) |
         ((uint64_t)kSbo << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// m64nNk16, float32 += bf16 x bf16. ss: A and B from shared memory (TA, TB
// set: that operand is N- or M-major); rs: A from registers, 4 x bf16x2.
template <int TA, int TB>
__device__ __forceinline__ void mma_ss64(float (&d)[32], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void mma_rs64(float (&d)[32],
                                          const uint32_t (&a)[4], uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void mma_ss128(float (&d)[64], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void mma_rs128(float (&d)[64],
                                          const uint32_t (&a)[4], uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}


template <int N, int TA, int TB>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da,
                                       uint64_t db, int scale_d) {
  if constexpr (N == 64)
    mma_ss64<TA, TB>(d, da, db, scale_d);
  else
    mma_ss128<TA, TB>(d, da, db, scale_d);
}

template <int N, int TB>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t db,
                                       int scale_d) {
  if constexpr (N == 64)
    mma_rs64<TB>(d, a, db, scale_d);
  else
    mma_rs128<TB>(d, a, db, scale_d);
}

// --- fragments --------------------------------------------------------------
// A warpgroup's m64nN float32 accumulator: thread t (warp w = t / 32, lane
// l) holds d[i] at row 16 w + l / 4 (+ 8 when (i / 2) is odd) and column
// 8 (i / 4) + 2 (l % 4) + i % 2. The register A operand of k step kk
// (columns 16 kk .. 16 kk + 15) is then d[8 kk .. 8 kk + 7] in pairs.

__device__ __forceinline__ int frag_col(int i, int lane) {
  return 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// x (a [64, 64] accumulator fragment) -> its hi and lo bf16 halves as
// register A operands of 4 k steps.
__device__ __forceinline__ void split_bf16(const float (&x)[32],
                                           uint32_t (&hi)[4][4],
                                           uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float a = x[8 * kk + 2 * j], b = x[8 * kk + 2 * j + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      hi[kk][j] = bf16x2_bits(h);
      lo[kk][j] = bf16x2_bits(__floats2bfloat162_rn(
          a - __low2float(h), b - __high2float(h)));
    }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// --- forward ----------------------------------------------------------------

template <int DP>
struct FwdSmem {
  static constexpr int NH = DP / 64;
  static constexpr int q = 0;                                  // [2][NH] boxes
  static constexpr int k = q + kConsumers * NH * kBoxBytes;    // [stages][NH]
  static constexpr int v = k + kFwdStages * NH * kBoxBytes;    // [stages][NH]
  static constexpr int bars = v + kFwdStages * NH * kBoxBytes;
  static constexpr int bytes = bars + (1 + 2 * kFwdStages) * 8 + 1024;
};

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
fwd_kernel(const __grid_constant__ CUtensorMap mq,
           const __grid_constant__ CUtensorMap mk,
           const __grid_constant__ CUtensorMap mv,
           const int32_t* __restrict__ lengths, __nv_bfloat16* __restrict__ out,
           float* __restrict__ lse, int Tn, int H, int D, float scale) {
  using L = FwdSmem<DP>;
  constexpr int NH = L::NH;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::bars);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + kFwdStages;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * (kConsumers * kRows);
  const int len = min(max(lengths[b], 0), Tn);
  const int nk = (len + kRows - 1) / kRows;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers * 128) {  // the producer warp
    if (threadIdx.x == kConsumers * 128 && nk > 0) {
      mbar_arrive_tx(q_full, kConsumers * NH * kBoxBytes);
      for (int w = 0; w < kConsumers; ++w)
        for (int hh = 0; hh < NH; ++hh)
          tma_load(sm + L::q + (w * NH + hh) * kBoxBytes, &mq, q_full,
                   64 * hh, h, q0 + kRows * w, b);
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kFwdStages;
        mbar_wait(&empty[s], ((kt / kFwdStages) & 1) ^ 1);
        mbar_arrive_tx(&full[s], 2 * NH * kBoxBytes);
        for (int hh = 0; hh < NH; ++hh) {
          tma_load(sm + L::k + (s * NH + hh) * kBoxBytes, &mk, &full[s],
                   64 * hh, h, kRows * kt, b);
          tma_load(sm + L::v + (s * NH + hh) * kBoxBytes, &mv, &full[s],
                   64 * hh, h, kRows * kt, b);
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const int r0 = 16 * ((threadIdx.x % 128) / 32) + lane / 4;
  const uint8_t* sQ = sm + L::q + wg * NH * kBoxBytes;
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.0f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;

  if (nk > 0) mbar_wait(q_full, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kFwdStages;
    mbar_wait(&full[s], (kt / kFwdStages) & 1);
    const uint8_t* sK = sm + L::k + s * NH * kBoxBytes;
    const uint8_t* sV = sm + L::v + s * NH * kBoxBytes;

    float sc[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
      mma_ss<64, 0, 0>(sc, desc(sQ + off, kLboK), desc(sK + off, kLboK),
                       kk > 0);
    }
    wg_commit();
    wg_wait();
    fence_regs(sc);

    // online softmax over this tile's 64 keys, rows r0 and r0 + 8
    const int k0 = kRows * kt;
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float x = (k0 + frag_col(i, lane) < len) ? sc[i] * scale : kNegInf;
      sc[i] = x;
      if ((i / 2) % 2) mx1 = fmaxf(mx1, x); else mx0 = fmaxf(mx0, x);
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
    float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = expf(sc[i] - ((i / 2) % 2 ? mn1 : mn0));
      sc[i] = p;
      if ((i / 2) % 2) ps1 += p; else ps0 += p;
    }
    l0 = l0 * c0 + quad_sum(ps0);
    l1 = l1 * c1 + quad_sum(ps1);
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] *= (i / 2) % 2 ? c1 : c0;

    // O += P V, P as hi + lo
    uint32_t ph[4][4], pl[4][4];
    split_bf16(sc, ph, pl);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = desc(sV + kk * 16 * 128, kLboHalf);
      mma_rs<DP, 1>(o, ph[kk], dv, 1);
      mma_rs<DP, 1>(o, pl[kk], dv, 1);
    }
    wg_commit();
    wg_wait();
    fence_regs(o);
    mbar_arrive(&empty[s]);
  }

  const size_t rs = (size_t)H * D;
  const size_t base = ((size_t)b * Tn * H + h) * D;
  const int t0 = q0 + kRows * wg + r0;
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int i = 0; i < DP / 2; i += 2) {
    const int t = t0 + ((i / 2) % 2) * 8;
    const int d = frag_col(i, lane);
    if (t < Tn && d < D) {
      const float den = (i / 2) % 2 ? den1 : den0;
      const float a = len > 0 ? o[i] / den : 0.0f;
      const float c = len > 0 ? o[i + 1] / den : 0.0f;
      *reinterpret_cast<__nv_bfloat162*>(out + base + (size_t)t * rs + d) =
          __floats2bfloat162_rn(a, c);
    }
  }
  if (lse != nullptr && lane % 4 == 0) {
    if (t0 < Tn) lse[(size_t)bh * Tn + t0] = m0 + logf(den0);
    if (t0 + 8 < Tn) lse[(size_t)bh * Tn + t0 + 8] = m1 + logf(den1);
  }
}

// --- fused backward ---------------------------------------------------------

// The backward's split of work. Up to Dh 64 each warpgroup owns a tile of
// 64 keys, all columns of its dK and dV, and in turn dQ over both tiles.
// At Dh 128 their accumulators would not fit, so both warpgroups take the
// same 64 keys (forming S and dP twice) and split the columns of dK, dV
// and dQ between them, 64 each.
template <int DP>
struct BwdSplit {
  static constexpr bool cols = DP > 64;           // split the columns
  static constexpr int tiles = cols ? 1 : kConsumers;  // key tiles a block
  static constexpr int n = cols ? 64 : DP;        // columns a warpgroup owns
};

template <int DP>
struct BwdSmem {
  static constexpr int NH = DP / 64;
  static constexpr int tiles = BwdSplit<DP>::tiles;
  static constexpr int k = 0;                               // [tiles][NH]
  static constexpr int v = k + tiles * NH * kBoxBytes;      // [tiles][NH]
  static constexpr int q = v + tiles * NH * kBoxBytes;      // [stages][NH]
  static constexpr int g = q + kBwdStages * NH * kBoxBytes; // dO, the same
  // dS^T hi and lo: [q tile parity][key tile][hi, lo] boxes
  static constexpr int ds = g + kBwdStages * NH * kBoxBytes;
  static constexpr int lse = ds + 2 * tiles * 2 * kBoxBytes;
  static constexpr int delta = lse + kBwdStages * kRows * 4;  // [stages][64]
  static constexpr int bars = delta + kBwdStages * kRows * 4;
  static constexpr int bytes = bars + (1 + 2 * kBwdStages) * 8 + 1024;
};

// Byte offset of (row, col) in a [64, 64] bf16 tile written with the
// 128-byte swizzle (16-byte chunk index XOR row % 8), as TMA writes one.
__device__ __forceinline__ int swizzled(int row, int col) {
  return row * 128 + (((col >> 3) ^ (row & 7)) << 4) + (col & 7) * 2;
}

template <int DP>
__global__ void __launch_bounds__(kBwdThreads, 1)
bwd_kernel(const __grid_constant__ CUtensorMap mq,
           const __grid_constant__ CUtensorMap mk,
           const __grid_constant__ CUtensorMap mv,
           const __grid_constant__ CUtensorMap mg,
           const int32_t* __restrict__ lengths,
           const float* __restrict__ delta, const float* __restrict__ lse,
           float* __restrict__ dq_ws, __nv_bfloat16* __restrict__ dk,
           __nv_bfloat16* __restrict__ dv, int Tn, int H, int D,
           float scale) {
  using L = BwdSmem<DP>;
  using W = BwdSplit<DP>;
  constexpr int NH = L::NH;
  constexpr int NW = W::n;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::bars);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + kBwdStages;
  float* sL = reinterpret_cast<float*>(sm + L::lse);
  float* sE = reinterpret_cast<float*>(sm + L::delta);
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.x * (W::tiles * kRows);
  const int len = min(max(lengths[b], 0), Tn);
  // queries are not masked, only keys: a tile wholly past the length has
  // P = 0 everywhere and only writes zeros
  const int nq = k0 < len ? (Tn + kRows - 1) / kRows : 0;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // one big if / else: setmaxnreg holds only where the two roles never
  // meet again
  if (threadIdx.x < 128) {  // the producer warpgroup; warp 0 loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (nq > 0 && lane == 0) {
        mbar_arrive_tx(kv_full, 2 * W::tiles * NH * kBoxBytes);
        for (int w = 0; w < W::tiles; ++w)
          for (int hh = 0; hh < NH; ++hh) {
            tma_load(sm + L::k + (w * NH + hh) * kBoxBytes, &mk, kv_full,
                     64 * hh, h, k0 + kRows * w, b);
            tma_load(sm + L::v + (w * NH + hh) * kBoxBytes, &mv, kv_full,
                     64 * hh, h, k0 + kRows * w, b);
          }
      }
      for (int qt = 0; qt < nq; ++qt) {
        const int s = qt % kBwdStages;
        // this tile's lse and delta (rows lane, lane + 32), read before the
        // stage is free so that their latency hides behind the wait
        float lv[2], ev[2];
        for (int j = 0; j < 2; ++j) {
          const int t = kRows * qt + lane + 32 * j;
          lv[j] = t < Tn ? lse[(size_t)bh * Tn + t] : 0.0f;
          ev[j] = t < Tn ? delta[((size_t)b * Tn + t) * H + h] : 0.0f;
        }
        mbar_wait(&empty[s], ((qt / kBwdStages) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(&full[s], 2 * NH * kBoxBytes);
          for (int hh = 0; hh < NH; ++hh) {
            tma_load(sm + L::q + (s * NH + hh) * kBoxBytes, &mq, &full[s],
                     64 * hh, h, kRows * qt, b);
            tma_load(sm + L::g + (s * NH + hh) * kBoxBytes, &mg, &full[s],
                     64 * hh, h, kRows * qt, b);
          }
        }
        for (int j = 0; j < 2; ++j) {
          sL[s * kRows + lane + 32 * j] = lv[j];
          sE[s * kRows + lane + 32 * j] = ev[j];
        }
        mbar_arrive(&full[s]);  // 32 arrivals and the tile's bytes
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int wg = threadIdx.x / 128 - 1;
    const int lane = threadIdx.x % 32;
    const int r0 = 16 * ((threadIdx.x % 128) / 32) + lane / 4;
    const int tile = W::cols ? 0 : wg;    // this warpgroup's key tile
    const int half = W::cols ? wg : 0;    // its box of columns (of dK, dV, dQ)
    const uint8_t* sK = sm + L::k + tile * NH * kBoxBytes;
    const uint8_t* sV = sm + L::v + tile * NH * kBoxBytes;
    const int key0 = k0 + kRows * tile + r0;  // this thread's keys: +0, +8
    const size_t rs = (size_t)H * D;
    const size_t base = ((size_t)b * Tn * H + h) * D;
    float gk[NW / 2], gv[NW / 2];
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) gk[i] = gv[i] = 0.0f;

    if (nq > 0) mbar_wait(kv_full, 0);
    for (int qt = 0; qt < nq; ++qt) {
      const int s = qt % kBwdStages;
      mbar_wait(&full[s], (qt / kBwdStages) & 1);
      const uint8_t* sQ = sm + L::q + s * NH * kBoxBytes;
      const uint8_t* sG = sm + L::g + s * NH * kBoxBytes;
      const float* lse_t = sL + s * kRows;
      const float* del_t = sE + s * kRows;
      const int q0 = kRows * qt;

      // S^T = K Q^T: rows keys, columns queries
      float st[32];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
        mma_ss<64, 0, 0>(st, desc(sK + off, kLboK), desc(sQ + off, kLboK),
                         kk > 0);
      }
      wg_commit();
      wg_wait();
      fence_regs(st);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = frag_col(i, lane);
        const bool ok = key0 + ((i / 2) % 2) * 8 < len && q0 + c < Tn;
        st[i] = ok ? expf(st[i] * scale - lse_t[c]) : 0.0f;  // P^T
      }

      // dV += P^T dO, P^T as hi + lo; dO is N-major here
      uint32_t ah[4][4], al[4][4];
      split_bf16(st, ah, al);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db =
            desc(sG + half * kBoxBytes + kk * 16 * 128, kLboHalf);
        mma_rs<NW, 1>(gv, ah[kk], db, 1);
        mma_rs<NW, 1>(gv, al[kk], db, 1);
      }
      wg_commit();
      wg_wait();
      fence_regs(gv);

      // dP^T = V dO^T, then dS^T = P^T (dP^T - delta)
      float dp[32];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
        mma_ss<64, 0, 0>(dp, desc(sV + off, kLboK), desc(sG + off, kLboK),
                         kk > 0);
      }
      wg_commit();
      wg_wait();
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        dp[i] = st[i] * (dp[i] - del_t[frag_col(i, lane)]);

      // dK += dS^T Q (hi + lo; Q N-major), and dS^T's halves to shared memory
      split_bf16(dp, ah, al);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db =
            desc(sQ + half * kBoxBytes + kk * 16 * 128, kLboHalf);
        mma_rs<NW, 1>(gk, ah[kk], db, 1);
        mma_rs<NW, 1>(gk, al[kk], db, 1);
      }
      wg_commit();
      // (with split columns both warpgroups hold the same dS^T: one writes)
      if (!W::cols || wg == 0) {
        uint8_t* ds =
            sm + L::ds + ((qt & 1) * W::tiles + tile) * 2 * kBoxBytes;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int off = swizzled(r0 + 8 * (j % 2),
                                     16 * kk + 8 * (j / 2) + 2 * (lane % 4));
            *reinterpret_cast<uint32_t*>(ds + off) = ah[kk][j];
            *reinterpret_cast<uint32_t*>(ds + kBoxBytes + off) = al[kk][j];
          }
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      }
      wg_wait();
      fence_regs(gk);
      mbar_arrive(&empty[s]);  // Q and dO of this stage are consumed
      // the block's dS^T is in shared memory; the buffer of this parity is
      // written again two tiles on, after the next barrier, which a
      // warpgroup reading it now reaches only when its dQ is done
      asm volatile("bar.sync 1, %0;" ::"n"(kConsumers * 128) : "memory");

      if (W::cols || (qt & 1) == wg) {
        // dQ (this q tile, the block's keys, this warpgroup's columns) =
        // dS K: dS M-major, K N-major
        float dq[NW / 2];
#pragma unroll
        for (int i = 0; i < NW / 2; ++i) dq[i] = 0.0f;
        wg_fence();
#pragma unroll
        for (int w = 0; w < W::tiles; ++w)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint8_t* a =
                sm + L::ds + ((qt & 1) * W::tiles + w) * 2 * kBoxBytes +
                kk * 16 * 128;
            const uint64_t db = desc(sm + L::k + (w * NH + half) * kBoxBytes +
                                         kk * 16 * 128,
                                     kLboHalf);
            mma_ss<NW, 1, 1>(dq, desc(a, kLboHalf), db, 1);
            mma_ss<NW, 1, 1>(dq, desc(a + kBoxBytes, kLboHalf), db, 1);
          }
        wg_commit();
        wg_wait();
        fence_regs(dq);
        // float4 atomics: lanes 2m and 2m + 1 hold columns c, c + 1 and
        // c + 2, c + 3 of rows r0 and r0 + 8; one swap of pairs gives the
        // even lane row r0 and the odd lane row r0 + 8, 4 columns each
        const bool odd = lane & 1;
        const int t = q0 + r0 + (odd ? 8 : 0);
#pragma unroll
        for (int i = 0; i < NW / 2; i += 4) {
          const float x0 = odd ? dq[i] : dq[i + 2];
          const float x1 = odd ? dq[i + 1] : dq[i + 3];
          const float y0 = __shfl_xor_sync(0xffffffffu, x0, 1);
          const float y1 = __shfl_xor_sync(0xffffffffu, x1, 1);
          const int d = 64 * half + 8 * (i / 4) + 4 * ((lane % 4) / 2);
          if (t < Tn && d < D)  // D % 8 == 0: all 4 columns
            atomicAdd(reinterpret_cast<float4*>(dq_ws + base +
                                                (size_t)t * rs + d),
                      odd ? make_float4(y0, y1, dq[i + 2], dq[i + 3])
                          : make_float4(dq[i], dq[i + 1], y0, y1));
        }
      }
    }

#pragma unroll
    for (int i = 0; i < NW / 2; i += 2) {
      const int t = key0 + ((i / 2) % 2) * 8;
      const int d = 64 * half + frag_col(i, lane);
      if (t < Tn && d < D) {
        const size_t o = base + (size_t)t * rs + d;
        *reinterpret_cast<__nv_bfloat162*>(dk + o) =
            __floats2bfloat162_rn(gk[i] * scale, gk[i + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + o) =
            __floats2bfloat162_rn(gv[i], gv[i + 1]);
      }
    }
  }
}

// --- host -------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so the
// library needs no -lcuda.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &res) != cudaSuccess ||
        res != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The TMA map of a [B, T, H, D] bf16 tensor: dims (D, H, T, B), box
// (64, 1, 64, 1), 128-byte swizzle, zeros out of bounds.
bool make_map(CUtensorMap* map, const void* x, int B, int T, int H, int D) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)T * H * D * 2};
  const cuuint32_t box[4] = {64, 1, kRows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x),
             dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// TMA needs 16-byte strides (D % 8 == 0 in bf16) and 16-byte aligned bases.
bool tma_ok(int D, std::initializer_list<const void*> xs) {
  if (D % 8 != 0 || D < 8 || D > 128) return false;
  for (const void* x : xs)
    if (reinterpret_cast<uintptr_t>(x) % 16 != 0) return false;
  return true;
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int DP>
int fwd(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
        const void* lengths, void* out, void* lse, int B, int T, int H, int D,
        float scale, cudaStream_t st) {
  auto kern = fwd_kernel<DP>;
  cudaError_t e = allow_smem(kern, FwdSmem<DP>::bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((T + kConsumers * kRows - 1) / (kConsumers * kRows), B * H);
  kern<<<grid, kThreads, FwdSmem<DP>::bytes, st>>>(
      mq, mk, mv, static_cast<const int32_t*>(lengths),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), T, H, D,
      scale);
  return (int)cudaGetLastError();
}

template <int DP>
int bwd(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
        const CUtensorMap& mg, const void* lengths, const void* delta,
        const void* lse, void* dq_ws, void* dk, void* dv, int B, int T, int H,
        int D, float scale, cudaStream_t st) {
  auto kern = bwd_kernel<DP>;
  cudaError_t e = allow_smem(kern, BwdSmem<DP>::bytes);
  if (e != cudaSuccess) return (int)e;
  const int keys = BwdSplit<DP>::tiles * kRows;  // a block's keys
  const dim3 grid((T + keys - 1) / keys, B * H);
  kern<<<grid, kBwdThreads, BwdSmem<DP>::bytes, st>>>(
      mq, mk, mv, mg, static_cast<const int32_t*>(lengths),
      static_cast<const float*>(delta), static_cast<const float*>(lse),
      static_cast<float*>(dq_ws), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), T, H, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace

int flash_fwd_bf16_sm90(const void* q, const void* k, const void* v,
                        const void* lengths, void* out, void* lse, int B,
                        int T, int H, int D, float scale,
                        cudaStream_t stream) {
  if (!tma_ok(D, {q, k, v, out})) return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, B, T, H, D) || !make_map(&mk, k, B, T, H, D) ||
      !make_map(&mv, v, B, T, H, D))
    return (int)cudaErrorInvalidValue;
  return D <= 64 ? fwd<64>(mq, mk, mv, lengths, out, lse, B, T, H, D, scale,
                           stream)
                 : fwd<128>(mq, mk, mv, lengths, out, lse, B, T, H, D, scale,
                            stream);
}

int flash_bwd_fused_bf16_sm90(const void* q, const void* k, const void* v,
                              const void* lengths, const void* dout,
                              const void* delta, const void* lse, void* dq_ws,
                              void* dk, void* dv, int B, int T, int H, int D,
                              float scale, cudaStream_t stream) {
  if (!tma_ok(D, {q, k, v, dout, dk, dv})) return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mg;
  if (!make_map(&mq, q, B, T, H, D) || !make_map(&mk, k, B, T, H, D) ||
      !make_map(&mv, v, B, T, H, D) || !make_map(&mg, dout, B, T, H, D))
    return (int)cudaErrorInvalidValue;
  return D <= 64 ? bwd<64>(mq, mk, mv, mg, lengths, delta, lse, dq_ws, dk,
                           dv, B, T, H, D, scale, stream)
                 : bwd<128>(mq, mk, mv, mg, lengths, delta, lse, dq_ws, dk,
                            dv, B, T, H, D, scale, stream);
}
