// The data gradient of a stride-1 "SAME" 3D convolution in bf16 on Hopper
// (sm_90a): an implicit GEMM on the tensor cores (wgmma), float32 sums.
//
// Replaces no TPU kernel: the JAX package leaves its convolutions, and
// their gradients, to XLA (lipreading_tpu/models/nn.py `conv3d`). It was
// added because cuDNN takes a fallback for the data gradient of the conv3d
// stem's conv1 in bf16 (`dgrad2d_grouped_direct_kernel`, 3x5x5, 32 <- 64
// channels at 24x24): ~2.2 s a training step of B 64 x T 96 where the
// stem's two data gradients need ~1.4 ms on the tensor cores.
//
// The function (models/nn.py `conv3d_dgrad_plain` in plain PyTorch): with
// dY [B, T, H, W, Cout] the gradient of the convolution's output (stride 1
// and SAME padding keep T, H, W) and the weight flipped over its taps,
// transposed to wt [Cin][kT][kH][kW][Cout] (the wrapper does that),
//   dX[b, t, h, w, ci] = sum over taps j and co of
//       dY[b, t + jt - qT, h + jh - qH, w + jw - qW, co] wt[ci, j, co],
// dY read as 0 outside [0, T) x [0, H) x [0, W), q = k - 1 - (SAME's pad
// before). As a GEMM: M = B T H W positions, N = Cin, K = taps x Cout.
//
// Bound on the H100: operations. The stem's shapes do ~1e12 FLOPs on ~0.7
// GB (e.g. 3x5x5, 32 <- 64 channels at 24x24: 75 x 64 x 32 x 2 FLOPs a
// position for 128 bytes of dY and dX). What stands between a plain
// implicit GEMM and that bound is the re-reading of dY: gathered per tap,
// each element of dY would be read 75 times from L2 (34 GB at conv1's
// shape). So a block reads dY once per time tap and channel chunk:
//
//   * A block takes BM consecutive positions m0 .. m0 + BM - 1 (flattened
//     b, t, h, w) and every Cin column of its N tile (NT 32, 64, 128 or 256:
//     the smallest that holds Cin, more blocks along y past 256).
//   * For each time tap jt and 64-channel chunk of Cout ("group"), it loads
//     one slab of dY into shared memory: rows m0 + shift .. m0 + shift + SR
//     - 1 with SR = BM + (kH - 1) W + (kW - 1), which holds every row that
//     the group's kH x kW spatial taps read (a tap is a shift of the rows
//     by jh W + jw). Two slabs alternate.
//   * For each spatial tap ("step"), the A operand comes from the slab by
//     ldmatrix, each lane naming its row: a (position, tap) pair that falls
//     into the padding (or wraps past a row or frame edge in the flattened
//     order) names a zero row instead. So A is gathered from shared memory
//     (any row per lane), which wgmma's shared-memory operand cannot do,
//     and goes to the tensor cores from registers (wgmma's register A).
//   * B, the weight tile of the step ([NT][64] bf16, K-major, the 128-byte
//     swizzle), comes in by cp.async into a ring of kStages tiles, up to
//     kStages - 1 steps ahead; the slab of a group is loaded with the B
//     tile of its first step.
//   * Both warpgroups load and compute. Each holds MT m64 accumulators
//     (fp32) for its 64 MT rows over the NT columns, through every step;
//     the K reduction stays in registers, each dX element belongs to one
//     block and is stored once in bf16: no atomics, the same bytes from
//     launch to launch.
// Shared memory: kStages B tiles, one zero row, two slabs (110 KB at the
// stem's 24x24 3x5x5 shape: two blocks an SM). A slab row is 128 bytes
// (64 channels) with its 16-byte chunks XOR-swizzled by the row index, so
// ldmatrix of 8 consecutive rows hits 8 distinct bank groups.
// The C entry refuses (returns -1) a shape it was not built for: Cin or
// Cout not a multiple of 8 (the wrapper pads them), a q outside [0, k),
// more than 2^31 positions, or (-2) slabs past the shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // two warpgroups
constexpr int kStages = 4;      // ring of B tiles
constexpr int kRowBytes = 128;  // 64 bf16 channels
constexpr int kMaxSmem = 232448;

template <int NT>
struct Tile {
  static constexpr int MT = NT <= 64 ? 2 : 1;    // m64 tiles a warpgroup
  static constexpr int BM = 2 * MT * 64;         // positions a block
  static constexpr int BBytes = NT * kRowBytes;  // one B tile
  static constexpr int MinBlocks = NT <= 64 ? 2 : 1;
};

struct Shape {
  int T, H, W, Cin, Cout, kT, kH, kW, qT, qH, qW, M;
  int nch;    // 64-channel chunks of Cout
  int SR;     // rows of a slab
  int depth;  // steps a load runs ahead: min(kStages - 1, kH kW)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// 16 bytes global -> shared, zeros where ``ok`` is false (nothing read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most ``n`` (0, 1 or 2) committed groups are in flight
__device__ __forceinline__ void cp_wait(int n) {
  if (n >= 2)
    asm volatile("cp.async.wait_group 2;" ::: "memory");
  else if (n == 1)
    asm volatile("cp.async.wait_group 1;" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// the thread's cp.async writes, made visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// Descriptor of a K-major [rows][64] bf16 tile with the 128-byte swizzle
// (8-row atoms of 1024 bytes, SBO 1024; LBO unused), starting at p.
__device__ __forceinline__ uint64_t desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
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
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// m64nNk16, float32 += bf16 (registers, the m16n8k16 A layout a warp) x
// bf16 (shared memory, K-major)
__device__ __forceinline__ void mma_rs_n32(float (&d)[16],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void mma_rs_n64(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void mma_rs_n128(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void mma_rs_n256(float (&d)[128],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int NT>
__device__ __forceinline__ void mma_rs(float (&d)[NT / 2],
                                       const uint32_t (&a)[4], uint64_t db) {
  if constexpr (NT == 32)
    mma_rs_n32(d, a, db);
  else if constexpr (NT == 64)
    mma_rs_n64(d, a, db);
  else if constexpr (NT == 128)
    mma_rs_n128(d, a, db);
  else
    mma_rs_n256(d, a, db);
}

template <int NT>
__global__ void __launch_bounds__(kThreads, Tile<NT>::MinBlocks)
dgrad_kernel(const __nv_bfloat16* __restrict__ dy,
             const __nv_bfloat16* __restrict__ wt,
             __nv_bfloat16* __restrict__ dx, const Shape s) {
  using L = Tile<NT>;
  constexpr int MT = L::MT;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sB = align1024(smem_raw);              // [kStages][NT][128 B]
  uint8_t* sZero = sB + kStages * L::BBytes;      // one zero row
  uint8_t* sSlab = sZero + kRowBytes;             // [2][SR][128 B]
  const int slab_bytes = s.SR * kRowBytes;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * L::BM;
  const int n0 = blockIdx.y * NT;
  const int HW = s.H * s.W;
  const int nsteps = s.kT * s.nch * s.kH * s.kW;
  const long long K = (long long)s.kT * s.kH * s.kW * s.Cout;
  if (tid < kRowBytes / 16)
    reinterpret_cast<uint4*>(sZero)[tid] = make_uint4(0u, 0u, 0u, 0u);

  // the load cursor: step ls = group (ljt, lcc), spatial tap (ljh, ljw)
  int ls = 0, ljt = 0, lcc = 0, ljh = 0, ljw = 0;
  auto load_step = [&]() {
    if (ls < nsteps) {
      const int co0 = 64 * lcc;
      if (ljh == 0 && ljw == 0) {
        uint8_t* slab = sSlab + ((ljt * s.nch + lcc) & 1) * slab_bytes;
        const int base = m0 + (ljt - s.qT) * HW - s.qH * s.W - s.qW;
        for (int i = tid; i < s.SR * 8; i += kThreads) {
          const int r = i >> 3, c = i & 7;
          const int f = base + r, co = co0 + 8 * c;
          const bool ok = f >= 0 && f < s.M && co < s.Cout;
          cp_async16(smem_u32(slab + r * kRowBytes + ((c ^ (r & 7)) << 4)),
                     ok ? dy + (long long)f * s.Cout + co : dy, ok);
        }
      }
      uint8_t* tile = sB + (ls % kStages) * L::BBytes;
      const long long k0 =
          (long long)((ljt * s.kH + ljh) * s.kW + ljw) * s.Cout + co0;
#pragma unroll
      for (int i = tid; i < NT * 8; i += kThreads) {
        const int r = i >> 3, c = i & 7;
        const int ci = n0 + r, co = co0 + 8 * c;
        const bool ok = ci < s.Cin && co < s.Cout;
        cp_async16(smem_u32(tile + r * kRowBytes + ((c ^ (r & 7)) << 4)),
                   ok ? wt + ci * K + k0 + 8 * c : wt, ok);
      }
      ++ls;
      if (++ljw == s.kW) {
        ljw = 0;
        if (++ljh == s.kH) {
          ljh = 0;
          if (++lcc == s.nch) {
            lcc = 0;
            ++ljt;
          }
        }
      }
    }
    cp_commit();
  };

  // this lane's ldmatrix row in each m64 tile: its position and (t, h, w)
  const int wg = tid / 128, wq = (tid % 128) / 32, lane = tid % 32;
  const int khalf = lane >> 4;
  int rb[MT], rt[MT], rh[MT], rw[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    rb[mt] = (wg * MT + mt) * 64 + 16 * wq + (lane & 7) + 8 * ((lane >> 3) & 1);
    const int m = m0 + rb[mt];
    rw[mt] = m % s.W;
    rh[mt] = (m / s.W) % s.H;
    rt[mt] = m < s.M ? (m / HW) % s.T : -(1 << 30);  // past M: never valid
  }

  float acc[MT][NT / 2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[mt][i] = 0.0f;

  for (int d = 0; d < s.depth; ++d) load_step();
  int cjt = 0, ccc = 0, cjh = 0, cjw = 0;
  for (int cs = 0; cs < nsteps; ++cs) {
    cp_wait(s.depth - 1);  // step cs's group has landed (this thread's part)
    fence_proxy_async();
    __syncthreads();       // ... every thread's; step cs - 1 is done
    load_step();           // step cs + depth
    const uint8_t* slab = sSlab + ((cjt * s.nch + ccc) & 1) * slab_bytes;
    uint32_t frag[MT][4][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const bool ok = (unsigned)(rt[mt] + cjt - s.qT) < (unsigned)s.T &&
                      (unsigned)(rh[mt] + cjh - s.qH) < (unsigned)s.H &&
                      (unsigned)(rw[mt] + cjw - s.qW) < (unsigned)s.W;
      const int sr = rb[mt] + cjh * s.W + cjw;
      const uint32_t row = ok ? smem_u32(slab + sr * kRowBytes)
                              : smem_u32(sZero);
      const int x = ok ? (sr & 7) : 0;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ldsm_x4(frag[mt][kk], row + (((2 * kk + khalf) ^ x) << 4));
    }
    const uint8_t* tile = sB + (cs % kStages) * L::BBytes;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        mma_rs<NT>(acc[mt], frag[mt][kk], desc(tile + 32 * kk));
    wg_commit();
    wg_wait();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) fence_regs(acc[mt]);
    if (++cjw == s.kW) {
      cjw = 0;
      if (++cjh == s.kH) {
        cjh = 0;
        if (++ccc == s.nch) {
          ccc = 0;
          ++cjt;
        }
      }
    }
  }

  // accumulator fragment: d[i] at row 16 wq + lane / 4 (+ 8 when (i / 2)
  // is odd), column 8 (i / 4) + 2 (lane % 4) + i % 2
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r0 = m0 + (wg * MT + mt) * 64 + 16 * wq + (lane >> 2);
#pragma unroll
    for (int i = 0; i < NT / 2; i += 2) {
      const int m = r0 + 8 * ((i >> 1) & 1);
      const int col = n0 + 8 * (i >> 2) + 2 * (lane & 3);
      if (m < s.M && col < s.Cin)
        *reinterpret_cast<__nv_bfloat162*>(dx + (long long)m * s.Cin + col) =
            __floats2bfloat162_rn(acc[mt][i], acc[mt][i + 1]);
    }
  }
}

template <int NT>
int launch(const __nv_bfloat16* dy, const __nv_bfloat16* wt,
           __nv_bfloat16* dx, Shape s, cudaStream_t stream) {
  using L = Tile<NT>;
  s.SR = L::BM + (s.kH - 1) * s.W + (s.kW - 1);
  const long long smem = (long long)kStages * L::BBytes + kRowBytes +
                         2LL * s.SR * kRowBytes + 1024;
  if (smem > kMaxSmem) return -2;
  // the attributes belong to the current device: set them on every call
  cudaError_t e = cudaFuncSetAttribute(
      dgrad_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(dgrad_kernel<NT>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((s.M + L::BM - 1) / L::BM),
                  (unsigned)((s.Cin + NT - 1) / NT));
  dgrad_kernel<NT><<<grid, kThreads, (size_t)smem, stream>>>(dy, wt, dx, s);
  return (int)cudaGetLastError();
}

}  // namespace

// dy [B, T, H, W, Cout] bf16, wt [Cin, kT, kH, kW, Cout] bf16 (the weight
// flipped over its taps), q the pads of the correlation (k - 1 - SAME's
// pad before) -> dx [B, T, H, W, Cin] bf16. All contiguous.
extern "C" int conv3d_dgrad(const void* dy, const void* wt, void* dx, int B,
                            int T, int H, int W, int Cin, int Cout, int kT,
                            int kH, int kW, int qT, int qH, int qW,
                            void* stream) {
  const long long M = (long long)B * T * H * W;
  if (B < 1 || T < 1 || H < 1 || W < 1 || Cin < 8 || Cout < 8 ||
      Cin % 8 != 0 || Cout % 8 != 0 || kT < 1 || kH < 1 || kW < 1 ||
      qT < 0 || qT >= kT || qH < 0 || qH >= kH || qW < 0 || qW >= kW ||
      M + 512 > (1LL << 31))
    return -1;
  Shape s{};
  s.T = T, s.H = H, s.W = W, s.Cin = Cin, s.Cout = Cout;
  s.kT = kT, s.kH = kH, s.kW = kW, s.qT = qT, s.qH = qH, s.qW = qW;
  s.M = (int)M;
  s.nch = (Cout + 63) / 64;
  s.depth = kH * kW < kStages - 1 ? kH * kW : kStages - 1;
  const auto* a = static_cast<const __nv_bfloat16*>(dy);
  const auto* w = static_cast<const __nv_bfloat16*>(wt);
  auto* o = static_cast<__nv_bfloat16*>(dx);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Cin <= 32) return launch<32>(a, w, o, s, st);
  if (Cin <= 64) return launch<64>(a, w, o, s, st);
  if (Cin <= 128) return launch<128>(a, w, o, s, st);
  return launch<256>(a, w, o, s, st);
}
