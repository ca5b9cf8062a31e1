// CTC greedy collapse: per utterance, the first-max argmax over the
// vocabulary at every frame; frames that repeat the previous frame's label,
// that are blank, or that lie at or past the utterance's length are dropped;
// the kept labels are compacted to the front of the row, padded with blank,
// and counted.
//
// Replaces the Pallas kernel `_kernel` (lipreading_tpu/ops/decode_pallas.py
// :22, `pallas_call` :79). That kernel placed the kept labels with a [T, T]
// triangular matrix product (a prefix sum) and a one-hot mask-sum (a
// scatter), because its compiler had neither; here the block takes an
// exclusive scan of the keep flags with warp ballots and writes each kept
// label straight to its place.
//
// Bound on the H100: the function reads the valid frames' logits,
// sum(min(length, T)) V 4 bytes, and writes B T 4 bytes of ids: ~0.1 MB at
// the serving shape (B 8 x T 96 x V 31), 0.5 MB at the long-clip shape
// (B 4 x T 1024), 0.01-0.15 us at 3.35 TB/s, far below one launch. So what
// bounds it is latency: one block an utterance (8 and 4 of the 132 SMs),
// and inside the block the chain from the first load to the last store.
// The design shortens that chain:
//
// * Staged, coalesced logits. The block copies its chunk of frames'
//   logits, chunk x V contiguous floats, into shared memory with 16-byte
//   `cp.async` (4-byte ones for the head and tail around a start that is
//   not 16-byte aligned, b T V 4 is not always), all in flight at once,
//   issued before the utterance's length has even arrived. The old kernel
//   read each frame's row with V dependent scalar loads a thread, at a
//   stride of V 4 bytes across the warp.
// * Argmax from shared memory, one thread a frame, with no early exit: four
//   independent running maxima over interleaved vocabulary entries, each
//   update a select, merged by value and then index. The rule is the old
//   kernel's: the first maximum wins, and the first NaN counts as the
//   maximum. A row stride of odd V floats reads without bank conflicts; an
//   even V is padded by one float (and copied 4 bytes at a time).
// * Up to 1024 frames a chunk, one thread a frame (ops/decode.py
//   `greedy_plan`, handed to the C entry): the serving and the
//   long-clip shapes are one chunk each. Longer utterances take chunks
//   whose copies are double-buffered, the next chunk's in flight while this
//   one's argmax and scan run. A chunk costs two block barriers: one after
//   its copy, one to publish each warp's first label, last label and count;
//   every warp then scans the warp totals itself, so the running offset and
//   the last label carry to the next chunk in registers.
// * A V too large for 32 staged frames (V 2000) takes a warp a frame: the
//   lanes read the row coalesced from device memory and merge their maxima
//   by shuffles, inside the same kernel.
// * No atomics: two launches write the same bytes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kBadPlan = -1;  // returned for a plan the entry refuses

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

// One running maximum takes x at index v: x is larger, or x is the first
// NaN (a NaN best never leaves).
__device__ __forceinline__ void take(float& best, int& arg, float x, int v) {
  const bool t = (x > best) | ((x != x) & (best == best));
  best = t ? x : best;
  arg = t ? v : arg;
}

// Merge two running maxima: the NaN with the lower index, else the larger
// value, else (a tie) the lower index.
__device__ __forceinline__ void merge(float& b1, int& a1, float b2, int a2) {
  const bool n1 = b1 != b1, n2 = b2 != b2;
  const bool t = n2 ? (!n1 | (a2 < a1))
                    : (!n1 & ((b2 > b1) | ((b2 == b1) & (a2 < a1))));
  b1 = t ? b2 : b1;
  a1 = t ? a2 : a1;
}

// First-max argmax of a row of V floats in shared memory.
__device__ __forceinline__ int row_argmax(const float* row, int V) {
  float b[4];
  int a[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    b[j] = j < V ? row[j] : -INFINITY;
    a[j] = j < V ? j : INT32_MAX;
  }
  int v = 4;
#pragma unroll 2
  for (; v + 4 <= V; v += 4) {
#pragma unroll
    for (int j = 0; j < 4; ++j) take(b[j], a[j], row[v + j], v + j);
  }
  for (; v < V; ++v) take(b[0], a[0], row[v], v);
  merge(b[0], a[0], b[1], a[1]);
  merge(b[2], a[2], b[3], a[3]);
  merge(b[0], a[0], b[2], a[2]);
  return a[0];
}

// Copy frames [0, cnt) of `src` (rows of V floats) into `buf`: row f at
// buf + off + f sV, where the returned `off` (odd V: src's offset past a
// 16-byte boundary, so 16-byte copies line up; even V: 0) and sV (V, or V + 1
// for an even V) are what the reader adds.
__device__ __forceinline__ int stage_rows(float* buf, const float* src,
                                          int cnt, int V, int sV) {
  if (V & 1) {
    const int off = (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
    const int total = cnt * V;
    const int head = min((4 - off) & 3, total);
    const int body = (total - head) >> 2;      // 16-byte copies
    float* dst = buf + off;
    for (int i = threadIdx.x; i < body; i += blockDim.x)
      cp_async16(dst + head + 4 * i, src + head + 4 * i);
    const int tail0 = head + 4 * body;
    const int i = threadIdx.x;
    if (i < head) cp_async4(dst + i, src + i);
    if (i < total - tail0) cp_async4(dst + tail0 + i, src + tail0 + i);
    return off;
  }
  const int warps = blockDim.x >> 5, lane = threadIdx.x & 31;
  for (int f = threadIdx.x >> 5; f < cnt; f += warps)
    for (int v = lane; v < V; v += 32)
      cp_async4(buf + f * sV + v, src + f * V + v);
  return 0;
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Grid: one block an utterance, `greedy_plan`'s threads. kStaged: one or
// two shared buffers of `buf_floats` (one: the whole utterance is one
// chunk; two: chunks double-buffered). Otherwise a warp a frame from device
// memory, and the labels meet in shared memory. Every chunk but the last is
// full (chunk = threads): its last warp's last label carries on.
template <bool kStaged>
__global__ void __launch_bounds__(kMaxThreads)
ctc_greedy_kernel(const float* __restrict__ logits,
                  const int32_t* __restrict__ lengths,
                  int32_t* __restrict__ ids, int32_t* __restrict__ counts,
                  int T, int V, int sV, int chunk, int buf_floats, int blank) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int32_t s_first[32];   // label of each warp's lane 0
  __shared__ int32_t s_last[32];    // label of each warp's last lane
  __shared__ int32_t s_count[32];   // keeps of each warp's lanes 1..31

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  const float* lg = logits + (size_t)b * T * V;
  int32_t* out = ids + (size_t)b * T;

  int off = 0;   // the current chunk's row offset in its buffer
  if (kStaged)   // the first chunk, before the length has arrived
    off = stage_rows(smem, lg, min(chunk, T), V, sV);
  commit();
  const int n = min(max(lengths[b], 0), T);

  int carry_label = blank, carry_count = 0;
  for (int k = 0, base = 0; base < n; ++k, base += chunk) {
    const int t = base + tid;
    const bool valid = tid < chunk && t < n;
    int label = blank;
    if (kStaged) {
      int off_next = 0;
      if (base + chunk < n) {   // the next chunk's copy, in flight meanwhile
        const int nb = base + chunk;
        off_next = stage_rows(smem + ((k + 1) & 1) * buf_floats,
                              lg + (size_t)nb * V, min(chunk, T - nb), V, sV);
        commit();
        wait_group<1>();
      } else {
        wait_group<0>();
      }
      __syncthreads();   // this chunk has landed, for every thread
      if (valid)
        label = row_argmax(smem + (k & 1) * buf_floats + off + tid * sV, V);
      off = off_next;
    } else {
      int* s_label = reinterpret_cast<int*>(smem);
      for (int f = warp; f < chunk && base + f < n; f += warps) {
        const float* row = lg + (size_t)(base + f) * V;
        float best = -INFINITY;
        int arg = INT32_MAX;
        for (int v = lane; v < V; v += 32) take(best, arg, __ldg(row + v), v);
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) {
          const float ob = __shfl_xor_sync(0xffffffffu, best, d);
          const int oa = __shfl_xor_sync(0xffffffffu, arg, d);
          merge(best, arg, ob, oa);
        }
        if (lane == 0) s_label[f] = arg;
      }
      __syncthreads();
      if (valid) label = s_label[tid];
    }

    // keep flags: lanes 1..31 from the lane before, lane 0 from the warp
    // before (after the barrier); then each warp scans the warp totals
    const int up = __shfl_up_sync(0xffffffffu, label, 1);
    const bool keep_rest = lane > 0 && valid && label != blank && label != up;
    const unsigned rest = __ballot_sync(0xffffffffu, keep_rest);
    if (lane == 0) {
      s_first[warp] = label;
      s_count[warp] = __popc(rest);
    }
    if (lane == 31) s_last[warp] = label;
    __syncthreads();
    int total = 0;
    if (lane < warps) {
      const int first = s_first[lane];
      const int before = lane == 0 ? carry_label : s_last[lane - 1];
      total = s_count[lane] + (first != blank && first != before);
    }
    int incl = total;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, d);
      incl += lane >= d ? y : 0;
    }
    const int warp_off = __shfl_sync(0xffffffffu, incl - total, warp);
    const int chunk_total = __shfl_sync(0xffffffffu, incl, warps - 1);
    const int before = warp == 0 ? carry_label : s_last[warp - 1];
    const bool keep = lane == 0 ? (valid && label != blank && label != before)
                                : keep_rest;
    const unsigned all = __ballot_sync(0xffffffffu, keep);
    if (keep)
      out[carry_count + warp_off + __popc(all & ((1u << lane) - 1u))] = label;
    carry_label = s_last[warps - 1];   // the chunk's last frame (full chunks)
    carry_count += chunk_total;
  }
  if (kStaged) wait_group<0>();   // a first copy past a length of 0

  for (int t = carry_count + tid; t < T; t += blockDim.x) out[t] = blank;
  if (tid == 0) counts[b] = carry_count;
}

template <bool kStaged>
int launch(const float* logits, const int32_t* lengths, int32_t* ids,
           int32_t* counts, int B, int T, int V, int blank, int sV, int chunk,
           int buf_floats, int threads, int smem, cudaStream_t s) {
  static int wide = 48 * 1024;   // the attribute is per kernel: raised once
  if (smem > wide) {              // the device refuses more than it has
    const cudaError_t e = cudaFuncSetAttribute(
        ctc_greedy_kernel<kStaged>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    wide = smem;
  }
  ctc_greedy_kernel<kStaged><<<B, threads, smem, s>>>(
      logits, lengths, ids, counts, T, V, sV, chunk, buf_floats, blank);
  return (int)cudaGetLastError();
}

}  // namespace

// logits [B, T, V] f32, lengths [B] int32 -> ids [B, T] int32, counts [B]
// int32; all contiguous on the device of `stream`. The launch, from
// ops/decode.py `greedy_plan`: a row stride of sV floats (V for an odd V,
// at least V for an even one), chunks of `chunk` frames, `nbuf` staged
// buffers of `buf_floats` (0: a warp a frame from device memory), `threads`
// and `smem` bytes of dynamic shared memory a block. A plan that would skip
// a frame, break the carry between chunks or overrun its shared memory is
// refused (kBadPlan) before any launch.
extern "C" int ctc_greedy(const void* logits, const void* lengths, void* ids,
                          void* counts, int B, int T, int V, int blank,
                          int sV, int chunk, int nbuf, int buf_floats,
                          int threads, int smem, void* stream) {
  cudaGetLastError();  // clear an earlier, unrelated error
  const bool rows_fit = (V & 1) ? sV == V : sV >= V;
  const bool carry = chunk >= T || chunk == threads;
  const bool bufs = nbuf == 0
      ? smem >= 4 * threads
      : buf_floats % 4 == 0 && buf_floats >= chunk * sV + 3 &&
            smem >= 4 * nbuf * buf_floats && (nbuf == 2 || chunk >= T);
  if (!rows_fit || chunk < 1 || chunk > threads || threads % 32 != 0 ||
      threads > kMaxThreads || !carry || nbuf < 0 || nbuf > 2 || !bufs)
    return kBadPlan;
  if (B == 0) return 0;
  const float* lg = static_cast<const float*>(logits);
  const int32_t* ln = static_cast<const int32_t*>(lengths);
  int32_t* id = static_cast<int32_t*>(ids);
  int32_t* ct = static_cast<int32_t*>(counts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return nbuf ? launch<true>(lg, ln, id, ct, B, T, V, blank, sV, chunk,
                             buf_floats, threads, smem, s)
              : launch<false>(lg, ln, id, ct, B, T, V, blank, sV, chunk,
                              buf_floats, threads, smem, s);
}
