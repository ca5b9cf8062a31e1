// CTC greedy collapse: per utterance, the first-max argmax over the
// vocabulary at every frame; frames that repeat the previous frame's label,
// that are blank, or that lie at or past the utterance's length are dropped;
// the kept labels are compacted to the front of the row, padded with blank,
// and counted.
//
// Replaces the Pallas kernel `_kernel` / `ctc_greedy_ids_pallas` in
// lipreading_tpu/ops/decode_pallas.py. That kernel placed the kept labels
// with a [T, T] triangular matrix product (a prefix sum) and a one-hot
// mask-sum (a scatter), because its compiler had neither; here the block
// takes an exclusive scan of the keep flags with warp shuffles and writes
// each kept label straight to its place.
//
// Bound on the H100: memory. The function reads the valid frames' logits,
// sum(min(length, T)) * V * 4 bytes, and writes B * T * 4 bytes of ids, with
// about one comparison per logit. Design: one block per utterance, one
// thread per frame, the frames taken in chunks of blockDim with the running
// output offset and the last label of the previous chunk carried from chunk
// to chunk, so any T works; the loop stops at the utterance's length, so
// padded frames are never read. A warp's threads read V consecutive floats
// each from one contiguous stretch of 32 * V floats, which the L1 cache
// serves after the first pass over v.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
ctc_greedy_kernel(const float* __restrict__ logits,
                  const int32_t* __restrict__ lengths,
                  int32_t* __restrict__ ids, int32_t* __restrict__ counts,
                  int T, int V, int blank) {
  __shared__ int32_t s_label[kThreads];
  __shared__ int32_t s_warp[kWarps];
  __shared__ int32_t s_carry_label;
  __shared__ int32_t s_carry_count;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n = min(max(lengths[b], 0), T);
  const float* lg = logits + (size_t)b * T * V;
  int32_t* out = ids + (size_t)b * T;

  if (tid == 0) {
    s_carry_label = blank;
    s_carry_count = 0;
  }
  __syncthreads();

  for (int base = 0; base < n; base += kThreads) {
    const int t = base + tid;
    int label = blank;
    if (t < n) {
      // first maximum wins; a NaN counts as the maximum, as in torch.argmax
      const float* row = lg + (size_t)t * V;
      float best = __ldg(row);
      int arg = 0;
      bool best_nan = isnan(best);
      for (int v = 1; v < V && !best_nan; ++v) {
        const float x = __ldg(row + v);
        if (isnan(x)) {
          best_nan = true;
          arg = v;
        } else if (x > best) {
          best = x;
          arg = v;
        }
      }
      label = arg;
    }
    s_label[tid] = label;
    __syncthreads();

    const int prev = tid == 0 ? s_carry_label : s_label[tid - 1];
    const int keep = (t < n) && label != blank && label != prev;

    // exclusive scan of keep over the block: warp shuffles, then warp sums
    int incl = keep;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    int warp_off = 0, chunk_total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_warp[w];
      warp_off += (w < warp) ? c : 0;
      chunk_total += c;
    }
    const int offset = s_carry_count;
    if (keep) out[offset + warp_off + incl - keep] = label;
    __syncthreads();  // every thread has read the carries and s_warp
    if (tid == kThreads - 1) {
      s_carry_label = label;
      s_carry_count = offset + chunk_total;
    }
    __syncthreads();
  }

  const int count = s_carry_count;
  for (int t = count + tid; t < T; t += kThreads) out[t] = blank;
  if (tid == 0) counts[b] = count;
}

}  // namespace

// logits [B, T, V] f32, lengths [B] int32 -> ids [B, T] int32, counts [B]
// int32; all contiguous on the device of `stream`.
extern "C" int ctc_greedy(const void* logits, const void* lengths, void* ids,
                          void* counts, int B, int T, int V, int blank,
                          void* stream) {
  cudaGetLastError();  // clear an earlier, unrelated error
  if (B == 0) return 0;
  ctc_greedy_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const int32_t*>(lengths),
      static_cast<int32_t*>(ids), static_cast<int32_t*>(counts), T, V, blank);
  return (int)cudaGetLastError();
}
