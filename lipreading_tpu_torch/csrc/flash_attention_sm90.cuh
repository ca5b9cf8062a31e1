// The Hopper (sm_90a) bf16 flash-attention kernels of
// flash_attention_sm90.cu, called by flash_attention.cu's C entries for
// bf16 inputs. Arguments as those entries take them; D % 8 == 0 and every
// [B, T, H, D] base 16-byte aligned (TMA's rule), else they return
// cudaErrorInvalidValue without launching.
#pragma once

#include <cuda_runtime.h>

// q, k, v [B, T, H, D] bf16, lengths [B] int32 -> out [B, T, H, D] bf16 and,
// when lse is not null, lse [B, H, T] float32.
int flash_fwd_bf16_sm90(const void* q, const void* k, const void* v,
                        const void* lengths, void* out, void* lse, int B,
                        int T, int H, int D, float scale, cudaStream_t stream);

// The forward's inputs, dO [B, T, H, D] bf16, delta [B, T, H] and lse
// [B, H, T] float32 -> dk, dv [B, T, H, D] bf16, with dq (unscaled) added
// into the zeroed float32 workspace dq_ws [B, T, H, D].
int flash_bwd_fused_bf16_sm90(const void* q, const void* k, const void* v,
                              const void* lengths, const void* dout,
                              const void* delta, const void* lse, void* dq_ws,
                              void* dk, void* dv, int B, int T, int H, int D,
                              float scale, cudaStream_t stream);
