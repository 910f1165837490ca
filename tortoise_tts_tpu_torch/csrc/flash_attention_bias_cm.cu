// K9b: non-causal flash attention with an additive per-head bias on
// channels-major q, k and v, for the denoiser's rel-pos attention blocks
// below batch 8 under Inference.denoise_attention = "flash_bias".
//
// Replaces the TPU kernel tortoise_tts_tpu/ops/pallas_attention.py
// flash_attention_bias_cm and flash_attention_bias_qkv (_attn_bias_kernel
// through _bias_cm_call), one kernel with two entries:
//     o[b, h] = softmax(q k^T / sqrt(64) + bias[h]) v
// with bias (H, Tq, S) shared across the batch and output (B, H*64, T)
// channels-major, on
// - split q, k and v, each (B, H, 64, T) (tts_flash_attention_bias_cm), or
// - the fused (B, H*3*64, T) qkv with the per-head [q;k;v] channel
//   interleave (tts_flash_attention_bias_qkv).
// Both read their operands in place, by base pointer and (batch, head)
// stride: no split and no copy.  Scores, the softmax statistics and the
// accumulator are fp32; the probabilities are rounded to the input type
// before the AV product.  The TPU kernel took the whole softmax over all
// keys before the AV product; this kernel takes it online, tile by tile
// (attention_bias.cuh), so each weight is rounded against the running row
// max and normalised at the end: the same within bf16.
//
// Bound on an H100: at B=2, H=16, T=896 (the single route's trunk) a call
// must read 11 MB of q, k and v and 25.7 MB of bias and write 3.7 MB (12 us
// at 3.35 TB/s) for 6.6 GFLOP (6.7 us at the bf16 tensor-core peak): bytes.
//
// Design: K6's body (attention_bias.cuh, attn_bias_tc_block, the bias read
// by ldmatrix) with the q, k and v base pointers and the (batch, head)
// stride as arguments: the fused entry computes what K6 computes, bit for
// bit.  fp32 inputs use attn_bias_cm_f32 (K6's 3xTF32 body; its fused
// entry is K6's fp32 function bit for bit too).
#include "attention_bias.cuh"

namespace {

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    attn_bias_cm_tc(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap bmap,
                   const __grid_constant__ BiasArgs a) {
  attn_bias_tc_block<false>(&qmap, &kmap, &vmap, &bmap, a);
}

__global__ void __launch_bounds__(THREADS, F_MIN_BLOCKS)
    attn_bias_cm_f32(const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap bmap,
                     const __grid_constant__ F32Args a) {
  attn_bias_f32_block<false>(&kmap, &vmap, &bmap, a);
}

int dispatch(const void* q, const void* k, const void* v, long long bh_stride,
             const void* bias, void* out, int B, int H, int T, float scale,
             int tma, int dtype, int nb, int nq, int stages, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 1)
    return launch_f32<attn_bias_cm_f32>(
        F32Args{static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), bh_stride,
                static_cast<const float*>(bias), static_cast<float*>(out), B,
                H, T, scale, tma},
        st);
  const BiasArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                   static_cast<const bf16*>(v), bh_stride,
                   static_cast<const bf16*>(bias), static_cast<bf16*>(out),
                   B, H, T, scale, tma};
  return launch_tc<attn_bias_cm_tc>(a, nb, nq, stages, st);
}

}  // namespace

// q, k, v: (B, H, 64, T) contiguous each; bias: (H, T, T) contiguous,
// (query, key) per head, the same type; out: (B, H, 64, T) contiguous.
// dtype: 0 = float32, 1 = bfloat16.  tma = 1 when T's rows are 16-byte
// aligned (T a multiple of 8 in bf16, of 4 in fp32) and all five pointers
// are; bf16 only: (nb, nq, stages) the launch plan.
extern "C" int tts_flash_attention_bias_cm(const void* q, const void* k,
                                           const void* v, const void* bias,
                                           void* out, int B, int H, int T,
                                           float scale, int tma, int dtype,
                                           int nb, int nq, int stages,
                                           void* stream) {
  return dispatch(q, k, v, (long long)D * T, bias, out, B, H, T, scale, tma,
                  dtype, nb, nq, stages, stream);
}

// qkv: (B, H*3*64, T) contiguous, per-head [q;k;v] channel blocks; bias and
// the other arguments as above; out: (B, H*64, T) contiguous.
extern "C" int tts_flash_attention_bias_qkv(const void* qkv, const void* bias,
                                            void* out, int B, int H, int T,
                                            float scale, int tma, int dtype,
                                            int nb, int nq, int stages,
                                            void* stream) {
  const char* base = static_cast<const char*>(qkv);
  const size_t plane = (size_t)D * T * (dtype == 1 ? 2 : 4);
  return dispatch(base, base + plane, base + 2 * plane, 3LL * D * T, bias,
                  out, B, H, T, scale, tma, dtype, nb, nq, stages, stream);
}
