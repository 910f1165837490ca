// K9a: non-causal flash attention with an additive per-head bias given
// TRANSPOSED, for the denoiser's rel-pos attention blocks under
// Inference.denoise_attention = "kq".
//
// Replaces the TPU kernel tortoise_tts_tpu/ops/pallas_attention.py
// flash_attention_bias_qkv_kq (_attn_bias_kq_kernel):
//     o[b, h] = softmax(q k^T / sqrt(64) + bias_t[h]^T) v
// on the fused channels-major qkv (B, H*3*64, T) with the per-head [q;k;v]
// channel interleave, bias_t (H, S, Tq) shared across the batch, where
// bias_t[h, s, t] is the bias of query t and key s, output (B, H*64, T)
// channels-major.  Scores, the softmax statistics and the accumulator are
// fp32; the probabilities are rounded to the input type before the AV
// product, as the TPU kernel does.  The TPU kernel kept its scores as (S,
// bq) so both of its matrix-unit products ran untransposed, and reduced the
// softmax over the key axis; here the orientation of the scores is the
// kernel's own choice, so only the bias's layout remains of it.
//
// Bound on an H100: at B=2, H=16, T=896 (the single route's trunk) a call
// must read 11 MB of qkv and 25.7 MB of bias and write 3.7 MB (12 us at
// 3.35 TB/s) for 6.6 GFLOP (6.7 us at the bf16 tensor-core peak): bytes; at
// B=16 the operations (53 us against 43 us).
//
// Design: K6's body (attention_bias.cuh, attn_bias_tc_block with BIAS_T).
// The (key, query) bias tile is copied whole by TMA, along its rows as they
// lie in memory, into swizzled shared memory, and read into the score
// accumulators by ldmatrix.trans: an 8 x 8 block of the transposed tile
// lands in the same threads and elements as K6's by ldmatrix, so the
// transposed bias costs what K6's does and no transposed copy of the
// (H, T, T) bias is made.  fp32 inputs use attn_bias_kq_f32 (K6's 3xTF32
// body with BIAS_T: each thread reads the (key, query) tile's elements of
// its score accumulators from shared memory, conflict-free).
#include "attention_bias.cuh"

namespace {

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    attn_bias_kq_tc(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap bmap,
                   const __grid_constant__ BiasArgs a) {
  attn_bias_tc_block<true>(&qmap, &kmap, &vmap, &bmap, a);
}

__global__ void __launch_bounds__(THREADS, F_MIN_BLOCKS)
    attn_bias_kq_f32(const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap bmap,
                     const __grid_constant__ F32Args a) {
  attn_bias_f32_block<true>(&kmap, &vmap, &bmap, a);
}

}  // namespace

// qkv: (B, H*3*64, T) contiguous, per-head [q;k;v] channel blocks; bias_t:
// (H, T, T) contiguous, (key, query) per head, the same type; out: (B,
// H*64, T) contiguous.  dtype: 0 = float32, 1 = bfloat16.  tma = 1 when
// T's rows are 16-byte aligned (T a multiple of 8 in bf16, of 4 in fp32)
// and all three pointers are; bf16 only: (nb, nq, stages) the launch
// plan.
extern "C" int tts_flash_attention_bias_kq(const void* qkv,
                                           const void* bias_t, void* out,
                                           int B, int H, int T, float scale,
                                           int tma, int dtype, int nb, int nq,
                                           int stages, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 1) {
    const float* q = static_cast<const float*>(qkv);
    return launch_f32<attn_bias_kq_f32>(
        F32Args{q, q + (long long)D * T, q + 2LL * D * T, 3LL * D * T,
                static_cast<const float*>(bias_t), static_cast<float*>(out),
                B, H, T, scale, tma},
        st);
  }
  const bf16* q = static_cast<const bf16*>(qkv);
  const BiasArgs a{q, q + (long long)D * T, q + 2LL * D * T, 3LL * D * T,
                   static_cast<const bf16*>(bias_t), static_cast<bf16*>(out),
                   B, H, T, scale, tma};
  return launch_tc<attn_bias_kq_tc>(a, nb, nq, stages, st);
}
