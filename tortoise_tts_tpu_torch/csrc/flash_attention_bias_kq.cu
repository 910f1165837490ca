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
// Design: K6's kernel (attention_bias.cuh) with the bias read in place in
// its transposed layout: per 64-key tile the 64 x 64 bias tile is copied
// along the query axis, where rows of bias_t are contiguous, into shared
// memory with coalesced 16-byte loads, and each thread reads its query row
// down the tile's columns, skewed so the read has no bank conflict.  No
// transposed copy of the (H, T, T) bias is made.  The batch is innermost in
// the grid so the blocks that read one bias tile run together.  Keys at or
// past T score -inf and take no weight, so any T works unpadded (the TPU
// kernel padded T to a multiple of 128).
#include "attention_bias.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(THREADS)
    attn_bias_kq(const T* __restrict__ qkv, const T* __restrict__ bias_t,
                 T* __restrict__ out, int H, int Tn, float scale, int vec) {
  const int b = blockIdx.x, h = blockIdx.z;
  const T* base = qkv + ((long long)(b * H + h) * 3 * D) * Tn;
  attn_bias_block<T, true>(base, base + (long long)D * Tn,
                           base + 2LL * D * Tn,
                           bias_t + (long long)h * Tn * Tn, out, Tn, scale,
                           vec);
}

template <typename T>
int run(const void* qkv, const void* bias_t, void* out, int B, int H, int Tn,
        float scale, int vec, cudaStream_t st) {
  return launch_attn<T, true>(attn_bias_kq<T>, B, H, Tn, st,
                              static_cast<const T*>(qkv),
                              static_cast<const T*>(bias_t),
                              static_cast<T*>(out), H, Tn, scale, vec);
}

}  // namespace

// qkv: (B, H*3*64, T) contiguous, per-head [q;k;v] channel blocks; bias_t:
// (H, T, T) contiguous, (key, query) per head, the same type; out: (B, H*64,
// T) contiguous.  dtype: 0 = float32, 1 = bfloat16.  vec: 1 when T is a
// multiple of 8 (bf16) or 4 (fp32) and all three pointers are 16-byte
// aligned.
extern "C" int tts_flash_attention_bias_kq(const void* qkv,
                                           const void* bias_t, void* out,
                                           int B, int H, int T, float scale,
                                           int vec, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return run<__nv_bfloat16>(qkv, bias_t, out, B, H, T, scale, vec, st);
  return run<float>(qkv, bias_t, out, B, H, T, scale, vec, st);
}
