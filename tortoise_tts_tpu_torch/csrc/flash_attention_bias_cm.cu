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
// Design: K6's kernel (attention_bias.cuh) with the q, k and v base pointers
// and the (batch, head) stride as arguments; the bias is read row-major.
// The batch is innermost in the grid so the blocks that read one bias tile
// run together and the tile stays in L2.  Keys at or past T score -inf and
// take no weight, so any T works unpadded (the TPU kernel padded T to a
// multiple of 128).
#include "attention_bias.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(THREADS)
    attn_bias_cm(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, long long bh_stride,
                 const T* __restrict__ bias, T* __restrict__ out, int H,
                 int Tn, float scale, int vec) {
  const int b = blockIdx.x, h = blockIdx.z;
  const long long off = (long long)(b * H + h) * bh_stride;
  attn_bias_block<T, false>(q + off, k + off, v + off,
                            bias + (long long)h * Tn * Tn, out, Tn, scale,
                            vec);
}

template <typename T>
int run(const void* q, const void* k, const void* v, long long bh_stride,
        const void* bias, void* out, int B, int H, int Tn, float scale,
        int vec, cudaStream_t st) {
  return launch_attn<T, false>(
      attn_bias_cm<T>, B, H, Tn, st, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), bh_stride,
      static_cast<const T*>(bias), static_cast<T*>(out), H, Tn, scale, vec);
}

int dispatch(const void* q, const void* k, const void* v, long long bh_stride,
             const void* bias, void* out, int B, int H, int T, float scale,
             int vec, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return run<__nv_bfloat16>(q, k, v, bh_stride, bias, out, B, H, T, scale,
                              vec, st);
  return run<float>(q, k, v, bh_stride, bias, out, B, H, T, scale, vec, st);
}

}  // namespace

// q, k, v: (B, H, 64, T) contiguous each; bias: (H, T, T) contiguous,
// (query, key) per head, the same type; out: (B, H, 64, T) contiguous.
// dtype: 0 = float32, 1 = bfloat16.  vec: 1 when T is a multiple of 8
// (bf16) or 4 (fp32) and all five pointers are 16-byte aligned.
extern "C" int tts_flash_attention_bias_cm(const void* q, const void* k,
                                           const void* v, const void* bias,
                                           void* out, int B, int H, int T,
                                           float scale, int vec, int dtype,
                                           void* stream) {
  return dispatch(q, k, v, (long long)D * T, bias, out, B, H, T, scale, vec,
                  dtype, stream);
}

// qkv: (B, H*3*64, T) contiguous, per-head [q;k;v] channel blocks; bias and
// the other arguments as above; out: (B, H*64, T) contiguous.
extern "C" int tts_flash_attention_bias_qkv(const void* qkv, const void* bias,
                                            void* out, int B, int H, int T,
                                            float scale, int vec, int dtype,
                                            void* stream) {
  const char* base = static_cast<const char*>(qkv);
  const size_t plane = (size_t)D * T * (dtype == 1 ? 2 : 4);
  return dispatch(base, base + plane, base + 2 * plane, 3LL * D * T, bias,
                  out, B, H, T, scale, vec, dtype, stream);
}
