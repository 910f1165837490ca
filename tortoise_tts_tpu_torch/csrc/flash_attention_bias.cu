// K6: non-causal flash attention with an additive per-head bias, for the
// diffusion denoiser's rel-pos attention blocks at batch >= 8.
//
// Replaces the TPU kernel tortoise_tts_tpu/ops/pallas_attention.py
// flash_attention_bias_qkv_vt (_attn_bias_vt_kernel and its head-group
// form _attn_bias_vt_hg_kernel):
//     o[b, h] = softmax(q k^T / sqrt(64) + bias[h]) v
// on the fused channels-major qkv (B, H*3*64, T) with the per-head [q;k;v]
// channel interleave, bias (H, T, T) shared across the batch, output
// (B, H*64, T) channels-major.  Scores, the softmax statistics and the
// accumulator are fp32; the probabilities are rounded to the input type
// before the AV product, as the TPU kernel does (its p.astype(v.dtype)).
//
// Bound on an H100: bytes.  At B=16, H=16, T=896 a call must read 88 MB of
// qkv and 25.7 MB of bias and write 29 MB (43 us at 3.35 TB/s) for 13.2
// GFLOP (13 us at the bf16 tensor-core peak).
//
// Design (the shared body in attention_bias.cuh): one block of 4 warps per
// (batch, 64-query tile, head), with the batch innermost in the grid so the
// blocks that read one bias tile run together and the tile stays in L2.
// q, k and v tiles (64 channels x 64 times) are copied straight from the
// channels-major layout, where T is contiguous: coalesced 16-byte loads when
// T is a multiple of 8, no split and no transpose.  Per 64-key tile the two
// products run on WMMA 16x16x16 (bf16 in, fp32 out) and the online softmax
// in registers; the bias is read row-major from (H, T, T).  Keys at or past
// T score -inf and take no weight, so any T works unpadded (the TPU kernel
// padded T to a multiple of 128).  fp32 inputs (the reference runs) use
// CUDA-core FMAs for the two products.
#include "attention_bias.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(THREADS)
    attn_bias(const T* __restrict__ qkv, const T* __restrict__ bias,
              T* __restrict__ out, int H, int Tn, float scale, int vec) {
  const int b = blockIdx.x, h = blockIdx.z;
  const T* base = qkv + ((long long)(b * H + h) * 3 * D) * Tn;
  attn_bias_block<T, false>(base, base + (long long)D * Tn,
                            base + 2LL * D * Tn,
                            bias + (long long)h * Tn * Tn, out, Tn, scale,
                            vec);
}

template <typename T>
int run(const void* qkv, const void* bias, void* out, int B, int H, int Tn,
        float scale, int vec, cudaStream_t st) {
  return launch_attn<T, false>(attn_bias<T>, B, H, Tn, st,
                               static_cast<const T*>(qkv),
                               static_cast<const T*>(bias),
                               static_cast<T*>(out), H, Tn, scale, vec);
}

}  // namespace

// qkv: (B, H*3*64, T) contiguous, per-head [q;k;v] channel blocks; bias:
// (H, T, T) contiguous, the same type; out: (B, H*64, T) contiguous.
// dtype: 0 = float32, 1 = bfloat16.  vec: 1 when T is a multiple of 8
// (bf16) or 4 (fp32) and all three pointers are 16-byte aligned.
extern "C" int tts_flash_attention_bias(const void* qkv, const void* bias,
                                        void* out, int B, int H, int T,
                                        float scale, int vec, int dtype,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return run<__nv_bfloat16>(qkv, bias, out, B, H, T, scale, vec, st);
  return run<float>(qkv, bias, out, B, H, T, scale, vec, st);
}
