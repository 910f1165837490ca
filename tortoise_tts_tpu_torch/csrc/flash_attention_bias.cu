// K6: non-causal flash attention with an additive per-head bias, for the
// diffusion denoiser's rel-pos attention blocks at batch >= 8.
//
// Replaces the TPU kernel tortoise_tts_tpu/ops/pallas_attention.py
// flash_attention_bias_qkv_vt (_attn_bias_vt_kernel and its head-group
// form _attn_bias_vt_hg_kernel):
//     o[b, h] = softmax(q k^T / sqrt(64) + bias[h]) v
// on the fused channels-major qkv (B, H*3*64, T) with the per-head [q;k;v]
// channel interleave, bias (H, T, T) (query, key) shared across the batch,
// output (B, H*64, T) channels-major.  Scores, the softmax statistics and
// the accumulator are fp32; the probabilities are rounded to the input type
// before the AV product, as the TPU kernel does (its p.astype(v.dtype)).
// The TPU kernel padded T to a multiple of 128 and pre-transposed V; here
// the ragged end is masked and V is read channels-major, as it lies.  Its
// ones column for the normaliser has a counterpart: 8 rows of ones behind
// each V tile in shared memory, so the PV product also sums P's rows.
//
// Bound on an H100: operations.  At B=16, H=16, T=896 (the batch route's
// cond-free trunk) a call does 4 B H T^2 64 = 52.6 GFLOP (53 us at 989
// TFLOP/s) and must read 88 MB of qkv and 25.7 MB of bias and write 29 MB
// (43 us at 3.35 TB/s); at B=8 (its integrator) 26.3 GFLOP (27 us) against
// 25 us of bytes.  At head dim 64 the exponentials weigh about as much as
// the products: B H T^2 = 205 M ex2 at B=16, about 50 us on the special
// function units, so softmax and products have to overlap.
//
// Design: the shared tensor-core body (attention_bias.cuh,
// attn_bias_tc_block, the bias tile read by ldmatrix): a block of one
// warpgroup per (batch row, 64-query tile, head) keeps a ring of
// TMA-copied (bias, K, V) tiles two steps deep, runs both products on
// wgmma with S and P in registers and the softmax in between, and the
// four blocks on an SM overlap one's softmax with another's products.
// fp32 inputs (the reference runs) use attn_bias_f32, the same block in
// 3xTF32 (attn_bias_f32_block): at B=16 3 x 52.6 GFLOP of TF32 products
// (0.319 ms at 495 TFLOP/s) against 0.785 ms at the fp32 FMA rate.
#include "attention_bias.cuh"

namespace {

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    attn_bias_tc(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                const __grid_constant__ CUtensorMap bmap,
                const __grid_constant__ BiasArgs a) {
  attn_bias_tc_block<false>(&qmap, &kmap, &vmap, &bmap, a);
}

__global__ void __launch_bounds__(THREADS, F_MIN_BLOCKS)
    attn_bias_f32(const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  const __grid_constant__ CUtensorMap bmap,
                  const __grid_constant__ F32Args a) {
  attn_bias_f32_block<false>(&kmap, &vmap, &bmap, a);
}

}  // namespace

// qkv: (B, H*3*64, T) contiguous, per-head [q;k;v] channel blocks; bias:
// (H, T, T) contiguous, the same type; out: (B, H*64, T) contiguous.
// dtype: 0 = float32, 1 = bfloat16.  tma = 1 when T's rows are 16-byte
// aligned (T a multiple of 8 in bf16, of 4 in fp32) and all three
// pointers are; bf16 only: (nb, nq, stages) the launch plan.
extern "C" int tts_flash_attention_bias(const void* qkv, const void* bias,
                                        void* out, int B, int H, int T,
                                        float scale, int tma, int dtype,
                                        int nb, int nq, int stages,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 1) {
    const float* q = static_cast<const float*>(qkv);
    return launch_f32<attn_bias_f32>(
        F32Args{q, q + (long long)D * T, q + 2LL * D * T, 3LL * D * T,
                static_cast<const float*>(bias), static_cast<float*>(out), B,
                H, T, scale, tma},
        st);
  }
  const bf16* q = static_cast<const bf16*>(qkv);
  const BiasArgs a{q, q + (long long)D * T, q + 2LL * D * T, 3LL * D * T,
                   static_cast<const bf16*>(bias), static_cast<bf16*>(out),
                   B, H, T, scale, tma};
  return launch_tc<attn_bias_tc>(a, nb, nq, stages, st);
}
