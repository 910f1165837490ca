// K8: W8A8 GEMM of a few rows (the decode's GEMVs) with an optional
// fused LayerNorm, for the UnifiedVoice decode step under
// decode_quant="w8a8".
//
// Replaces the TPU kernel tortoise_tts_tpu/ops/pallas_gemv.py
// qgemv_stacked_w8a8 (_gemv_body's w8a8 branch, _stacked_call):
//     xf = LN?(x)                       (rounded to x's type)
//     sx = max|xf| / 127 + 1e-12        per row
//     xq = clip(rint(xf / sx), -127, 127)   int8, round half to even
//     y  = (float(xq @ Wq) * sx) * s + b    int32 dot, fp32 epilogue
// x (M, K) fp32 or bf16, any M; Wq (K, N) int8 row-major (the JAX
// package's (in, out) layout); s, b fp32 (N,).  The LayerNorm is fp32 with
// the E[x^2] - mu^2 variance and eps 1e-5 (pallas_gemv._ln_f32), and its
// output is rounded to x's type before the quantization, as the JAX
// package's off-TPU branch (_ln_xla) does; in fp32 that rounding is a no-op
// and the TPU kernel's order is the same.  Output in x's type.
//
// Numerics: the division decides integer codes, so it is IEEE (no
// --use_fast_math, no __fdividef) and rintf rounds half to even, as
// jnp.round and torch.round do.  The LN and the epilogue use the _rn
// intrinsics, which the compiler never contracts into FMAs, so every
// float step rounds where the plain PyTorch version rounds: in fp32
// without the LN the codes and the output are bit-equal to it.  With the
// LN only the order of the row sums differs (a block reduction here), so
// an activation on a rounding edge may land one int8 step away.  Integer
// sums cannot overflow (127^2 * 4096 < 2^31) and do not depend on their
// order, so neither the tensor cores' order nor the split over K changes
// a bit.
//
// Bound on an H100: bytes, as for K2.  The int8 weights are all but all
// the traffic: 1024x3072 + 1024x1024 + 1024x4096 + 4096x1024 bytes a
// layer, 12.58 MB, 3.76 us at 3.35 TB/s, at M=1 as at M=32; the int8
// operations at M=32 take 0.4 us at the 1,979 dense int8 TOPS.
//
// Design: at most two kernels a call.
// - w8a8_quantize, one block a row: the LN statistics, the absmax of the
//   normalised row, then the int8 codes (M, K) and the row scales sx (M,).
//   At M <= 16 the wrapper may put this quantizer into the GEMM's prologue
//   instead (QuantA: every block quantizes its rows and keeps its slice's
//   codes), one kernel a call.
// - w8a8_gemm_s8 (csrc/small_m_gemm.cuh): one launch for all rows, every
//   weight byte read once; a block owns 128 output columns and a K slice
//   for up to 64 rows, the weights stream through a 4-stage cp.async ring
//   and mma.sync m16n8k32 s8 x s8 -> s32 multiplies them by the codes
//   (rows past M are zeros).  Under split-K the last block of a column
//   tile to arrive adds the int32 partials and applies the epilogue.
#include "small_m_gemm.cuh"

namespace {

using small_m::from_f;
using small_m::to_f;
using small_m::THREADS;
using small_m::TN;

constexpr int Q_THREADS = 256;
constexpr int Q_WARPS = Q_THREADS / 32;

// Element k of the row as the quantizer sees it: LN?(x), in x's type.
template <typename T>
__device__ __forceinline__ float normed(const T* xr, int k, float mu,
                                        float rstd, const float* gamma,
                                        const float* beta) {
  float v = to_f(xr[k]);
  if (gamma != nullptr) {
    v = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, mu), rstd), gamma[k]),
                  beta[k]);
    v = to_f(from_f<T>(v));
  }
  return v;
}

// grid: (M,).  codes (M, K) int8 and sx (M,) fp32 of each row.
template <typename T>
__global__ void __launch_bounds__(Q_THREADS)
    w8a8_quantize(const T* __restrict__ x, int K,
                  const float* __restrict__ gamma,
                  const float* __restrict__ beta, int8_t* __restrict__ codes,
                  float* __restrict__ sx_out) {
  __shared__ float scratch[Q_WARPS];
  const int tid = threadIdx.x, row = blockIdx.x;
  const T* xr = x + (long long)row * K;
  float mu = 0.f, rstd = 0.f;
  if (gamma != nullptr) {
    float s1 = 0.f, s2 = 0.f;
    for (int k = tid; k < K; k += Q_THREADS) {
      const float v = to_f(xr[k]);
      s1 += v;
      s2 = fmaf(v, v, s2);
    }
    s1 = small_m::block_reduce<false, Q_THREADS>(s1, scratch);
    s2 = small_m::block_reduce<false, Q_THREADS>(s2, scratch);
    mu = s1 / K;
    rstd = 1.f / sqrtf(__fadd_rn(__fsub_rn(s2 / K, __fmul_rn(mu, mu)),
                                 small_m::LN_EPS));
  }
  float amax = 0.f;
  for (int k = tid; k < K; k += Q_THREADS)
    amax = fmaxf(amax, fabsf(normed(xr, k, mu, rstd, gamma, beta)));
  amax = small_m::block_reduce<true, Q_THREADS>(amax, scratch);
  const float sx = __fadd_rn(amax / 127.f, 1e-12f);
  if (tid == 0) sx_out[row] = sx;
  for (int k = tid; k < K; k += Q_THREADS) {
    const float v = normed(xr, k, mu, rstd, gamma, beta);
    codes[(long long)row * K + k] = static_cast<int8_t>(
        fminf(fmaxf(rintf(v / sx), -127.f), 127.f));
  }
}

// K8's quantizer inside the GEMM (M <= 16): each block quantizes its rows
// while the weight stages are in flight, the block's threads together on
// one row at a time (the LN statistics, the absmax of the normalised row,
// then the codes of the block's slice; one warp a row is slower at M=1,
// tools/qgemv_tiles.py); the blocks of column tile 0 also write the codes
// and block (0, 0) the scales.  The row sums run in another order than the
// quantize kernel's; without the LN the codes are the same bit for bit.
template <typename T>
struct QuantA {
  const T* x;
  int K;
  const float* gamma;
  const float* beta;
  int8_t* codes;
  float* sx_out;
  float* sx_s;   // shared: the rows' scales, for the epilogue
  __device__ __forceinline__ void copy(uint8_t*, int, int, int, int, int,
                                       int) const {}
  __device__ __forceinline__ void compute(uint8_t* as, int AS, int rows16,
                                          int row0, int rows, int kbase,
                                          int kc) const {
    using small_m::block_reduce;
    __shared__ float red[THREADS / 32];
    const int tid = threadIdx.x;
    for (int m = 0; m < rows; ++m) {
      const int row = row0 + m;
      const T* xr = x + (long long)row * K;
      float mu = 0.f, rstd = 0.f;
      if (gamma != nullptr) {
        float s1 = 0.f, s2 = 0.f;
        for (int k = tid; k < K; k += THREADS) {
          const float v = to_f(xr[k]);
          s1 += v;
          s2 = fmaf(v, v, s2);
        }
        s1 = block_reduce<false>(s1, red);
        s2 = block_reduce<false>(s2, red);
        mu = s1 / K;
        rstd = 1.f / sqrtf(__fadd_rn(__fsub_rn(s2 / K, __fmul_rn(mu, mu)),
                                     small_m::LN_EPS));
      }
      float amax = 0.f;
      for (int k = tid; k < K; k += THREADS)
        amax = fmaxf(amax, fabsf(normed(xr, k, mu, rstd, gamma, beta)));
      amax = block_reduce<true>(amax, red);
      const float sx = __fadd_rn(amax / 127.f, 1e-12f);
      if (tid == 0) {
        sx_s[m] = sx;
        if (blockIdx.x == 0 && blockIdx.y == 0) sx_out[row] = sx;
      }
      for (int kk = tid; kk < kc; kk += THREADS) {
        const float v = normed(xr, kbase + kk, mu, rstd, gamma, beta);
        const int8_t q = static_cast<int8_t>(
            fminf(fmaxf(rintf(v / sx), -127.f), 127.f));
        as[m * AS + kk] = static_cast<uint8_t>(q);
        if (blockIdx.x == 0) codes[(long long)row * K + kbase + kk] = q;
      }
    }
    for (int i = tid; i < (rows16 - rows) * kc; i += THREADS)
      as[(rows + i / kc) * AS + i % kc] = 0;
  }
};

// y = (acc * sx) * s + b; m is the row within the block's rows
struct Epi {
  const float* sx;   // the block's row scales: global, or a shared copy
  bool has_bias;
  __device__ __forceinline__ float operator()(int acc, int m, float s_n,
                                              float b_n) const {
    const float y = __fmul_rn(__fmul_rn(__int2float_rn(acc), sx[m]), s_n);
    return has_bias ? __fadd_rn(y, b_n) : y;
  }
};

// grid: (N / TN, ksplit, ceil(M / 64)).  FUSED (M <= 16): the quantizer
// in the prologue, from x; otherwise the codes and sx that w8a8_quantize
// wrote.
template <typename T, int MT, bool FUSED>
__global__ void __launch_bounds__(THREADS)
    w8a8_gemm_s8(const T* __restrict__ x, int M, int K, int N,
                 const int8_t* __restrict__ w, const float* __restrict__ s,
                 const float* __restrict__ bias,
                 const float* __restrict__ gamma,
                 const float* __restrict__ beta, int kc,
                 int* __restrict__ partial, int* __restrict__ counters,
                 float* __restrict__ sx, int8_t* __restrict__ codes,
                 T* __restrict__ out) {
  using small_m::AKind;
  if constexpr (FUSED) {
    __shared__ float sx_s[16];
    small_m::gemm_body<AKind::S8, MT>(
        M, N, w, s, bias, kc, partial, counters, out,
        QuantA<T>{x, K, gamma, beta, codes, sx, sx_s},
        Epi{sx_s, bias != nullptr});
  } else {
    small_m::gemm_body<AKind::S8, MT>(
        M, N, w, s, bias, kc, partial, counters, out,
        small_m::CopyA<1>{codes, K},
        Epi{sx + blockIdx.z * 64, bias != nullptr});
  }
}

template <typename T, int MT, bool FUSED>
int launch_gemm(const T* x, int M, int K, int N, const int8_t* w,
                const float* s, const float* b, const float* g,
                const float* be, int ks, int* partial, int* counters,
                float* sx, int8_t* codes, T* out, cudaStream_t st) {
  const int kc = K / ks;
  const size_t smem = small_m::smem_bytes<small_m::AKind::S8>(MT, kc);
  const int rc = small_m::allow_smem(w8a8_gemm_s8<T, MT, FUSED>, smem);
  if (rc != 0) return rc;
  const dim3 grid(N / TN, ks, (M + 63) / 64);
  w8a8_gemm_s8<T, MT, FUSED><<<grid, THREADS, smem, st>>>(
      x, M, K, N, w, s, b, g, be, kc, partial, counters, sx, codes, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run(const T* x, int M, int K, int N, const int8_t* w, const float* s,
        const float* b, const float* g, const float* be, int ks, int fused,
        int* partial, int* counters, float* sx, int8_t* codes, T* out,
        cudaStream_t st) {
  if (fused) {
    if (M > 16) return static_cast<int>(cudaErrorInvalidValue);
    return launch_gemm<T, 1, true>(x, M, K, N, w, s, b, g, be, ks, partial,
                                   counters, sx, codes, out, st);
  }
  w8a8_quantize<T><<<M, Q_THREADS, 0, st>>>(x, K, g, be, codes, sx);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const int mt = ((M >= 64 ? 64 : M) + 15) / 16;
  if (mt == 1)
    return launch_gemm<T, 1, false>(x, M, K, N, w, s, b, g, be, ks, partial,
                                    counters, sx, codes, out, st);
  if (mt == 2)
    return launch_gemm<T, 2, false>(x, M, K, N, w, s, b, g, be, ks, partial,
                                    counters, sx, codes, out, st);
  if (mt == 3)
    return launch_gemm<T, 3, false>(x, M, K, N, w, s, b, g, be, ks, partial,
                                    counters, sx, codes, out, st);
  return launch_gemm<T, 4, false>(x, M, K, N, w, s, b, g, be, ks, partial,
                                  counters, sx, codes, out, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and out).  w: (K, N) int8, 16-byte
// aligned; N % 128 == 0; K % 16 == 0; ksplit divides K into slices of a
// multiple of 32 rows.  bias, gamma, beta may be null (gamma and beta
// together).  codes: (M, K) int8 and sx: (M,) fp32 receive the activation
// codes and the row scales.  fused = 1 (M <= 16) quantizes inside the GEMM
// (one kernel); otherwise w8a8_quantize runs first.  Above one slice,
// partial is (ksplit, M, N) int32 scratch and counters holds ceil(M / 64)
// x N / 128 zeros, which the kernel leaves at zero.
extern "C" int tts_qgemv_w8a8(const void* x, int M, int K, int N,
                              const void* w, const void* s, const void* bias,
                              const void* gamma, const void* beta, int ksplit,
                              int fused, void* partial, void* counters,
                              void* sx, void* codes, void* out, int dtype,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(s);
  const float* bi = static_cast<const float*>(bias);
  const float* g = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  int* pa = static_cast<int*>(partial);
  int* cn = static_cast<int*>(counters);
  float* sxp = static_cast<float*>(sx);
  int8_t* cp = static_cast<int8_t*>(codes);
  if (dtype == 1)
    return run<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(x), M, K, N,
                              wq, sc, bi, g, be, ksplit, fused, pa, cn, sxp,
                              cp, static_cast<__nv_bfloat16*>(out), st);
  return run<float>(static_cast<const float*>(x), M, K, N, wq, sc, bi, g, be,
                    ksplit, fused, pa, cn, sxp, cp, static_cast<float*>(out),
                    st);
}
