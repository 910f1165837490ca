// K8: W8A8 GEMV with an optional fused LayerNorm, for the UnifiedVoice
// decode step under decode_quant="w8a8".
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
// order, so the split over K changes nothing.
//
// Bound on an H100: bytes, as for K2.  The int8 weights are all the
// traffic: 1024x3072 + 1024x1024 + 1024x4096 + 4096x1024 bytes per layer,
// 12.58 MB, 3.76 us at 3.35 TB/s, at M=1 as at M=32; the int8 operations
// at M=32 take 0.4 us at the 1,979 dense int8 TOPS.
//
// Design: K2's layout.  A block of 256 threads owns a tile of 128 output
// columns and a slice of K (split-K over grid.y; the wrapper sizes it so
// the grid has about two blocks per SM).  Its prologue reads the whole
// row, because the absmax needs it (K <= 4096, from L2): the LN
// statistics, then the absmax of the normalised row, then the codes of
// its own K slice into shared memory as int32.  Each thread streams 16
// int8 weights of one row with one 16-byte load and multiply-adds them
// into int32 accumulators (scalar IMAD); 32 rows are in flight per block.
// Tile rows reduce by warp shuffles, then across the 8 warps in shared
// memory.  With one K slice the block applies the epilogue; with several
// it writes int32 partials and a second kernel adds them and applies it.
// Rows go in blocks of 4 (1 at M=1), one launch per block of rows.  The
// int8 tensor-core form (mma.sync m16n8k32 s8) is left to a speed PR.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TN = 128;    // output columns per block
constexpr int VEC = 16;    // int8 weights per 16-byte load
constexpr int GROUPS = TN / VEC;          // 8 column groups
constexpr int KROWS = THREADS / GROUPS;   // 32 rows in flight
constexpr int WARPS = THREADS / 32;
constexpr float LN_EPS = 1e-5f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ int i8(uint32_t word, int i) {
  return static_cast<int32_t>(word << (24 - 8 * i)) >> 24;
}

// Sum (or max) of v over the block; every thread gets the result.  red is
// WARPS floats of shared scratch.
template <bool MAX>
__device__ __forceinline__ float block_all(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = MAX ? fmaxf(v, u) : v + u;
  }
  __syncthreads();  // red is free again
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int i = 1; i < WARPS; ++i) r = MAX ? fmaxf(r, red[i]) : r + red[i];
  return r;
}

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

__device__ __forceinline__ float epilogue(int acc, float sx, const float* s,
                                          const float* bias, int n) {
  const float y = __fmul_rn(__fmul_rn(__int2float_rn(acc), sx), s[n]);
  return bias != nullptr ? __fadd_rn(y, bias[n]) : y;
}

// grid: (N / TN, ksplit); rows m0 .. m0+MB-1 of x.  sx_out (M,) receives
// each row's scale (block (0, 0)); codes (M, K) int8, if not null, the
// codes (the blocks of column tile 0, each its K slice).
template <typename T, int MB>
__global__ void __launch_bounds__(THREADS)
    w8a8_kernel(const T* __restrict__ x, int M, int K, int N,
                const int8_t* __restrict__ w, const float* __restrict__ s,
                const float* __restrict__ bias,
                const float* __restrict__ gamma,
                const float* __restrict__ beta, int kc,
                int* __restrict__ partial, float* __restrict__ sx_out,
                int8_t* __restrict__ codes, T* __restrict__ out, int m0) {
  extern __shared__ int xs[];  // (MB, kc) codes
  __shared__ int red[WARPS][MB][TN];
  __shared__ float scratch[WARPS];
  __shared__ float sx_s[MB];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int kbase = blockIdx.y * kc;

  for (int m = 0; m < MB; ++m) {
    const int row = m0 + m;
    if (row >= M) {  // uniform over the block
      for (int kk = tid; kk < kc; kk += THREADS) xs[m * kc + kk] = 0;
      continue;
    }
    const T* xr = x + (long long)row * K;
    float mu = 0.f, rstd = 0.f;
    if (gamma != nullptr) {
      float s1 = 0.f, s2 = 0.f;
      for (int k = tid; k < K; k += THREADS) {
        const float v = to_f(xr[k]);
        s1 += v;
        s2 = fmaf(v, v, s2);
      }
      s1 = block_all<false>(s1, scratch);
      s2 = block_all<false>(s2, scratch);
      mu = s1 / K;
      rstd = 1.f / sqrtf(__fadd_rn(__fsub_rn(s2 / K, __fmul_rn(mu, mu)),
                                   LN_EPS));
    }
    float amax = 0.f;
    for (int k = tid; k < K; k += THREADS)
      amax = fmaxf(amax, fabsf(normed(xr, k, mu, rstd, gamma, beta)));
    amax = block_all<true>(amax, scratch);
    const float sx = __fadd_rn(amax / 127.f, 1e-12f);
    if (tid == 0) {
      sx_s[m] = sx;
      if (blockIdx.x == 0 && blockIdx.y == 0) sx_out[row] = sx;
    }
    for (int kk = tid; kk < kc; kk += THREADS) {
      const float v = normed(xr, kbase + kk, mu, rstd, gamma, beta);
      const int q = static_cast<int>(fminf(fmaxf(rintf(v / sx), -127.f),
                                           127.f));
      xs[m * kc + kk] = q;
      if (codes != nullptr && blockIdx.x == 0)
        codes[(long long)row * K + kbase + kk] = static_cast<int8_t>(q);
    }
  }
  __syncthreads();

  const int cg = tid % GROUPS, kr = tid / GROUPS;
  const int n0 = blockIdx.x * TN + cg * VEC;
  int acc[MB][VEC];
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[m][j] = 0;

  const int8_t* wp = w + (long long)kbase * N + n0;
#pragma unroll 4
  for (int kk = kr; kk < kc; kk += KROWS) {
    const uint4 q = *reinterpret_cast<const uint4*>(wp + (long long)kk * N);
    const uint32_t words[4] = {q.x, q.y, q.z, q.w};
    int wv[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) wv[j] = i8(words[j / 4], j % 4);
#pragma unroll
    for (int m = 0; m < MB; ++m) {
      const int xv = xs[m * kc + kk];
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[m][j] += xv * wv[j];
    }
  }

  // lanes that share a column group differ in bits 3 and 4 of the lane
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      int v = acc[m][j];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < GROUPS) red[warp][m][cg * VEC + j] = v;
    }
  __syncthreads();

  for (int i = tid; i < MB * TN; i += THREADS) {
    const int m = i / TN, c = i % TN;
    if (m0 + m >= M) continue;
    int v = 0;
#pragma unroll
    for (int wi = 0; wi < WARPS; ++wi) v += red[wi][m][c];
    const int n = blockIdx.x * TN + c;
    if (gridDim.y == 1)
      out[(long long)(m0 + m) * N + n] =
          from_f<T>(epilogue(v, sx_s[m], s, bias, n));
    else
      partial[((long long)blockIdx.y * M + m0 + m) * N + n] = v;
  }
}

template <typename T>
__global__ void w8a8_finalize(const int* __restrict__ partial, int ksplit,
                              int M, int N, const float* __restrict__ sx,
                              const float* __restrict__ s,
                              const float* __restrict__ bias,
                              T* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)M * N;
  if (i >= total) return;
  const int n = static_cast<int>(i % N);
  const int m = static_cast<int>(i / N);
  int v = 0;
  for (int k = 0; k < ksplit; ++k) v += partial[k * total + i];
  out[i] = from_f<T>(epilogue(v, sx[m], s, bias, n));
}

template <typename T, int MB>
void launch_rows(const T* x, int M, int K, int N, const int8_t* w,
                 const float* s, const float* b, const float* g,
                 const float* be, int ks, int* partial, float* sx,
                 int8_t* codes, T* out, cudaStream_t st) {
  const int kc = K / ks;
  const dim3 grid(N / TN, ks);
  const size_t smem = sizeof(int) * MB * kc;
  for (int m0 = 0; m0 < M; m0 += MB)
    w8a8_kernel<T, MB><<<grid, THREADS, smem, st>>>(
        x, M, K, N, w, s, b, g, be, kc, partial, sx, codes, out, m0);
}

template <typename T>
int run(const T* x, int M, int K, int N, const int8_t* w, const float* s,
        const float* b, const float* g, const float* be, int ks,
        int* partial, float* sx, int8_t* codes, T* out, cudaStream_t st) {
  if (M == 1)
    launch_rows<T, 1>(x, M, K, N, w, s, b, g, be, ks, partial, sx, codes,
                      out, st);
  else
    launch_rows<T, 4>(x, M, K, N, w, s, b, g, be, ks, partial, sx, codes,
                      out, st);
  if (ks > 1) {
    const long long total = (long long)M * N;
    w8a8_finalize<T><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
        partial, ks, M, N, sx, s, b, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and out).  w: (K, N) int8,
// 16-byte aligned; N % 128 == 0.  bias, gamma, beta may be null (gamma
// and beta together).  ksplit divides K into slices of at least 64 rows;
// above 1, partial is int32 scratch of (ksplit, M, N).  sx: fp32 (M,)
// scratch that receives the row scales; codes: null, or int8 (M, K) that
// receives the activation codes.
extern "C" int tts_qgemv_w8a8(const void* x, int M, int K, int N,
                              const void* w, const void* s, const void* bias,
                              const void* gamma, const void* beta, int ksplit,
                              void* partial, void* sx, void* codes, void* out,
                              int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(s);
  const float* bi = static_cast<const float*>(bias);
  const float* g = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  int* pa = static_cast<int*>(partial);
  float* sxp = static_cast<float*>(sx);
  int8_t* cp = static_cast<int8_t*>(codes);
  if (dtype == 1)
    return run<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(x), M, K, N,
                              wq, sc, bi, g, be, ksplit, pa, sxp, cp,
                              static_cast<__nv_bfloat16*>(out), st);
  return run<float>(static_cast<const float*>(x), M, K, N, wq, sc, bi, g, be,
                    ksplit, pa, sxp, cp, static_cast<float*>(out), st);
}
