// K2: weight-only int8 GEMV with an optional fused LayerNorm, for the
// UnifiedVoice decode step.
//
// Replaces the TPU kernel tortoise_tts_tpu/ops/pallas_gemv.py
// qgemv_stacked (_qgemv_kernel / _qgemv_ln_kernel / _gemv_body):
//     y = (LN?(x) @ Wq) * s + b
// x (M, K) fp32 or bf16, any M, Wq (K, N) int8 row-major (the JAX
// package's (in, out) layout), s and b fp32 (N,).  The LayerNorm is fp32
// with the E[x^2] - mu^2 variance and eps 1e-5 (pallas_gemv._ln_f32),
// and the normalised row is rounded to x's type before the product, as
// the TPU kernel does.  Output in x's type.
//
// Bound on an H100: bytes.  At M=1 the weights are all the traffic:
// 1024x3072 + 1024x1024 + 1024x4096 + 4096x1024 int8 per layer, 377.5 MB
// per token over 30 layers, 0.113 ms per token at 3.35 TB/s.  There is
// no reuse to exploit, so the design only has to keep enough loads in
// flight on every SM.
//
// Design: a block of 256 threads owns a tile of 128 output columns and a
// slice of K (split-K over grid.y; the wrapper sizes it so the grid has
// about two blocks per SM).  Each thread streams 16 int8 weights of one
// row with one 16-byte load, dequantises in registers and accumulates in
// fp32; 32 rows are in flight per block per step.  The block's activations (LN applied
// once per block from the full row) sit in shared memory.  Rows of the
// tile reduce by warp shuffles, then across the 8 warps in shared memory.
// With one K slice the block applies s and b and writes y; with several,
// each writes fp32 partial sums and a second small kernel adds them and
// applies s and b.  The layer index is the caller's: it passes the
// pointer to Wq[li].  Rows go in blocks of 4 (1 at M=1), one launch of
// the GEMV kernel per block of rows, all into one (ksplit, M, N) partial
// buffer, so any M works.
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float i8(uint32_t word, int i) {
  return static_cast<float>(static_cast<int32_t>(word << (24 - 8 * i)) >> 24);
}

// grid: (N / TN, ksplit); rows m0 .. m0+MB-1 of x.
template <typename T, int MB>
__global__ void __launch_bounds__(THREADS)
    qgemv_kernel(const T* __restrict__ x, int M, int K, int N,
                 const int8_t* __restrict__ w, const float* __restrict__ s,
                 const float* __restrict__ bias,
                 const float* __restrict__ gamma,
                 const float* __restrict__ beta, int kc,
                 float* __restrict__ partial, T* __restrict__ out, int m0) {
  extern __shared__ float xs[];  // (MB, kc)
  __shared__ float red[WARPS][MB][TN];
  __shared__ float stats[WARPS][MB][2];
  __shared__ float mu_s[MB], rstd_s[MB];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int kbase = blockIdx.y * kc;

  if (gamma != nullptr) {
    // LayerNorm statistics over the whole row, once per block
    float sum[MB], sq[MB];
#pragma unroll
    for (int m = 0; m < MB; ++m) {
      sum[m] = 0.f;
      sq[m] = 0.f;
      if (m0 + m < M) {
        const T* xr = x + (long long)(m0 + m) * K;
        for (int k = tid; k < K; k += THREADS) {
          const float v = to_f(xr[k]);
          sum[m] += v;
          sq[m] = fmaf(v, v, sq[m]);
        }
      }
      sum[m] = warp_sum(sum[m]);
      sq[m] = warp_sum(sq[m]);
      if (lane == 0) {
        stats[warp][m][0] = sum[m];
        stats[warp][m][1] = sq[m];
      }
    }
    __syncthreads();
    if (tid < MB) {
      float a = 0.f, b2 = 0.f;
      for (int i = 0; i < WARPS; ++i) {
        a += stats[i][tid][0];
        b2 += stats[i][tid][1];
      }
      const float mu = a / K;
      const float var = b2 / K - mu * mu;
      mu_s[tid] = mu;
      rstd_s[tid] = rsqrtf(var + LN_EPS);
    }
    __syncthreads();
  }
  for (int i = tid; i < MB * kc; i += THREADS) {
    const int m = i / kc, kk = i % kc;
    float v = 0.f;
    if (m0 + m < M) {
      const int k = kbase + kk;
      v = to_f(x[(long long)(m0 + m) * K + k]);
      if (gamma != nullptr) {
        v = (v - mu_s[m]) * rstd_s[m] * gamma[k] + beta[k];
        v = to_f(from_f<T>(v));  // the TPU kernel rounds LN(x) to x's type
      }
    }
    xs[i] = v;
  }
  __syncthreads();

  const int cg = tid % GROUPS, kr = tid / GROUPS;
  const int n0 = blockIdx.x * TN + cg * VEC;
  float acc[MB][VEC];
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[m][j] = 0.f;

  const int8_t* wp = w + (long long)kbase * N + n0;
#pragma unroll 4
  for (int kk = kr; kk < kc; kk += KROWS) {
    const uint4 q = *reinterpret_cast<const uint4*>(wp + (long long)kk * N);
    const uint32_t words[4] = {q.x, q.y, q.z, q.w};
    float wf[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) wf[j] = i8(words[j / 4], j % 4);
#pragma unroll
    for (int m = 0; m < MB; ++m) {
      const float xv = xs[m * kc + kk];
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[m][j] = fmaf(xv, wf[j], acc[m][j]);
    }
  }

  // lanes that share a column group differ in bits 3 and 4 of the lane
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float v = acc[m][j];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < GROUPS) red[warp][m][cg * VEC + j] = v;
    }
  __syncthreads();

  for (int i = tid; i < MB * TN; i += THREADS) {
    const int m = i / TN, c = i % TN;
    if (m0 + m >= M) continue;
    float v = 0.f;
#pragma unroll
    for (int wi = 0; wi < WARPS; ++wi) v += red[wi][m][c];
    const int n = blockIdx.x * TN + c;
    if (gridDim.y == 1) {
      v = v * s[n] + (bias != nullptr ? bias[n] : 0.f);
      out[(long long)(m0 + m) * N + n] = from_f<T>(v);
    } else {
      partial[((long long)blockIdx.y * M + m0 + m) * N + n] = v;
    }
  }
}

template <typename T>
__global__ void qgemv_finalize(const float* __restrict__ partial, int ksplit,
                               int M, int N, const float* __restrict__ s,
                               const float* __restrict__ bias,
                               T* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)M * N;
  if (i >= total) return;
  const int n = static_cast<int>(i % N);
  float v = 0.f;
  for (int k = 0; k < ksplit; ++k) v += partial[k * total + i];
  v = v * s[n] + (bias != nullptr ? bias[n] : 0.f);
  out[i] = from_f<T>(v);
}

template <typename T, int MB>
void launch_rows(const T* x, int M, int K, int N, const int8_t* w,
                 const float* s, const float* b, const float* g,
                 const float* be, int ks, float* partial, T* out,
                 cudaStream_t st) {
  const int kc = K / ks;
  const dim3 grid(N / TN, ks);
  const size_t smem = sizeof(float) * MB * kc;
  for (int m0 = 0; m0 < M; m0 += MB)
    qgemv_kernel<T, MB><<<grid, THREADS, smem, st>>>(
        x, M, K, N, w, s, b, g, be, kc, partial, out, m0);
}

template <typename T>
int run(const T* x, int M, int K, int N, const int8_t* w, const float* s,
        const float* b, const float* g, const float* be, int ks,
        float* partial, T* out, cudaStream_t st) {
  if (M == 1)
    launch_rows<T, 1>(x, M, K, N, w, s, b, g, be, ks, partial, out, st);
  else
    launch_rows<T, 4>(x, M, K, N, w, s, b, g, be, ks, partial, out, st);
  if (ks > 1) {
    const long long total = (long long)M * N;
    qgemv_finalize<T><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
        partial, ks, M, N, s, b, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and out).  w: (K, N) int8,
// 16-byte aligned; N % 128 == 0.  bias, gamma, beta may be null (gamma
// and beta together).  ksplit divides K into slices of at most 1024 rows;
// above 1, partial is fp32 scratch of (ksplit, M, N).
extern "C" int tts_qgemv(const void* x, int M, int K, int N, const void* w,
                         const void* s, const void* bias, const void* gamma,
                         const void* beta, int ksplit, void* partial,
                         void* out, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(s);
  const float* bi = static_cast<const float*>(bias);
  const float* g = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  float* pa = static_cast<float*>(partial);
  if (dtype == 1)
    return run<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(x), M, K, N,
                              wq, sc, bi, g, be, ksplit, pa,
                              static_cast<__nv_bfloat16*>(out), st);
  return run<float>(static_cast<const float*>(x), M, K, N, wq, sc, bi, g, be,
                    ksplit, pa, static_cast<float*>(out), st);
}
