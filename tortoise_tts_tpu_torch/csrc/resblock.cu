// K4 and K5: the diffusion denoiser's fused GroupNorm + convolution halves.
//
// Replaces the TPU kernels tortoise_tts_tpu/ops/pallas_resblock.py
//   K4 fused_gn_conv1x1 (_gn_conv_kernel):
//        out = conv1x1(act?(GroupNorm(x))) + b
//   K5 fused_ts_res_block (_rb_out_kernel), the resblock's second half:
//        out = x + conv3(silu(GroupNorm(h) * (1 + scale) + shift)) + b
// on channels-major (B, C, T) tensors.
//
// Bound on an H100: at the denoiser's shapes (B=2, C=1024, T=896) K4 with
// c_out=1024 is 3.76 GFLOP against 7.3 MB of traffic, so it is bound by
// operations (about 3.8 us at 989 TFLOP/s bf16) and so are the qkv head
// (c_out=3072, 11.3 GFLOP) and K5 (K = 3C, 11.3 GFLOP).
//
// Design: two kernels per call.
//   1. group_stats: one block per (batch, group).  The group's (C/G)*T
//      elements are contiguous; the block reads them twice, for the mean
//      and then the mean of squared deviations (the two-pass variance of
//      jnp.var and F.group_norm, not the TPU kernel's E[x^2]-mu^2, which
//      loses digits when |mean| >> std).
//   2. gemm: out[b] = W (M x K) * Y (K x T) with Y made on load.  Each
//      block owns a 128 x 64 output tile (8 warps, 32 x 32 each) and
//      walks K in steps of 32.  The weight tile is copied with 16-byte
//      loads; the activation tile is computed element by element from x
//      as it is stored to shared memory: normalise with the group's mean
//      and rstd and the channel's gamma/beta in fp32, (K5: times
//      1 + scale, plus shift), round to the storage type, then silu as the
//      TPU kernel does it (fp32 sigmoid rounded to the storage type, the
//      product rounded again).  For K5 the K axis is the weight's own
//      (c, tap) order, kk = 3c + s, so the (C, C, 3) weight is used as a
//      (C, 3C) matrix without a copy and tap s reads x at t + s - 1, zero
//      outside [0, T): the k=3 convolution as one implicit GEMM.
//      bf16: WMMA 16x16x16 tensor-core tiles with fp32 accumulators.
//      fp32: CUDA-core FMAs (8 x 4 outputs a thread), for the fp32
//      reference runs.  The epilogue adds the bias (fp32) and, for K5, the
//      residual x in fp32, and rounds once.  T, M and K are masked at the
//      tile edges, so no shape needs padding; K must be a multiple of 8
//      (16-byte weight loads).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int BM = 128;   // output channels per block
constexpr int BN = 64;    // time steps per block
constexpr int BK = 32;    // reduction step
constexpr int THREADS = 256;
constexpr int APAD = 8, BPAD = 8, CPAD = 4;
constexpr int NCH = BK + 2;   // channels one K step can touch
constexpr int STAT_THREADS = 512;
constexpr int SMEM_BYTES = BM * (BN + CPAD) * 4;   // >= the A and B tiles

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// round to the storage type and back
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  return to_f(from_f<T>(x));
}

__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();   // red may still be read by a previous call
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
  for (int i = 0; i < (int)blockDim.x / 32; ++i) s += red[i];
  return s;
}

template <typename T>
__global__ void __launch_bounds__(STAT_THREADS)
    group_stats(const T* __restrict__ x, float* __restrict__ mu,
                float* __restrict__ rstd, long long n, float eps) {
  __shared__ float red[STAT_THREADS / 32];
  const T* p = x + (long long)blockIdx.x * n;
  float s = 0.f;
  for (long long i = threadIdx.x; i < n; i += blockDim.x) s += to_f(p[i]);
  const float m = block_sum(s, red) / (float)n;
  float q = 0.f;
  for (long long i = threadIdx.x; i < n; i += blockDim.x) {
    const float d = to_f(p[i]) - m;
    q = fmaf(d, d, q);
  }
  const float var = block_sum(q, red) / (float)n;
  if (threadIdx.x == 0) {
    mu[blockIdx.x] = m;
    rstd[blockIdx.x] = rsqrtf(var + eps);
  }
}

struct Prologue {
  const float* mu;      // (B*G) group means of the normalised input
  const float* rstd;    // (B*G)
  const float* gamma;   // (C)
  const float* beta;    // (C)
  const float* scale;   // (B, C) or null
  const float* shift;   // (B, C) or null
  int C, G, T, act;
};

// C[b] (M x T) = W (M x K) * Y_b (K x T) + bias (+ res[b]); Y made from x
// on load (see the header).  TAPS = 1: K = C; TAPS = 3: K = 3C, kk = 3c+s.
template <typename T, int TAPS>
__global__ void __launch_bounds__(THREADS)
    gemm(const T* __restrict__ w, const T* __restrict__ x,
         const float* __restrict__ bias, const T* __restrict__ res,
         T* __restrict__ out, int M, Prologue pro) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  __shared__ float pmu[NCH], prs[NCH], pga[NCH], pbe[NCH], psc[NCH],
      psh[NCH];
  T* As = reinterpret_cast<T*>(smem);                    // [BM][BK+APAD]
  T* Bs = As + BM * (BK + APAD);                         // [BK][BN+BPAD]
  float* Cs = reinterpret_cast<float*>(smem);            // [BM][BN+CPAD]

  const int C = pro.C, Tn = pro.T, K = C * TAPS;
  const int b = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int per = C / pro.G;
  const T* xb = x + (long long)b * C * Tn;

  // bf16: 2 x 2 WMMA accumulators per warp; fp32: 8 x 4 outputs a thread
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
  float facc[8][4];
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) facc[i][j] = 0.f;
  }
  const int warp = tid / 32, wm = warp / 2, wn = warp % 2;

  for (int k0 = 0; k0 < K; k0 += BK) {
    const int c_lo = k0 / TAPS;
    __syncthreads();   // the previous step's tiles are consumed
    if (tid < NCH) {
      const int c = c_lo + tid;
      if (c < C) {
        const int g = b * pro.G + c / per;
        pmu[tid] = pro.mu[g];
        prs[tid] = pro.rstd[g];
        pga[tid] = pro.gamma[c];
        pbe[tid] = pro.beta[c];
        psc[tid] = pro.scale ? pro.scale[b * C + c] : 0.f;
        psh[tid] = pro.shift ? pro.shift[b * C + c] : 0.f;
      }
    }
    // weight tile, 16-byte vectors (K % 8 == 0, so a vector never
    // straddles the end of a row)
    constexpr int VEC = 16 / sizeof(T);
    for (int idx = tid; idx < BM * BK / VEC; idx += THREADS) {
      const int r = idx / (BK / VEC), cv = (idx % (BK / VEC)) * VEC;
      const int m = m0 + r, kk = k0 + cv;
      int4 v = make_int4(0, 0, 0, 0);
      if (m < M && kk < K)
        v = *reinterpret_cast<const int4*>(w + (long long)m * K + kk);
      *reinterpret_cast<int4*>(As + r * (BK + APAD) + cv) = v;
    }
    __syncthreads();   // channel parameters are in shared memory
    // activation tile, made on load
    for (int idx = tid; idx < BK * BN; idx += THREADS) {
      const int r = idx / BN, n = idx % BN;
      const int kk = k0 + r;
      const int c = kk / TAPS;
      const int t = n0 + n + (TAPS == 3 ? kk % 3 - 1 : 0);
      float y = 0.f;
      if (kk < K && t >= 0 && t < Tn) {
        const int j = c - c_lo;
        const float v = to_f(xb[(long long)c * Tn + t]);
        float yn = (v - pmu[j]) * prs[j] * pga[j] + pbe[j];
        if (TAPS == 3) yn = yn * (1.f + psc[j]) + psh[j];
        y = rnd<T>(yn);
        if (pro.act) {
          const float sg = rnd<T>(1.f / (1.f + expf(-y)));
          y = rnd<T>(y * sg);
        }
      }
      Bs[r * (BN + BPAD) + n] = from_f<T>(y);
    }
    __syncthreads();
    if constexpr (sizeof(T) == 2) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> af[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> bf[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(
              af[i],
              reinterpret_cast<const __nv_bfloat16*>(As) +
                  (wm * 32 + i * 16) * (BK + APAD) + kk,
              BK + APAD);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(
              bf[j],
              reinterpret_cast<const __nv_bfloat16*>(Bs) +
                  kk * (BN + BPAD) + wn * 32 + j * 16,
              BN + BPAD);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
      }
    } else {
      const int ty = tid / 16, tx = tid % 16;
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float a[8], bv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          a[i] = to_f(As[(ty * 8 + i) * (BK + APAD) + kk]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bv[j] = to_f(Bs[kk * (BN + BPAD) + tx * 4 + j]);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) facc[i][j] = fmaf(a[i], bv[j], facc[i][j]);
      }
    }
  }
  __syncthreads();   // Cs overlays the A and B tiles
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(
            Cs + (wm * 32 + i * 16) * (BN + CPAD) + wn * 32 + j * 16,
            acc[i][j], BN + CPAD, wmma::mem_row_major);
  } else {
    const int ty = tid / 16, tx = tid % 16;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Cs[(ty * 8 + i) * (BN + CPAD) + tx * 4 + j] = facc[i][j];
  }
  __syncthreads();
  for (int idx = tid; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN, n = idx % BN;
    const int m = m0 + r, t = n0 + n;
    if (m < M && t < Tn) {
      const long long o = ((long long)b * M + m) * Tn + t;
      float v = Cs[r * (BN + CPAD) + n] + bias[m];
      if (res) v += to_f(res[o]);
      out[o] = from_f<T>(v);
    }
  }
}

template <typename T>
int run(const void* w, const void* x, const void* stat_src,
        const float* bias, const void* res, void* out, float* stats, int B,
        int C, int T_len, int M, int G, int act, float eps,
        const float* gamma, const float* beta, const float* scale,
        const float* shift, int taps, cudaStream_t st) {
  float* mu = stats;
  float* rstd = stats + B * G;
  group_stats<T><<<B * G, STAT_THREADS, 0, st>>>(
      static_cast<const T*>(stat_src), mu, rstd,
      (long long)(C / G) * T_len, eps);
  Prologue pro{mu, rstd, gamma, beta, scale, shift, C, G, T_len, act};
  dim3 grid((T_len + BN - 1) / BN, (M + BM - 1) / BM, B);
  if (taps == 3)
    gemm<T, 3><<<grid, THREADS, 0, st>>>(
        static_cast<const T*>(w), static_cast<const T*>(x), bias,
        static_cast<const T*>(res), static_cast<T*>(out), M, pro);
  else
    gemm<T, 1><<<grid, THREADS, 0, st>>>(
        static_cast<const T*>(w), static_cast<const T*>(x), bias,
        static_cast<const T*>(res), static_cast<T*>(out), M, pro);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K4.  x: (B, C, T) contiguous; w: (M, C) contiguous in x's type; gamma,
// beta: (C) fp32; bias: (M) fp32; out: (B, M, T); stats: 2*B*G fp32
// scratch.  dtype: 0 = float32, 1 = bfloat16.  C % 8 == 0, C % G == 0.
extern "C" int tts_gn_conv1x1(const void* x, const float* gamma,
                              const float* beta, const void* w,
                              const float* bias, void* out, float* stats,
                              int B, int C, int T, int M, int G, int act,
                              float eps, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return run<__nv_bfloat16>(w, x, x, bias, nullptr, out, stats, B, C, T,
                              M, G, act, eps, gamma, beta, nullptr, nullptr,
                              1, st);
  return run<float>(w, x, x, bias, nullptr, out, stats, B, C, T, M, G, act,
                    eps, gamma, beta, nullptr, nullptr, 1, st);
}

// K5.  h, x, out: (B, C, T) contiguous; scale, shift: (B, C) fp32; w: the
// (C, C, 3) conv weight, contiguous, in h's type; gamma, beta, bias: (C)
// fp32; stats: 2*B*G fp32 scratch.  C % 8 == 0, C % G == 0.
extern "C" int tts_ts_res_block_out(const void* h, const void* x,
                                    const float* gamma, const float* beta,
                                    const float* scale, const float* shift,
                                    const void* w, const float* bias,
                                    void* out, float* stats, int B, int C,
                                    int T, int G, float eps, int dtype,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return run<__nv_bfloat16>(w, h, h, bias, x, out, stats, B, C, T, C, G,
                              1, eps, gamma, beta, scale, shift, 3, st);
  return run<float>(w, h, h, bias, x, out, stats, B, C, T, C, G, 1, eps,
                    gamma, beta, scale, shift, 3, st);
}
