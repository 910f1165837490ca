// K2: weight-only int8 GEMM of a few rows (the decode's GEMVs) with an
// optional fused LayerNorm, for the UnifiedVoice decode step.
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
// Bound on an H100: bytes.  The int8 weights are all but all the traffic,
// at M = 1 as at M = 64: 1024x3072 + 1024x1024 + 1024x4096 + 4096x1024
// bytes a layer, 12.58 MB, 3.76 us at 3.35 TB/s; the bf16 products at
// M = 32 take 0.8 us at 989 TFLOP/s.  So every row must come out of one
// pass over the weights, with enough bytes in flight on every SM.
//
// Design (csrc/small_m_gemm.cuh): one launch for all rows.  A block owns
// 128 output columns and a K slice for up to 64 rows; the weight slice
// streams once through a 4-stage cp.async ring.
// - bf16: mma.sync m16n8k16 bf16 on the tensor cores; the int8 weights
//   become bf16 in registers (exact), the rows past M are zeros, s and b
//   are applied in the epilogue.
// - fp32: CUDA-core FMAs (TF32 would round the fp32 activations), 16 rows
//   a block (grid.z above 16): a thread owns 4 columns, the 4 warps split
//   the stage's rows and add their sums in warp order.
// - The LayerNorm: either a row kernel (qgemv_ln_rows, one block a row)
//   writes LN(x) in x's type and the GEMM reads it, or (bf16, ln_fused,
//   M <= 16) each GEMM block takes its rows' statistics over the whole row
//   and applies the LN while staging its slice: one kernel, but every
//   block reads the whole rows.  The wrapper picks by M.
// - Split-K: the last block of a column tile to arrive adds the slices'
//   partial sums in slice order and applies the epilogue.
// So a call is at most two kernels (the LN row kernel, then the GEMM).
#include "small_m_gemm.cuh"

namespace {

using small_m::from_f;
using small_m::to_f;
using small_m::THREADS;
using small_m::TN;
using small_m::KSTG;
using small_m::STAGES;
using small_m::STAGE_BYTES;
using small_m::CT_STRIDE;

constexpr int LN_THREADS = 256;
constexpr int F32_ROWS = 16;   // rows a block of the fp32 kernel at most

// LN(x) rounded to x's type, one block a row (fp32 statistics:
// thread-strided sums, then the warps' sums added in warp order)
template <typename T>
__global__ void __launch_bounds__(LN_THREADS)
    qgemv_ln_rows(const T* __restrict__ x, int K,
                  const float* __restrict__ gamma,
                  const float* __restrict__ beta, T* __restrict__ xn) {
  __shared__ float part[LN_THREADS / 32][2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* xr = x + (long long)blockIdx.x * K;
  float s1 = 0.f, s2 = 0.f;
  for (int k = tid; k < K; k += LN_THREADS) {
    const float v = to_f(xr[k]);
    s1 += v;
    s2 = fmaf(v, v, s2);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  }
  if (lane == 0) {
    part[warp][0] = s1;
    part[warp][1] = s2;
  }
  __syncthreads();
  float a = 0.f, b2 = 0.f;
#pragma unroll
  for (int i = 0; i < LN_THREADS / 32; ++i) {
    a += part[i][0];
    b2 += part[i][1];
  }
  const float mu = a / K;
  const float rstd = rsqrtf(b2 / K - mu * mu + small_m::LN_EPS);
  T* yr = xn + (long long)blockIdx.x * K;
  for (int k = tid; k < K; k += LN_THREADS)
    yr[k] = from_f<T>((to_f(xr[k]) - mu) * rstd * gamma[k] + beta[k]);
}

// y = acc * s + b (b = 0 without a bias)
struct Epi {
  __device__ __forceinline__ float operator()(float v, int, float s_n,
                                              float b_n) const {
    return v * s_n + b_n;
  }
};

// grid: (N / TN, ksplit, ceil(M / 64)); LN: the LayerNorm in the prologue
template <int MT, bool LN>
__global__ void __launch_bounds__(THREADS)
    qgemv_gemm_bf16(const __nv_bfloat16* __restrict__ x, int M, int K, int N,
                    const int8_t* __restrict__ w, const float* __restrict__ s,
                    const float* __restrict__ bias,
                    const float* __restrict__ gamma,
                    const float* __restrict__ beta, int kc,
                    float* __restrict__ partial, int* __restrict__ counters,
                    __nv_bfloat16* __restrict__ out) {
  using small_m::AKind;
  if constexpr (LN)
    small_m::gemm_body<AKind::BF16, MT>(
        M, N, w, s, bias, kc, partial, counters, out,
        small_m::LnBf16A{x, K, gamma, beta}, Epi{});
  else
    small_m::gemm_body<AKind::BF16, MT>(M, N, w, s, bias, kc, partial,
                                        counters, out,
                                        small_m::CopyA<2>{x, K}, Epi{});
}

inline size_t f32_smem(int mb, int kc) {
  const size_t main = (size_t)mb * kc * 4 + (size_t)STAGES * STAGE_BYTES;
  const size_t tail = (size_t)4 * mb * TN * 4 + (size_t)mb * CT_STRIDE * 4;
  return main > tail ? main : tail;
}

// grid: (N / TN, ksplit, ceil(M / MB)).  Thread (warp, lane) owns columns
// 4 lane .. 4 lane + 3 of the tile and the stage rows warp, warp + 4, ...
template <int MB>
__global__ void __launch_bounds__(THREADS)
    qgemv_gemm_f32(const float* __restrict__ x, int M, int K, int N,
                   const int8_t* __restrict__ w, const float* __restrict__ s,
                   const float* __restrict__ bias, int kc,
                   float* __restrict__ partial, int* __restrict__ counters,
                   float* __restrict__ out) {
  extern __shared__ __align__(128) uint8_t smem[];
  float* xs = reinterpret_cast<float*>(smem);            // (MB, kc)
  uint8_t* ring = smem + (size_t)MB * kc * 4;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * TN, kbase = blockIdx.y * kc;
  const int row0 = blockIdx.z * MB;
  const int rows = min(MB, M - row0);
  const int nst = kc / KSTG;
  __shared__ __align__(16) float cols[2 * TN];

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nst)
      small_m::load_stage<2>(ring + st * STAGE_BYTES, w, N, kbase, n0, st);
    if (st == 0) {
      small_m::copy_cols(cols, s, bias, n0);
      const int chunks = kc / 4;
      for (int i = tid; i < MB * chunks; i += THREADS) {
        const int m = i / chunks, c = i % chunks;
        const bool in = m < rows;
        small_m::cp_async16(
            xs + m * kc + c * 4,
            x + (long long)(row0 + (in ? m : 0)) * K + kbase + c * 4,
            in ? 16 : 0);
      }
    }
    small_m::cp_async_commit();
  }

  float acc[MB][4];
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

  for (int st = 0; st < nst; ++st) {
    small_m::cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (st + STAGES - 1 < nst)
      small_m::load_stage<2>(
          ring + ((st + STAGES - 1) % STAGES) * STAGE_BYTES, w, N, kbase, n0,
          st + STAGES - 1);
    small_m::cp_async_commit();
    const uint8_t* sb = ring + (st % STAGES) * STAGE_BYTES;
#pragma unroll 2
    for (int r = warp; r < KSTG; r += THREADS / 32) {
      const uint32_t wd = small_m::w_word<2>(sb, r, lane) ^ 0x80808080u;
      float wf[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) wf[j] = small_m::i8_at(wd, j);
      const float* xk = xs + st * KSTG + r;
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        const float xv = xk[m * kc];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[m][j] = fmaf(xv, wf[j], acc[m][j]);
      }
    }
  }
  small_m::cp_async_wait<0>();
  __syncthreads();   // the ring and xs are free

  float* red = reinterpret_cast<float*>(smem);           // (4, MB, TN)
  float* ctile = red + 4 * MB * TN;                      // (MB, CT_STRIDE)
#pragma unroll
  for (int m = 0; m < MB; ++m)
    *reinterpret_cast<float4*>(red + (warp * MB + m) * TN + 4 * lane) =
        make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  __syncthreads();
  for (int i = tid; i < MB * TN; i += THREADS) {
    const int m = i / TN, c = i % TN;
    ctile[m * CT_STRIDE + c] = ((red[m * TN + c] + red[(MB + m) * TN + c]) +
                                red[(2 * MB + m) * TN + c]) +
                               red[(3 * MB + m) * TN + c];
  }
  __syncthreads();
  small_m::finish_tile<float, float>(
      ctile, rows, row0, M, N, n0, partial,
      counters + blockIdx.z * gridDim.x + blockIdx.x, cols, out, Epi{});
}

template <int MT, bool LN>
int launch_bf16(const __nv_bfloat16* x, int M, int K, int N, const int8_t* w,
                const float* s, const float* b, const float* g,
                const float* be, int ks, float* partial, int* counters,
                __nv_bfloat16* out, cudaStream_t st) {
  const int kc = K / ks;
  const size_t smem = small_m::smem_bytes<small_m::AKind::BF16>(MT, kc);
  const int rc = small_m::allow_smem(qgemv_gemm_bf16<MT, LN>, smem);
  if (rc != 0) return rc;
  const dim3 grid(N / TN, ks, (M + 63) / 64);
  qgemv_gemm_bf16<MT, LN><<<grid, THREADS, smem, st>>>(
      x, M, K, N, w, s, b, g, be, kc, partial, counters, out);
  return static_cast<int>(cudaGetLastError());
}

template <int MB>
int launch_f32(const float* x, int M, int K, int N, const int8_t* w,
               const float* s, const float* b, int ks, float* partial,
               int* counters, float* out, cudaStream_t st) {
  const int kc = K / ks;
  const size_t smem = f32_smem(MB, kc);
  const int rc = small_m::allow_smem(qgemv_gemm_f32<MB>, smem);
  if (rc != 0) return rc;
  const dim3 grid(N / TN, ks, (M + MB - 1) / MB);
  qgemv_gemm_f32<MB><<<grid, THREADS, smem, st>>>(x, M, K, N, w, s, b, kc,
                                                  partial, counters, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int ln_rows(const T* x, int M, int K, const float* g, const float* be,
            T* xn, cudaStream_t st) {
  qgemv_ln_rows<T><<<M, LN_THREADS, 0, st>>>(x, K, g, be, xn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and out).  x, xn and out rows and
// w: 16-byte aligned; N % 128 == 0; ksplit divides K into slices of a
// multiple of 32 rows.  bias, gamma, beta may be null (gamma and beta
// together).  With gamma: ln_fused = 1 (bf16, M <= 16) applies the LN
// inside the GEMM; otherwise the row kernel writes LN(x) into xn, (M, K)
// in x's type.  Above one slice, partial is (ksplit, M, N) fp32 scratch and
// counters holds ceil(M / rows a block) x N / 128 zeros, which the kernel
// leaves at zero.
extern "C" int tts_qgemv(const void* x, int M, int K, int N, const void* w,
                         const void* s, const void* bias, const void* gamma,
                         const void* beta, int ksplit, int ln_fused, void* xn,
                         void* partial, void* counters, void* out, int dtype,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(s);
  const float* bi = static_cast<const float*>(bias);
  const float* g = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  float* pa = static_cast<float*>(partial);
  int* cn = static_cast<int*>(counters);
  if (dtype == 1) {
    using bf = __nv_bfloat16;
    const bf* a = static_cast<const bf*>(x);
    bf* o = static_cast<bf*>(out);
    if (g != nullptr && ln_fused) {
      if (M > 16) return static_cast<int>(cudaErrorInvalidValue);
      return launch_bf16<1, true>(a, M, K, N, wq, sc, bi, g, be, ksplit, pa,
                                  cn, o, st);
    }
    if (g != nullptr) {
      const int rc = ln_rows(a, M, K, g, be, static_cast<bf*>(xn), st);
      if (rc != 0) return rc;
      a = static_cast<const bf*>(xn);
    }
    const int mt = ((M >= 64 ? 64 : M) + 15) / 16;
    if (mt == 1)
      return launch_bf16<1, false>(a, M, K, N, wq, sc, bi, g, be, ksplit, pa,
                                   cn, o, st);
    if (mt == 2)
      return launch_bf16<2, false>(a, M, K, N, wq, sc, bi, g, be, ksplit, pa,
                                   cn, o, st);
    if (mt == 3)
      return launch_bf16<3, false>(a, M, K, N, wq, sc, bi, g, be, ksplit, pa,
                                   cn, o, st);
    return launch_bf16<4, false>(a, M, K, N, wq, sc, bi, g, be, ksplit, pa,
                                 cn, o, st);
  }
  const float* a = static_cast<const float*>(x);
  if (g != nullptr) {
    const int rc = ln_rows(a, M, K, g, be, static_cast<float*>(xn), st);
    if (rc != 0) return rc;
    a = static_cast<const float*>(xn);
  }
  float* o = static_cast<float*>(out);
  if (M == 1)
    return launch_f32<1>(a, M, K, N, wq, sc, bi, ksplit, pa, cn, o, st);
  if (M <= 4)
    return launch_f32<4>(a, M, K, N, wq, sc, bi, ksplit, pa, cn, o, st);
  return launch_f32<F32_ROWS>(a, M, K, N, wq, sc, bi, ksplit, pa, cn, o, st);
}
