// K7: BigVGAN's anti-aliased Snake activation in one pass:
//     2x upsample (12-tap kaiser FIR) -> snake -> 2x downsample.
//
// Replaces the TPU kernel tortoise_tts_tpu/ops/pallas_snake.py
// snake_resample2 (_snake_kernel_mxu / _snake_kernel).  Per row r of the
// (B*C, T) input, with f the 12 taps of kaiser_sinc_filter(0.25, 0.3, 12)
// and x read with its index clamped to [0, T) (the reference's edge pad):
//     E[u] = 2 (f1 x[u+2] + f3 x[u+1] + f5 x[u] + f7 x[u-1] + f9 x[u-2]
//               + f11 x[u-3])                      (even upsampled samples)
//     O[u] = 2 (f0 x[u+3] + f2 x[u+2] + f4 x[u+1] + f6 x[u] + f8 x[u-1]
//               + f10 x[u-2])                      (odd upsampled samples)
//     s(v) = v + inv_beta[c] sin^2(alpha[c] v),   v[2u] = s(E[u]),
//                                                 v[2u+1] = s(O[u])
//     y[t] = sum_i f[i] v[clamp(2t + i - 5, 0, 2T - 1)]
// The clamped form of the last sum is the reference's edge pad of the
// interleaved stream, so the three edge columns on each side need none of
// the TPU kernel's patch blocks.
//
// Bound on an H100: one read and one write of (B, C, T) (11.1 MB in bf16
// at 768 x 3624 and 24 x 231936) against about 60 flops and two sines per
// input sample, so it is bound by bytes: about 3.3 us per call.
//
// Design: one block per (row, tile of 1024 outputs), 256 threads.  The
// tile's input with a halo of 6 on each side is staged in shared memory
// as fp32; each thread computes E and O for its samples (halo of 3 on
// each side) and applies snake with sinf (not __sinf, whose error grows
// with |alpha v|), the 2T stream v stays in shared memory, and each
// thread then sums the 12 down taps for its outputs and rounds once to
// the storage type.  FIR taps and snake run in fp32 for every storage
// type, as the TPU kernel's do.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TT = 1024;       // outputs per block
constexpr int THREADS = 256;
constexpr int HALO = 6;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    snake_resample2(const T* __restrict__ x, const float* __restrict__ alpha,
                    const float* __restrict__ inv_beta,
                    const float* __restrict__ taps, T* __restrict__ y, int C,
                    int T_len) {
  __shared__ float f[12];
  __shared__ float xs[TT + 2 * HALO];        // x[t0 - 6 + i], clamped
  __shared__ float v[2 * (TT + HALO)];       // v[2 (t0 - 3) + j]
  const long long row = blockIdx.x;
  const int t0 = blockIdx.y * TT;
  const T* xr = x + row * T_len;
  T* yr = y + row * T_len;
  const float a = alpha[row % C], ib = inv_beta[row % C];

  if (threadIdx.x < 12) f[threadIdx.x] = taps[threadIdx.x];
  for (int i = threadIdx.x; i < TT + 2 * HALO; i += THREADS) {
    const int u = min(max(t0 - HALO + i, 0), T_len - 1);
    xs[i] = to_f(xr[u]);
  }
  __syncthreads();
  // E, O at u = t0 - 3 + i; x[u + s] is xs[i + 3 + s]
  for (int i = threadIdx.x; i < TT + HALO; i += THREADS) {
    const float* p = xs + i + 3;
    const float e = 2.f * (f[1] * p[2] + f[3] * p[1] + f[5] * p[0] +
                           f[7] * p[-1] + f[9] * p[-2] + f[11] * p[-3]);
    const float o = 2.f * (f[0] * p[3] + f[2] * p[2] + f[4] * p[1] +
                           f[6] * p[0] + f[8] * p[-1] + f[10] * p[-2]);
    const float se = sinf(a * e), so = sinf(a * o);
    v[2 * i] = e + ib * (se * se);
    v[2 * i + 1] = o + ib * (so * so);
  }
  __syncthreads();
  const int vbase = 2 * (t0 - 3);
  for (int n = threadIdx.x; n < TT; n += THREADS) {
    const int t = t0 + n;
    if (t >= T_len) break;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      const int j = min(max(2 * t + i - 5, 0), 2 * T_len - 1);
      acc = fmaf(f[i], v[j - vbase], acc);
    }
    store(yr + t, acc);
  }
}

}  // namespace

// x, y: (rows, T) contiguous, row r is channel r % C; alpha, inv_beta: (C)
// fp32 (alpha already exp'd for logscale, inv_beta = 1 / (beta + 1e-9));
// taps: 12 fp32 on the device.  dtype: 0 = float32, 1 = bfloat16.
extern "C" int tts_snake_resample2(const void* x, const float* alpha,
                                   const float* inv_beta, const float* taps,
                                   void* y, int rows, int C, int T,
                                   int dtype, void* stream) {
  dim3 grid(rows, (T + TT - 1) / TT);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    snake_resample2<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), alpha, inv_beta, taps,
        static_cast<__nv_bfloat16*>(y), C, T);
  else
    snake_resample2<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(x), alpha, inv_beta, taps,
        static_cast<float*>(y), C, T);
  return static_cast<int>(cudaGetLastError());
}
