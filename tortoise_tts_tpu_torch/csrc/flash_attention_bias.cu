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
// Design: one block of 4 warps per (batch, 64-query tile, head), with the
// batch innermost in the grid so the blocks that read one bias tile run
// together and the tile stays in L2.  q, k and v tiles (64 channels x 64
// times) are copied straight from the channels-major layout, where T is
// contiguous: coalesced 16-byte loads when T is a multiple of 8, no split
// and no transpose.  For each 64-key tile: S = q^T k by WMMA 16x16x16
// (bf16 in, fp32 out; q^T is a column-major A, k a row-major B) into
// shared memory; each warp owns 16 query rows and each pair of lanes one
// row, 32 keys a lane, so the online softmax (scale, bias read row-major
// from (H, T, T), running max and sum) runs in registers with one shuffle
// per reduction.  P, rounded to the input type, goes to shared memory; P v
// by WMMA (v^T is a column-major B of the staged v tile) lands in shared
// memory and each thread folds its 32 outputs into registers after the
// rescale.  Keys at or past T score -inf and take no weight, so any T
// works unpadded (the TPU kernel padded T to a multiple of 128).  The
// output tile is staged through shared memory and written channels-major
// with coalesced stores.  fp32 inputs (the reference runs) use CUDA-core
// FMAs for the two products.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int D = 64;         // head dim
constexpr int BT = 64;        // queries per block and keys per tile
constexpr int THREADS = 128;  // 4 warps x 16 query rows
constexpr int LDT = BT + 8;   // row stride of the staged tiles (elements)
constexpr int LDS = BT + 4;   // row stride of the fp32 score tile

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

template <typename T>
constexpr size_t smem_bytes() {
  // q, k, v and p tiles in T, then the fp32 score tile
  return 4 * (size_t)BT * LDT * sizeof(T) + (size_t)BT * LDS * sizeof(float);
}

// dst[c][j] = src[c * Tn + t0 + j] for 64 channels and 64 times; zero past
// Tn.  vec: Tn is a multiple of 16 bytes' worth of elements and src is
// 16-byte aligned, so whole vectors are in range or out of it.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src,
                                          int Tn, int t0, bool vec) {
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    for (int idx = threadIdx.x; idx < D * (BT / V); idx += THREADS) {
      const int c = idx / (BT / V), j = (idx % (BT / V)) * V;
      int4 v = make_int4(0, 0, 0, 0);
      if (t0 + j < Tn)
        v = *reinterpret_cast<const int4*>(src + (long long)c * Tn + t0 + j);
      *reinterpret_cast<int4*>(dst + c * LDT + j) = v;
    }
  } else {
    for (int idx = threadIdx.x; idx < D * BT; idx += THREADS) {
      const int c = idx / BT, j = idx % BT;
      dst[c * LDT + j] = t0 + j < Tn ? src[(long long)c * Tn + t0 + j]
                                     : from_f<T>(0.f);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    attn_bias(const T* __restrict__ qkv, const T* __restrict__ bias,
              T* __restrict__ out, int H, int Tn, float scale, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);   // [c][t]
  T* Ks = Qs + BT * LDT;                // [c][key]
  T* Vs = Ks + BT * LDT;                // [c][key]
  T* Ps = Vs + BT * LDT;                // [query][key]
  float* Ss = reinterpret_cast<float*>(Ps + BT * LDT);  // [query][key]

  const int b = blockIdx.x, q0 = blockIdx.y * BT, h = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = warp * 16 + lane / 2;   // this thread's query row
  const int c0 = (lane % 2) * 32;       // and its 32 keys / channels
  const T* base = qkv + ((long long)(b * H + h) * 3 * D) * Tn;
  const T* kp = base + (long long)D * Tn;
  const T* vp = base + 2LL * D * Tn;
  const bool row_ok = q0 + r < Tn;
  const T* brow = bias + ((long long)h * Tn + (row_ok ? q0 + r : 0)) * Tn;

  load_tile(Qs, base, Tn, q0, vec);
  float m = -INFINITY, l = 0.f, o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;

  for (int k0 = 0; k0 < Tn; k0 += BT) {
    __syncthreads();   // the previous tile's K, V and P are consumed
    load_tile(Ks, kp, Tn, k0, vec);
    load_tile(Vs, vp, Tn, k0, vec);
    __syncthreads();

    float s[32];
    if constexpr (sizeof(T) == 2) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> a;
        wmma::load_matrix_sync(
            a, reinterpret_cast<const __nv_bfloat16*>(Qs) + kk * LDT +
                   warp * 16, LDT);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> bf;
          wmma::load_matrix_sync(
              bf, reinterpret_cast<const __nv_bfloat16*>(Ks) + kk * LDT +
                      j * 16, LDT);
          wmma::mma_sync(acc[j], a, bf, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::store_matrix_sync(Ss + warp * 16 * LDS + j * 16, acc[j], LDS,
                                wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] = Ss[r * LDS + c0 + j];
    } else {
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] = 0.f;
      for (int c = 0; c < D; ++c) {
        const float qv = to_f(Qs[c * LDT + r]);
#pragma unroll
        for (int j = 0; j < 32; ++j)
          s[j] = fmaf(qv, to_f(Ks[c * LDT + c0 + j]), s[j]);
      }
    }

    // scale, bias, online softmax over this tile's 64 keys
    float bv[32];
    if (vec && row_ok && k0 + c0 + 32 <= Tn) {
      constexpr int V = 16 / sizeof(T);
      __align__(16) T tmp[32];
#pragma unroll
      for (int v = 0; v < 32 / V; ++v)
        reinterpret_cast<int4*>(tmp)[v] =
            reinterpret_cast<const int4*>(brow + k0 + c0)[v];
#pragma unroll
      for (int j = 0; j < 32; ++j) bv[j] = to_f(tmp[j]);
    } else {
#pragma unroll
      for (int j = 0; j < 32; ++j)
        bv[j] = row_ok && k0 + c0 + j < Tn ? to_f(brow[k0 + c0 + j]) : 0.f;
    }
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      if (k0 + c0 + j < Tn) {
        s[j] = s[j] * scale + bv[j];
        mx = fmaxf(mx, s[j]);
      } else {
        s[j] = -INFINITY;
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float mn = fmaxf(m, mx);      // finite: key k0 < Tn is valid
    const float alpha = expf(m - mn);   // 0 while m is -inf
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const T p = from_f<T>(expf(s[j] - mn));
      ps += to_f(p);
      Ps[r * LDT + c0 + j] = p;
    }
    ps += __shfl_xor_sync(0xffffffffu, ps, 1);
    l = l * alpha + ps;
    m = mn;
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] *= alpha;
    __syncwarp();   // the warp's 16 P rows are complete

    if constexpr (sizeof(T) == 2) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
      for (int kk = 0; kk < BT; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::load_matrix_sync(
            a, reinterpret_cast<const __nv_bfloat16*>(Ps) + warp * 16 * LDT +
                   kk, LDT);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major> bf;
          wmma::load_matrix_sync(
              bf, reinterpret_cast<const __nv_bfloat16*>(Vs) + j * 16 * LDT +
                      kk, LDT);
          wmma::mma_sync(acc[j], a, bf, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::store_matrix_sync(Ss + warp * 16 * LDS + j * 16, acc[j], LDS,
                                wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] += Ss[r * LDS + c0 + i];
    } else {
      for (int j = 0; j < BT; ++j) {
        const float p = to_f(Ps[r * LDT + j]);
#pragma unroll
        for (int i = 0; i < 32; ++i)
          o[i] = fmaf(p, to_f(Vs[(c0 + i) * LDT + j]), o[i]);
      }
    }
  }

  // o / l, staged channels-major in the q tile, then coalesced stores
  __syncthreads();
  const float inv = 1.f / l;
#pragma unroll
  for (int i = 0; i < 32; ++i) Qs[(c0 + i) * LDT + r] = from_f<T>(o[i] * inv);
  __syncthreads();
  T* ob = out + ((long long)(b * H + h) * D) * Tn;
  for (int idx = threadIdx.x; idx < D * BT; idx += THREADS) {
    const int c = idx / BT, j = idx % BT;
    if (q0 + j < Tn) ob[(long long)c * Tn + q0 + j] = Qs[c * LDT + j];
  }
}

template <typename T>
int run(const void* qkv, const void* bias, void* out, int B, int H, int Tn,
        float scale, int vec, cudaStream_t st) {
  constexpr size_t bytes = smem_bytes<T>();
  cudaError_t e = cudaFuncSetAttribute(
      attn_bias<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(B, (Tn + BT - 1) / BT, H);
  attn_bias<T><<<grid, THREADS, bytes, st>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(bias),
      static_cast<T*>(out), H, Tn, scale, vec);
  return static_cast<int>(cudaGetLastError());
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
