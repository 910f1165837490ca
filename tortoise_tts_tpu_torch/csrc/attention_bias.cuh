// Shared device code of the denoiser's biased attention kernels: K6
// (flash_attention_bias.cu), K9a (flash_attention_bias_kq.cu) and K9b
// (flash_attention_bias_cm.cu).  Each of those sources includes this header
// and builds into its own library, with its own __global__ kernel and C
// entry point.
//
// One block of 4 warps computes one (batch, head, 64-query tile):
//     o = softmax(q^T k / sqrt(64) + bias) v
// with q, k and v channels-major (64 channels x T, T contiguous) at any base
// pointer, so a fused (B, H*3*64, T) qkv, or three split (B, H, 64, T)
// tensors, are read in place.  For each 64-key tile: S = q^T k by WMMA
// 16x16x16 (bf16 in, fp32 out; q^T is a column-major A, k a row-major B)
// into shared memory; each warp owns 16 query rows and each pair of lanes
// one row, 32 keys a lane, so the online softmax (scale, bias, running max
// and sum) runs in registers with one shuffle per reduction.  P, rounded to
// the input type, goes to shared memory; P v by WMMA (v^T is a column-major
// B of the staged v tile) lands in shared memory and each thread folds its
// 32 outputs into registers after the rescale.  Keys at or past T score
// -inf and take no weight, so any T works unpadded.  The output tile is
// staged through shared memory and written channels-major with coalesced
// stores.  fp32 inputs (the reference runs) use CUDA-core FMAs for the two
// products.
//
// The bias of head h is one (T, T) matrix, in either orientation:
// - BIAS_T false: (query, key), row-major.  A thread's 32 keys of its row
//   are contiguous and are read straight from device memory.
// - BIAS_T true: (key, query), the transposed bias of K9a.  A row of the
//   matrix is one key's bias for every query, so the 64 x 64 tile is copied
//   along the query axis (coalesced 16-byte loads and stores) into shared
//   memory, and each thread reads its row down the tile's columns: the
//   transpose happens in the read.  Rows keep K6's padded stride, and keys
//   32..63 sit 16 elements further along their rows, so the 16 lanes that
//   read keys 0..31 and the 16 that read keys 32..63 hit disjoint banks and
//   the transposed read has no bank conflict.
#pragma once

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
constexpr int BSKEW = 16;     // extra offset of keys 32..63 in the
                              // transposed bias tile (elements)

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

__device__ __forceinline__ int bias_t_index(int key, int query) {
  return key * LDT + query + (key >= 32 ? BSKEW : 0);
}

template <typename T, bool BIAS_T>
constexpr size_t attn_smem_bytes() {
  // q, k, v and p tiles in T, then the fp32 score tile, then (BIAS_T) the
  // transposed bias tile in T
  return 4 * (size_t)BT * LDT * sizeof(T) + (size_t)BT * LDS * sizeof(float) +
         (BIAS_T ? ((size_t)BT * LDT + BSKEW) * sizeof(T) : 0);
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

// Bs[key][query] (skewed) = bias_t[k0 + key][q0 + query], zero past Tn on
// either axis.  Rows of bias_t run along the query axis.  vec: as for
// load_tile; a row's 64 elements then start 16-byte aligned in both places.
template <typename T>
__device__ __forceinline__ void load_bias_t_tile(
    T* Bs, const T* __restrict__ bias_t, int Tn, int k0, int q0, bool vec) {
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    for (int idx = threadIdx.x; idx < BT * (BT / V); idx += THREADS) {
      const int key = idx / (BT / V), j = (idx % (BT / V)) * V;
      int4 v = make_int4(0, 0, 0, 0);
      if (k0 + key < Tn && q0 + j < Tn)
        v = *reinterpret_cast<const int4*>(
            bias_t + (long long)(k0 + key) * Tn + q0 + j);
      *reinterpret_cast<int4*>(Bs + bias_t_index(key, j)) = v;
    }
  } else {
    for (int idx = threadIdx.x; idx < BT * BT; idx += THREADS) {
      const int key = idx / BT, j = idx % BT;
      Bs[bias_t_index(key, j)] =
          k0 + key < Tn && q0 + j < Tn
              ? bias_t[(long long)(k0 + key) * Tn + q0 + j]
              : from_f<T>(0.f);
    }
  }
}

// One (batch, head, 64-query tile) of biased attention, the block at
// (blockIdx.x, blockIdx.y, blockIdx.z) = (batch, tile, head) of
// launch_attn's grid.  qp, kp, vp: this (batch, head)'s q, k and v, each 64
// channels x Tn; bias: this head's (Tn, Tn) bias, (query, key) or with
// BIAS_T (key, query); out: the whole (B, H*64, Tn) output, whose (batch,
// head) offset is computed after the key loop, so no pointer stays live
// across it.  vec: Tn is a multiple of 16 bytes' worth of elements and
// every pointer is 16-byte aligned; an int, as K6's kernel took it: as a
// bool it cost the bf16 kernel a register spill and 2-4% of its time on an
// H100.
template <typename T, bool BIAS_T>
__device__ __forceinline__ void attn_bias_block(
    const T* __restrict__ qp, const T* __restrict__ kp,
    const T* __restrict__ vp, const T* __restrict__ bias,
    T* __restrict__ out, int Tn, float scale, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);   // [c][t]
  T* Ks = Qs + BT * LDT;                // [c][key]
  T* Vs = Ks + BT * LDT;                // [c][key]
  T* Ps = Vs + BT * LDT;                // [query][key]
  float* Ss = reinterpret_cast<float*>(Ps + BT * LDT);  // [query][key]
  T* Bs = reinterpret_cast<T*>(Ss + BT * LDS);  // BIAS_T: [key][query]

  const int q0 = blockIdx.y * BT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = warp * 16 + lane / 2;   // this thread's query row
  const int c0 = (lane % 2) * 32;       // and its 32 keys / channels
  const bool row_ok = q0 + r < Tn;
  const T* brow = bias + (long long)(row_ok ? q0 + r : 0) * Tn;

  load_tile(Qs, qp, Tn, q0, vec);
  float m = -INFINITY, l = 0.f, o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;

  for (int k0 = 0; k0 < Tn; k0 += BT) {
    __syncthreads();   // the previous tile's K, V, P (and bias) are consumed
    load_tile(Ks, kp, Tn, k0, vec);
    load_tile(Vs, vp, Tn, k0, vec);
    if constexpr (BIAS_T) load_bias_t_tile(Bs, bias, Tn, k0, q0, vec);
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
    if constexpr (BIAS_T) {
#pragma unroll
      for (int j = 0; j < 32; ++j) bv[j] = to_f(Bs[bias_t_index(c0 + j, r)]);
    } else if (vec && row_ok && k0 + c0 + 32 <= Tn) {
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
  T* ob = out + ((long long)(blockIdx.x * gridDim.z + blockIdx.z) * D) * Tn;
  for (int idx = threadIdx.x; idx < D * BT; idx += THREADS) {
    const int c = idx / BT, j = idx % BT;
    if (q0 + j < Tn) ob[(long long)c * Tn + q0 + j] = Qs[c * LDT + j];
  }
}

// Sets the kernel's dynamic shared memory and launches it on (B, T tiles,
// H) blocks, batch innermost so the blocks that read one bias tile run
// together and the tile stays in L2.  Returns cudaGetLastError().
template <typename T, bool BIAS_T, typename Kernel, typename... Args>
int launch_attn(Kernel kernel, int B, int H, int Tn, cudaStream_t st,
                Args... args) {
  constexpr size_t bytes = attn_smem_bytes<T, BIAS_T>();
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(B, (Tn + BT - 1) / BT, H);
  kernel<<<grid, THREADS, bytes, st>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
