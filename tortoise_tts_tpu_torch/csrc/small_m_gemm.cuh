// Shared device code of K2 (csrc/qgemv.cu) and K8 (csrc/qgemv_w8a8.cu):
// a GEMM of a few activation rows (M <= 64 a block) against an int8
// weight stored (K, N), N-contiguous, that reads every weight byte once
// for all M rows and merges its split-K partials inside the kernel.
//
// Block: 128 threads (4 warps) own a tile of TN = 128 output columns and
// a slice of kc rows of K (split-K over grid.y) for up to 64 rows of
// activations (grid.z for more).  The weight slice streams through a ring
// of STAGES shared-memory buffers of KSTG = 32 rows x 128 bytes by
// cp.async 16-byte copies.  The block's activation slice is staged once,
// with its rows past M as zeros: copied beside the first stage, or (the
// fused forms at M <= 16: K2's LayerNorm, K8's quantizer) computed from x
// while the first stages are in flight.  The tile's scales and biases are
// fetched with the first stage, so the epilogue waits on no load.
//
// Tensor-core fragments straight from the (K, N) layout.  mma.sync's B
// operand ("col") wants 4 (s8) or 2 (bf16) consecutive k of one column in
// each 32-bit register; the weights hold 4 consecutive columns of one k in
// each 32-bit word.  So each n8 tile's column g stands for the physical
// column 4 g + j of the warp's 32 columns (j = 0..3 picks the tile): a
// thread reads word g of 4 (or 2) rows and one byte transpose gives the
// B registers of all four tiles.  The accumulator a thread holds for
// column 2 t + e of tile j is then physical column 8 t + 4 e + j: eight
// consecutive columns a row.  No second copy of the weights is needed.
//
// Bank conflicts: a warp reads one word column of 4 (s8) or 2 (bf16)
// row groups at once, and 128-byte rows put them all in one bank.  Each
// row's 16-byte chunks are XOR-swizzled by its row group, ((r >> RS) & 3)
// << 1, with RS = 2 for s8 (rows 4 t + i) and RS = 1 for bf16 (rows
// 2 t + i): the 32 lanes then hit 32 banks.  The activation rows are
// padded by 16 bytes for the same reason.
//
// Split-K merged in the kernel: with more than one K slice each block
// writes its (rows, 128) partial tile, and the last block of a column
// tile to arrive (an atomic counter per tile, in a zeroed workspace that
// the wrapper keeps per device and stream) adds the partials in slice
// order 0, 1, ..., applies the epilogue, writes the output and sets the
// counter back to zero.  Deterministic, and no merge kernel.  The wait
// for the arrival (partial store, fence, atomic, the last block's loads)
// is a chain of L2 round trips: with the launch and the first DRAM round
// trip it sets a floor of about 5 us a call on an H100 (chip_smoke's K2
// and K8 detail lines), 7-13x the bytes' bound at the decode's shapes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace small_m {

constexpr int THREADS = 128;   // 4 warps
constexpr int TN = 128;        // output columns a block
constexpr int KSTG = 32;       // weight rows a ring stage
constexpr int STAGES = 4;
constexpr int STAGE_BYTES = KSTG * TN;
constexpr int CT_STRIDE = TN + 4;   // floats a row of the staged result
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes = 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// byte offset of (row r, 16-byte chunk c) in a stage
template <int RS>
__device__ __forceinline__ int swz(int r, int c) {
  return r * TN + ((c ^ (((r >> RS) & 3) << 1)) << 4);
}

// the 32-bit word of weight columns 4 cw .. 4 cw + 3 of stage row r
template <int RS>
__device__ __forceinline__ uint32_t w_word(const uint8_t* stage, int r,
                                           int cw) {
  return *reinterpret_cast<const uint32_t*>(stage + swz<RS>(r, cw >> 2) +
                                            ((cw & 3) << 2));
}

// stage st of the block's K slice (rows k0 + 32 st ..) into buf
template <int RS>
__device__ __forceinline__ void load_stage(uint8_t* buf,
                                           const int8_t* __restrict__ w,
                                           int N, int k0, int n0, int st) {
#pragma unroll
  for (int i = threadIdx.x; i < KSTG * (TN / 16); i += THREADS) {
    const int r = i >> 3, c = i & 7;
    cp_async16(buf + swz<RS>(r, c),
               w + (long long)(k0 + st * KSTG + r) * N + n0 + c * 16);
  }
}

// --- tensor cores ----------------------------------------------------------

// D (16 x 8, s32) += A (16 x 32, s8, row) * B (32 x 8, s8, col)
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D (16 x 8, f32) += A (16 x 16, bf16, row) * B (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 4 x 4 byte transpose: out[j] byte i = u[i] byte j
__device__ __forceinline__ void transpose4(const uint32_t (&u)[4],
                                           uint32_t (&out)[4]) {
  const uint32_t x0 = __byte_perm(u[0], u[1], 0x5140);
  const uint32_t x1 = __byte_perm(u[0], u[1], 0x7362);
  const uint32_t y0 = __byte_perm(u[2], u[3], 0x5140);
  const uint32_t y1 = __byte_perm(u[2], u[3], 0x7362);
  out[0] = __byte_perm(x0, y0, 0x5410);
  out[1] = __byte_perm(x0, y0, 0x7632);
  out[2] = __byte_perm(x1, y1, 0x5410);
  out[3] = __byte_perm(x1, y1, 0x7632);
}

// byte j of a word XORed with 0x80808080 (the int8 offset by 128), as
// an exact float: 2^23 + u - (2^23 + 128)
__device__ __forceinline__ float i8_at(uint32_t biased, int j) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7440 | j)) -
         8388736.f;
}

// bf16x2 {lo: byte j of lo_word, hi: byte j of hi_word}, exactly (|v| <=
// 128 has no bits below a bf16's): the high halves of the two floats
__device__ __forceinline__ uint32_t i8x2_bf16(uint32_t lo_word,
                                              uint32_t hi_word, int j) {
  return __byte_perm(__float_as_uint(i8_at(lo_word, j)),
                     __float_as_uint(i8_at(hi_word, j)), 0x7632);
}

// --- the merge and the epilogue --------------------------------------------

template <typename Acc>
struct Vec4;
template <>
struct Vec4<float> {
  using type = float4;
};
template <>
struct Vec4<int> {
  using type = int4;
};

template <typename T>
__device__ __forceinline__ void store4(T* p, const float (&v)[4]);
template <>
__device__ __forceinline__ void store4<float>(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* p,
                                                      const float (&v)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// Where the block's result goes.  ctile: the block's (rows, TN) sums in
// shared memory, row stride CT_STRIDE; rows of the output from row0;
// partial: (ks, M, N) scratch; counter: this column tile's arrival count.
// cols: the tile's column scales and biases, (2, TN) in shared memory.
// epi(acc, row, s_n, b_n) -> float applies them.  Every thread of the
// block calls it after the barrier that completes ctile.
template <typename T, typename Acc, typename Epi>
__device__ __forceinline__ void finish_tile(const Acc* ctile, int rows,
                                            int row0, int M, int N, int n0,
                                            Acc* __restrict__ partial,
                                            int* __restrict__ counter,
                                            const float* cols,
                                            T* __restrict__ out, Epi epi) {
  using V = typename Vec4<Acc>::type;
  const int ks = gridDim.y, kz = blockIdx.y;
  const int items = rows * (TN / 4);
  if (ks > 1) {
    for (int i = threadIdx.x; i < items; i += THREADS) {
      const int m = i / (TN / 4), c = (i % (TN / 4)) * 4;
      const Acc* src = ctile + m * CT_STRIDE + c;
      *reinterpret_cast<V*>(partial +
                            ((long long)kz * M + row0 + m) * N + n0 + c) =
          V{src[0], src[1], src[2], src[3]};
    }
    __threadfence();
    __syncthreads();
    __shared__ int last;
    if (threadIdx.x == 0) last = atomicAdd(counter, 1) == ks - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
  }
  for (int i = threadIdx.x; i < items; i += THREADS) {
    const int m = i / (TN / 4), c = (i % (TN / 4)) * 4;
    Acc a[4];
    if (ks > 1) {
      a[0] = a[1] = a[2] = a[3] = 0;
      for (int z = 0; z < ks; ++z) {   // in slice order
        const V v = __ldcg(reinterpret_cast<const V*>(
            partial + ((long long)z * M + row0 + m) * N + n0 + c));
        a[0] += v.x;
        a[1] += v.y;
        a[2] += v.z;
        a[3] += v.w;
      }
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) a[q] = ctile[m * CT_STRIDE + c + q];
    }
    float y[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      y[q] = epi(a[q], m, cols[c + q], cols[TN + c + q]);
    store4<T>(out + (long long)(row0 + m) * N + n0 + c, y);
  }
  if (ks > 1 && threadIdx.x == 0) *counter = 0;   // ready for the next call
}

// the tile's column scales and biases (zeros without a bias) into cols,
// (2, TN) floats of shared memory, by cp.async
__device__ __forceinline__ void copy_cols(float* cols,
                                          const float* __restrict__ s,
                                          const float* __restrict__ bias,
                                          int n0) {
  const int tid = threadIdx.x;
  if (tid < 2 * TN / 4) {
    const int c = (tid % (TN / 4)) * 4;
    const bool is_s = tid < TN / 4;
    const bool have = is_s || bias != nullptr;
    cp_async16(cols + (is_s ? 0 : TN) + c, (is_s || !have ? s : bias) + n0 + c,
               have ? 16 : 0);
  }
}

// --- the tensor-core GEMM --------------------------------------------------

// The A operand's type: S8 (K8's codes) or BF16 (K2's activations).
enum class AKind { S8, BF16 };

template <AKind KIND>
struct Traits;
template <>
struct Traits<AKind::S8> {
  using Acc = int;
  static constexpr int ELT = 1;   // bytes an A element
  static constexpr int RS = 2;    // swizzle: rows 4 t + i
};
template <>
struct Traits<AKind::BF16> {
  using Acc = float;
  static constexpr int ELT = 2;
  static constexpr int RS = 1;    // rows 2 t + i
};

// bytes of dynamic shared memory for MT m16 tiles and a K slice of kc
template <AKind KIND>
__host__ __device__ constexpr int a_stride(int kc) {
  return kc * Traits<KIND>::ELT + 16;
}
template <AKind KIND>
inline size_t smem_bytes(int mt, int kc) {
  const size_t main = (size_t)mt * 16 * a_stride<KIND>(kc) +
                      (size_t)STAGES * STAGE_BYTES;
  const size_t tile = (size_t)mt * 16 * CT_STRIDE * 4;
  return main > tile ? main : tile;
}

// Where the block's A slice comes from: (a) copy() issues cp.async copies
// of ready rows (beside the first weight stage), or (b) compute() makes
// them from x with plain loads (after the weight stages are in flight).
// Both fill `rows16` rows of `as` (stride AS) for rows row0 .. of the
// output, K columns kbase .. kbase + kc - 1, with zeros past `rows`.
template <int ELT>
struct CopyA {
  const void* a;   // (M, K) elements of ELT bytes, 16-byte aligned rows
  int K;
  __device__ __forceinline__ void copy(uint8_t* as, int AS, int rows16,
                                       int row0, int rows, int kbase,
                                       int kc) const {
    const uint8_t* ab = static_cast<const uint8_t*>(a);
    const int chunks = kc * ELT / 16;
    for (int i = threadIdx.x; i < rows16 * chunks; i += THREADS) {
      const int m = i / chunks, c = i % chunks;
      const bool in = m < rows;
      cp_async16(as + m * AS + c * 16,
                 ab + ((long long)(row0 + (in ? m : 0)) * K + kbase) * ELT +
                     c * 16,
                 in ? 16 : 0);
    }
  }
  __device__ __forceinline__ void compute(uint8_t*, int, int, int, int, int,
                                          int) const {}
};

// Sum (or max) of v over a block of NT threads, the warps' results taken
// in warp order; every thread gets the result.  red: NT / 32 floats of
// shared scratch.
template <bool MAX, int NT = THREADS>
__device__ __forceinline__ float block_reduce(float v, float* red) {
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
  for (int i = 1; i < NT / 32; ++i) r = MAX ? fmaxf(r, red[i]) : r + red[i];
  return r;
}

// Sum (or max) of v over the warp; every lane gets the result.
template <bool MAX>
__device__ __forceinline__ float warp_reduce(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = MAX ? fmaxf(v, u) : v + u;
  }
  return v;
}

// 8 consecutive elements from 16-byte aligned p, as floats
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int q = 0; q < 8; ++q) v[q] = __bfloat162float(h[q]);
}

// The fp32 sums of x and x^2 over a row of K (a multiple of 8) elements,
// one warp: each lane adds its 8-element chunks in order, then the lanes'
// sums meet in a butterfly.
template <typename T>
__device__ __forceinline__ void row_sums(const T* xr, int K, float& s1,
                                         float& s2) {
  const int lane = threadIdx.x & 31;
  s1 = 0.f;
  s2 = 0.f;
  for (int k = lane * 8; k < K; k += 32 * 8) {
    float v[8];
    load8(xr + k, v);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      s1 += v[q];
      s2 = fmaf(v[q], v[q], s2);
    }
  }
  s1 = warp_reduce<false>(s1);
  s2 = warp_reduce<false>(s2);
}

// K2's LN(x) in the GEMM (M <= 16): each block takes its rows' statistics
// over the whole row (fp32, E[x^2] - mu^2, one warp a row, 16-byte loads)
// and stages LN(x) of its slice rounded to bf16.  The weight stages are in
// flight meanwhile.
struct LnBf16A {
  const __nv_bfloat16* x;
  int K;
  const float* gamma;
  const float* beta;
  __device__ __forceinline__ void copy(uint8_t*, int, int, int, int, int,
                                       int) const {}
  __device__ __forceinline__ void compute(uint8_t* as, int AS, int rows16,
                                          int row0, int rows, int kbase,
                                          int kc) const {
    __shared__ float mu_s[16], rstd_s[16];
    const int lane = threadIdx.x & 31;
    for (int m = threadIdx.x >> 5; m < rows; m += THREADS / 32) {
      float s1, s2;
      row_sums(x + (long long)(row0 + m) * K, K, s1, s2);
      if (lane == 0) {
        const float mu = s1 / K;
        mu_s[m] = mu;
        rstd_s[m] = rsqrtf(s2 / K - mu * mu + LN_EPS);
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < rows16 * (kc / 8); i += THREADS) {
      const int m = i / (kc / 8), kk = (i % (kc / 8)) * 8;
      __align__(16) __nv_bfloat16 y[8];
      if (m < rows) {
        float v[8];
        load8(x + (long long)(row0 + m) * K + kbase + kk, v);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int k = kbase + kk + q;
          y[q] = __float2bfloat16((v[q] - mu_s[m]) * rstd_s[m] * gamma[k] +
                                  beta[k]);
        }
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q) y[q] = __float2bfloat16(0.f);
      }
      *reinterpret_cast<uint4*>(as + m * AS + kk * 2) =
          *reinterpret_cast<const uint4*>(y);
    }
  }
};

// y = epi(A @ W) for rows row0 .. row0 + 16 MT - 1 (grid.z), columns
// n0 .. n0 + 127 (grid.x), K slice kbase .. kbase + kc - 1 (grid.y); the
// A slice from stage_a (CopyA, LnBf16A or K8's quantizer).
template <AKind KIND, int MT, typename T, typename StageA, typename Epi>
__device__ __forceinline__ void gemm_body(
    int M, int N, const int8_t* __restrict__ w, const float* __restrict__ s,
    const float* __restrict__ bias, int kc,
    typename Traits<KIND>::Acc* __restrict__ partial,
    int* __restrict__ counters, T* __restrict__ out, const StageA& stage_a,
    Epi epi) {
  using Tr = Traits<KIND>;
  using Acc = typename Tr::Acc;
  constexpr int RS = Tr::RS;
  extern __shared__ __align__(128) uint8_t smem[];
  const int AS = a_stride<KIND>(kc);
  uint8_t* as = smem;                                  // (16 MT, AS)
  uint8_t* ring = smem + MT * 16 * AS;                 // STAGES x 4 KB

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * TN, kbase = blockIdx.y * kc;
  const int row0 = blockIdx.z * 64;
  const int rows = min(MT * 16, M - row0);
  const int nst = kc / KSTG;
  // the tile's scales and biases, fetched now: the epilogue does not wait
  // on them
  __shared__ __align__(16) float cols[2 * TN];

  // the weight ring's first stages (the A copies and the column vectors
  // go with the first)
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nst) load_stage<RS>(ring + st * STAGE_BYTES, w, N, kbase, n0, st);
    if (st == 0) {
      stage_a.copy(as, AS, MT * 16, row0, rows, kbase, kc);
      copy_cols(cols, s, bias, n0);
    }
    cp_async_commit();
  }
  stage_a.compute(as, AS, MT * 16, row0, rows, kbase, kc);

  Acc acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][j][q] = 0;

  const int cw = warp * 8 + g;   // this lane's word column of the tile
  for (int st = 0; st < nst; ++st) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (st + STAGES - 1 < nst)
      load_stage<RS>(ring + ((st + STAGES - 1) % STAGES) * STAGE_BYTES, w, N,
                     kbase, n0, st + STAGES - 1);
    cp_async_commit();
    const uint8_t* sb = ring + (st % STAGES) * STAGE_BYTES;
    if constexpr (KIND == AKind::S8) {
      uint32_t u0[4], u1[4], b0[4], b1[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        u0[i] = w_word<RS>(sb, 4 * t + i, cw);
        u1[i] = w_word<RS>(sb, 16 + 4 * t + i, cw);
      }
      transpose4(u0, b0);
      transpose4(u1, b1);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint8_t* ar = as + (mt * 16 + g) * AS + st * KSTG + 4 * t;
        uint32_t af[4];
        af[0] = *reinterpret_cast<const uint32_t*>(ar);
        af[1] = *reinterpret_cast<const uint32_t*>(ar + 8 * AS);
        af[2] = *reinterpret_cast<const uint32_t*>(ar + 16);
        af[3] = *reinterpret_cast<const uint32_t*>(ar + 8 * AS + 16);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[mt][j], af, b0[j], b1[j]);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < KSTG / 16; ++kk) {
        const int r = kk * 16 + 2 * t;
        const uint32_t bias8 = 0x80808080u;
        const uint32_t w0 = w_word<RS>(sb, r, cw) ^ bias8;
        const uint32_t w1 = w_word<RS>(sb, r + 1, cw) ^ bias8;
        const uint32_t w8 = w_word<RS>(sb, r + 8, cw) ^ bias8;
        const uint32_t w9 = w_word<RS>(sb, r + 9, cw) ^ bias8;
        uint32_t b0[4], b1[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          b0[j] = i8x2_bf16(w0, w1, j);
          b1[j] = i8x2_bf16(w8, w9, j);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const uint8_t* ar =
              as + (mt * 16 + g) * AS + (st * KSTG + kk * 16 + 2 * t) * 2;
          uint32_t af[4];
          af[0] = *reinterpret_cast<const uint32_t*>(ar);
          af[1] = *reinterpret_cast<const uint32_t*>(ar + 8 * AS);
          af[2] = *reinterpret_cast<const uint32_t*>(ar + 16);
          af[3] = *reinterpret_cast<const uint32_t*>(ar + 8 * AS + 16);
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_bf16(acc[mt][j], af, b0[j], b1[j]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring and the A slice are free: stage the result

  Acc* ctile = reinterpret_cast<Acc*>(smem);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      Acc* dst = ctile + (mt * 16 + g + 8 * h) * CT_STRIDE + warp * 32 + 8 * t;
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int j = 0; j < 4; ++j) dst[4 * e + j] = acc[mt][j][2 * h + e];
    }
  __syncthreads();
  finish_tile<T, Acc>(ctile, rows, row0, M, N, n0, partial,
                      counters + blockIdx.z * gridDim.x + blockIdx.x, cols,
                      out, epi);
}

// let a kernel take `bytes` of dynamic shared memory (above 48 KB, static
// shared memory included, it must ask); a refusal is returned and
// cleared, so later launches see no error
template <typename Kern>
inline int allow_smem(Kern kernel, size_t bytes) {
  if (bytes <= 44 * 1024) return 0;
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (rc != cudaSuccess) cudaGetLastError();
  return static_cast<int>(rc);
}

}  // namespace small_m
