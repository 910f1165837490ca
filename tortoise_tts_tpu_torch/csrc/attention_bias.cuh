// Shared device code of the denoiser's biased attention kernels: K6
// (flash_attention_bias.cu), K9a (flash_attention_bias_kq.cu) and K9b
// (flash_attention_bias_cm.cu).  Each of those sources includes this header
// and builds into its own library, with its own __global__ kernels and C
// entry points.  All three compute
//     o[b, h] = softmax(q^T k / sqrt(64) + bias[h]) v
// with q, k and v channels-major (64 channels x T, T contiguous) at any base
// pointer and (batch, head) stride, so a fused (B, H*3*64, T) qkv, or three
// split (B, H, 64, T) tensors, are read in place; the output is (B, H*64,
// T).  The bias of head h is one (T, T) matrix, (query, key) row-major, or
// with BIAS_T transposed, (key, query) (K9a).
//
// bf16: attn_bias_tc_block<BIAS_T> (tensor cores).  A block of one
// warpgroup takes one (batch row, 64-query tile, head); four run an SM.
// Its first thread keeps a ring of STAGES key steps in flight on
// mbarriers: a step holds, for 64 keys, the bias, K and V tiles, each
// copied whole by TMA into shared memory with the 128-byte swizzle.  Where
// T's rows are not 16-byte aligned (the tests' T = 257 and 300) warp 0's
// element copies fill the same layout, and the rest is the same.
// Out-of-range rows and columns arrive as zeros either way.  A producer
// warp of its own left three blocks an SM and was no faster; blocks of two
// warpgroups, sharing a bias tile across two batch rows or a K/V pair
// across two query tiles, fit one an SM and were slower (PERF.md).
//
// The warpgroup holds Q^T's A slices in registers (ldmatrix.trans from
// the channels-major Q tile, once) and per 64-key step:
// - S = Q^T K by wgmma m64n64k16 (4 steps over the 64 channels), A from
//   registers, the channels-major K tile MN-major (the transpose bit);
// - the bias tile, meanwhile, by ldmatrix straight into S's accumulator
//   layout: an 8 x 8 ldmatrix block lands in the thread and element layout
//   of an m16n8 accumulator block, so the (query, key) tile is read by
//   ldmatrix and the (key, query) tile by ldmatrix.trans, at one cost;
// - the online softmax in registers, in the base-2 domain: x = s/8 + bias
//   is one FMA, p = 2^(x log2 e - m) another and an ex2; each accumulator
//   row is held by a quad of lanes, so a row max is two shuffles; the base
//   m moves (and O is rescaled) only when a row max passes it by 2^8;
// - O += P V^T by wgmma m64n72k16 with P, the S accumulators rounded to
//   bf16, as the register A operand (two n8 accumulator blocks are one k16
//   A slice) and the channels-major V tile K-major, followed in shared
//   memory by 8 rows of ones: the ninth n8 block of O is P's row sums.
// S, P and O never touch shared memory.  Keys at or past T score -inf and
// take no weight; queries past T are not stored.  At the end O / l is
// staged in the ring, channels-major, and written with coalesced 16-byte
// stores.  The warpgroups of the SM's four blocks overlap one's softmax
// with another's products.
//
// fp32 (the reference runs): attn_bias_f32_block<BIAS_T>, the same block
// (one warpgroup per (batch row, 64-query tile, head), 64-key steps, the
// online softmax in base 2 with the lazy base) on the tensor cores in
// 3xTF32: each fp32 operand x is split into hi = cvt.rna.tf32(x) with the
// 13 low bits cleared and lo = x - hi (exact), and each product sums
// lo hi + hi lo + hi hi in fp32 (lo lo, about 2^-22 of a term, dropped):
// fp32 accuracy, where one TF32 product would round every input to 11
// significant bits.  TF32 wgmma reads both shared operands K-major only,
// so the raw fp32 step (bias, K, V as copied, one stage) is rewritten each
// step into split operands: K transposed to key rows (K^T_hi, K^T_lo) for
// S = Q^T K, V's rows split with their keys reordered (V_hi, V_lo) for
// O += P V^T.  Both products run on wgmma m64n64k8, Q^T's and P's hi and
// lo in registers: P's A slice takes the accumulator's two columns of each
// 8-key group as its columns t4 and t4 + 4, so each V row holds its 8 keys
// in that order (0, 2, 4, 6, 1, 3, 5, 7).  The raw stage is free once
// split, and the next step's copy is in flight during the products.  Two
// blocks an SM overlap one's split and softmax with the other's products.
// Each step's P V^T is summed apart and added to O in fp32: the tensor
// cores' fp32 accumulation is not round-to-nearest, and a chain over
// every key would drift.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int D = 64;                  // head dim
constexpr int BT = 64;                 // queries a tile and keys a step
constexpr int TILE = BT * D * 2;       // one bf16 tile, 8 KB
constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

struct BiasArgs {
  const bf16* q;          // (batch, head) planes of 64 x T, bh_stride apart
  const bf16* k;
  const bf16* v;
  long long bh_stride;    // elements
  const bf16* bias;       // (H, T, T)
  bf16* out;              // (B, H*64, T)
  int B, H, T;
  float scale;
  int tma;      // 16-byte rows: tiles by TMA and 16-byte output stores
                // (else warp 0's element copies and element stores)
};

// The ring: STAGES key steps in shared memory.  A stage holds the bias
// tile, the K tile, then the V tile followed by ONES bytes of bf16 ones:
// rows 64-71 of the PV product's B operand, so its ninth n8 block of
// outputs is P's row sums.  The Q tile arrives in the last stage's bias
// slot before its first step and leaves it for registers; the output is
// staged in the first stage after the last step.
constexpr int STAGES = 2;
constexpr int ONES = 1024;
constexpr int K_OFF = TILE, V_OFF = 2 * TILE;
constexpr int STAGE = 3 * TILE + ONES;
constexpr int THREADS = 128;    // one consumer warpgroup, no producer warp
constexpr int MIN_BLOCKS = 4;   // blocks an SM: 128 registers a thread
// the ring, its barriers and 1024 bytes for the alignment
constexpr int SMEM = STAGES * STAGE + 16 * STAGES + 1024;

// byte offset of element (r, c) in a 64 x 64 bf16 tile of 128-byte rows
// with the 128-byte swizzle (16-byte chunk c / 8 of row r at chunk
// (c / 8) ^ (r % 8)), as TMA writes it
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * 128 + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t x) {
  return make_float2(__uint_as_float(x << 16),
                     __uint_as_float(x & 0xffff0000u));
}

// Warp 0's copy of one 64 x 64 tile into the swizzled layout, where TMA
// cannot describe the tensor: tile (r, c) = src[(r0 + r) * ld + c0 + c],
// zero where r0 + r >= rows or c0 + c >= cols.
__device__ __forceinline__ void copy_tile(unsigned char* dst,
                                          const bf16* __restrict__ src,
                                          long long ld, int r0, int rows,
                                          int c0, int cols, int lane) {
  for (int i = lane; i < BT * BT; i += 32) {
    const int r = i / BT, c = i % BT;
    bf16 x = __float2bfloat16(0.f);
    if (r0 + r < rows && c0 + c < cols) x = src[(r0 + r) * ld + c0 + c];
    *reinterpret_cast<bf16*>(dst + swz(r, c)) = x;
  }
}

// One key step's online softmax for a consumer thread (rows g and g + 8 of
// its warp's 16, keys 8j + 2 t4 + {0, 1}): x = s * scale + bias (keys at or
// past `kvalid` -inf where MASK), then P = 2^(x log2 e - m), rounded into
// the PV product's A slices pa.  The exponent base m moves only when a row's
// max passes it by more than 8 (log2 units), so P <= 2^8 and most steps
// move nothing; where a row's base moves, al0 / al1 is the factor its
// output must take (else 1).  Returns whether any row of the warp moved.
template <bool MASK>
__device__ __forceinline__ bool softmax_step(const float (&sc)[32],
                                             const uint32_t (&bv)[16],
                                             float scale, int kvalid, int t4,
                                             float& m0, float& m1,
                                             float& al0, float& al1,
                                             uint32_t (&pa)[4][4]) {
  float x[32];
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float2 bb = unpack_bf16(bv[4 * (j / 2) + 2 * (j % 2) + hh]);
      float x0 = fmaf(sc[4 * j + 2 * hh], scale, bb.x);
      float x1 = fmaf(sc[4 * j + 2 * hh + 1], scale, bb.y);
      if (MASK) {
        const int col = 8 * j + 2 * t4;
        if (col >= kvalid) x0 = -INFINITY;
        if (col + 1 >= kvalid) x1 = -INFINITY;
      }
      x[4 * j + 2 * hh] = x0;
      x[4 * j + 2 * hh + 1] = x1;
      if (hh == 0)
        mx0 = fmaxf(mx0, fmaxf(x0, x1));
      else
        mx1 = fmaxf(mx1, fmaxf(x0, x1));
    }
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  mx0 *= LOG2E;   // finite: the step's first key is valid
  mx1 *= LOG2E;
  const bool up0 = mx0 > m0 + 8.f, up1 = mx1 > m1 + 8.f;
  const bool moved = __any_sync(0xffffffffu, up0 || up1);
  const float n0 = up0 ? mx0 : m0, n1 = up1 ? mx1 : m1;
  al0 = ex2(m0 - n0);   // 1 where the base stays, 0 from -inf
  al1 = ex2(m1 - n1);
  m0 = n0;
  m1 = n1;
  const float nb0 = -m0, nb1 = -m1;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float p0 = ex2(fmaf(x[4 * j], LOG2E, nb0));
    const float p1 = ex2(fmaf(x[4 * j + 1], LOG2E, nb0));
    const float p2 = ex2(fmaf(x[4 * j + 2], LOG2E, nb1));
    const float p3 = ex2(fmaf(x[4 * j + 3], LOG2E, nb1));
    // accumulator block j = 2 kk + e is A slice kk's regs 2e, 2e + 1
    pa[j / 2][2 * (j % 2)] = pack_bf16(p0, p1);
    pa[j / 2][2 * (j % 2) + 1] = pack_bf16(p2, p3);
  }
  return moved;
}

// One block of the bf16 kernel: (blockIdx.x, blockIdx.y, blockIdx.z) =
// (batch row, 64-query tile, head), batch innermost so the blocks that read
// one bias tile run together.  qmap/kmap/vmap: (T, 64, B*H) views of q, k
// and v; bmap: (T, T, H) of the bias; each a box of 64 x 64 with the
// 128-byte swizzle (unused without a.tma).
template <bool BIAS_T>
__device__ __forceinline__ void attn_bias_tc_block(const CUtensorMap* qmap,
                                                   const CUtensorMap* kmap,
                                                   const CUtensorMap* vmap,
                                                   const CUtensorMap* bmap,
                                                   const BiasArgs& a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  unsigned char* gring = smem_raw + (ring - raw);
  const uint32_t full0 = ring + STAGES * STAGE, empty0 = full0 + 8 * STAGES;

  const int T = a.T, h = blockIdx.z, q0 = blockIdx.y * BT;
  const long long bh = (long long)blockIdx.x * a.H + h;
  const int nkt = (T + BT - 1) / BT;
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;

  for (int i = tid; i < STAGES * (ONES / 4); i += THREADS)
    reinterpret_cast<uint32_t*>(gring + (i / (ONES / 4)) * STAGE + V_OFF +
                                TILE)[i % (ONES / 4)] = 0x3f803f80u;
  fence_proxy_async();
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, a.tma ? 1 : 32);
      mbar_init(empty0 + 8 * s, 4);   // every warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  // Step j's bias, K and V tiles into stage j % STAGES (j = -1: the Q tile
  // into the last stage), arriving on its full barrier: by TMA, issued by
  // thread 0, or by warp 0's element copies.  The warpgroup fills its own
  // ring: a producer warp of its own left three blocks an SM.
  const bool filler = a.tma ? tid == 0 : w == 0;
  auto fill = [&](int j) {
    const int s = j < 0 ? STAGES - 1 : j % STAGES, k0 = j * BT;
    const uint32_t st = ring + s * STAGE, full = full0 + 8 * s;
    if (a.tma) {
      if (j < 0) {
        mbar_expect_tx(full, TILE);
        tma_load_3d(st, qmap, full, q0, 0, (int)bh);
        return;
      }
      mbar_expect_tx(full, 3 * TILE);
      if (BIAS_T)
        tma_load_3d(st, bmap, full, q0, k0, h);
      else
        tma_load_3d(st, bmap, full, k0, q0, h);
      tma_load_3d(st + K_OFF, kmap, full, k0, 0, (int)bh);
      tma_load_3d(st + V_OFF, vmap, full, k0, 0, (int)bh);
      return;
    }
    unsigned char* gs = gring + s * STAGE;
    const long long off = bh * a.bh_stride;
    if (j < 0) {
      copy_tile(gs, a.q + off, T, 0, D, q0, T, lane);
    } else {
      const bf16* bias_h = a.bias + (long long)h * T * T;
      if (BIAS_T)
        copy_tile(gs, bias_h, T, k0, T, q0, T, lane);
      else
        copy_tile(gs, bias_h, T, q0, T, k0, T, lane);
      copy_tile(gs + K_OFF, a.k + off, T, 0, D, k0, T, lane);
      copy_tile(gs + V_OFF, a.v + off, T, 0, D, k0, T, lane);
    }
    fence_proxy_async();
    mbar_arrive(full);
  };
  if (filler) {
    fill(-1);
    for (int j = 0; j < STAGES - 1 && j < nkt; ++j) fill(j);
  }

  // Q^T's A slices for the whole key loop, from the channels-major tile by
  // ldmatrix.trans: slice kk's matrix i = lane / 8 holds channels 16 kk +
  // 8 (i / 2) + 2 t4 + {0, 1} of query 16 w + 8 (i % 2) + g
  const int mi = lane / 8, mr = lane % 8;
  const uint32_t qs = ring + (STAGES - 1) * STAGE;
  wait_or_trap(full0 + 8 * (STAGES - 1), 0);
  uint32_t qf[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldsm_x4_t(qf[kk], qs + (16 * kk + 8 * (mi / 2) + mr) * 128 +
                          (((2 * w + mi % 2) ^ mr) << 4));
  __syncwarp();
  if (lane == 0) mbar_arrive(empty0 + 8 * (STAGES - 1));   // Q is in regs

  // O (64 x 64) in o[0..31], P's row sums (the ones block) in o[32..35]
  float o[36];
#pragma unroll
  for (int i = 0; i < 36; ++i) o[i] = 0.f;
  // the exponent base of rows g and g + 8, log2 units
  float m0 = -INFINITY, m1 = -INFINITY;
  // this thread's ldmatrix rows of the bias tile: x4 p holds accumulator
  // blocks (h = i % 2, j = 2p + i / 2), i = mi
  uint32_t boff[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int hh = mi % 2, j = 2 * p + mi / 2;
    boff[p] = BIAS_T   // rows: keys 8j + mr; chunk: queries 16w + 8hh
                  ? (8 * j + mr) * 128 + (((2 * w + hh) ^ mr) << 4)
                  // rows: queries 16w + 8hh + mr; chunk: keys 8j
                  : (16 * w + 8 * hh + mr) * 128 + ((j ^ mr) << 4);
  }

  // Step kt on stage s = kt % STAGES, the stage's use u (the last stage's
  // first use was Q): S = Q^T K on the tensor cores while the ring takes
  // step kt + STAGES - 1 into the stage step kt - 1 freed and the bias tile
  // is read; the softmax; then O += P V^T, and the stage is released when
  // both products are done.  The other blocks on the SM (four) fill the
  // tensor cores and the special function units while this one waits.
  // MASK: keys past T in this step.
  auto step = [&](int kt, int s, int u, auto mask) {
    constexpr bool MASK = decltype(mask)::value;
    const uint32_t st = ring + s * STAGE;
    wait_or_trap(full0 + 8 * s, u & 1);

    // descriptors: the k-th 16-deep slice 2048 k (K) and 32 k (V) bytes in
    const uint64_t dk = desc_sw128(st + K_OFF, 16, 1024);
    const uint64_t dv = desc_sw128(st + V_OFF, 16, 1024);
    float sc[32];
    wgmma_fence();
    wgmma_n64_rs_mn<false>(sc, qf[0], dk);
#pragma unroll
    for (int kk = 1; kk < 4; ++kk)
      wgmma_n64_rs_mn<true>(sc, qf[kk], dk + 128 * kk);
    wgmma_commit();

    const int j = kt + STAGES - 1;
    if (filler && j < nkt) {
      // its stage's previous use (step j - STAGES, or Q) is released
      const int sj = j % STAGES;
      wait_or_trap(empty0 + 8 * sj,
                   (j / STAGES + (sj == STAGES - 1) - 1) & 1);
      fill(j);
    }

    // the bias, in S's accumulator layout: bv[4p + i] = the pair of
    // accumulator block (h = i % 2, j = 2p + i / 2)
    uint32_t bv[16];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      uint32_t r[4];
      if (BIAS_T)
        ldsm_x4_t(r, st + boff[p]);
      else
        ldsm_x4(r, st + boff[p]);
#pragma unroll
      for (int i = 0; i < 4; ++i) bv[4 * p + i] = r[i];
    }
    wgmma_wait<0>();
    reg_fence(sc);

    uint32_t pa[4][4];
    float al0, al1;
    if (softmax_step<MASK>(sc, bv, a.scale, T - kt * BT, t4, m0, m1, al0,
                           al1, pa)) {
#pragma unroll
      for (int jj = 0; jj < 9; ++jj) {
        o[4 * jj] *= al0;
        o[4 * jj + 1] *= al0;
        o[4 * jj + 2] *= al1;
        o[4 * jj + 3] *= al1;
      }
    }

    reg_fence(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_n72_rs(o, pa[kk], dv + 2 * kk);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(o);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) reg_fence(pa[kk]);
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  };
  int s = 0, u = 0;
  for (int kt = 0; kt < nkt - 1; ++kt) {
    step(kt, s, u + (s == STAGES - 1), std::false_type());
    if (++s == STAGES) {
      s = 0;
      ++u;
    }
  }
  step(nkt - 1, s, u + (s == STAGES - 1), std::true_type());

  // o / l, staged channels-major in the first stage (every product and
  // copy of the ring is done), then coalesced stores
  const float i0 = 1.f / o[32], i1 = 1.f / o[34];
  const int r0 = 16 * w + g;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int ch = 8 * jj + 2 * t4 + e;
      *reinterpret_cast<bf16*>(gring + swz(ch, r0)) =
          __float2bfloat16(o[4 * jj + e] * i0);
      *reinterpret_cast<bf16*>(gring + swz(ch, r0 + 8)) =
          __float2bfloat16(o[4 * jj + 2 + e] * i1);
    }
  }
  __syncthreads();
  bf16* ob = a.out + bh * D * T;
  for (int i = tid; i < D * (BT / 8); i += THREADS) {
    const int ch = i / (BT / 8), c8 = (i % (BT / 8)) * 8, t = q0 + c8;
    if (t >= T) continue;
    const int4 v = *reinterpret_cast<const int4*>(gring + swz(ch, c8));
    bf16* dst = ob + (long long)ch * T + t;
    if (a.tma) {
      *reinterpret_cast<int4*>(dst) = v;
    } else {
      const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (t + k < T) dst[k] = e[k];
    }
  }
}

// The host half of a bf16 call: the four tensor maps where a.tma, then
// Kernel (the source's own __global__: its name tells the three kernels
// apart) on (B, T tiles, H) blocks of THREADS.  plan: the wrapper's launch
// plan (batch rows and query tiles a block, stages), which must be this
// kernel's; anything else is refused.
template <auto Kernel>
int launch_tc(const BiasArgs& a, int nb, int nq, int stages,
              cudaStream_t st) {
  if (nb != 1 || nq != 1 || stages != STAGES)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[4] = {};
  if (a.tma) {
    const uint64_t T = a.T, BH = (uint64_t)a.B * a.H;
    const bf16* planes[3] = {a.q, a.k, a.v};
    for (int i = 0; i < 3; ++i)
      if (int rc = tensor_map_3d(&maps[i], planes[i], T, D, BH, 2 * T,
                                 2 * (uint64_t)a.bh_stride, BT, D))
        return rc;
    if (int rc = tensor_map_3d(&maps[3], a.bias, T, T, a.H, 2 * T, 2 * T * T,
                               BT, BT))
      return rc;
  }
  // set once (the port drives one card): the dynamic shared memory, and
  // all of the SM's memory as shared, for MIN_BLOCKS blocks an SM
  static int allowed = 0;
  if (!allowed) {
    int rc = static_cast<int>(cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM));
    if (!rc)
      rc = static_cast<int>(cudaFuncSetAttribute(
          Kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100));
    if (rc) return rc;
    allowed = 1;
  }
  const dim3 grid(a.B, (a.T + BT - 1) / BT, a.H);
  Kernel<<<grid, THREADS, SMEM, st>>>(maps[0], maps[1], maps[2], maps[3], a);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// fp32: 3xTF32 tensor cores
// ---------------------------------------------------------------------------

struct F32Args {
  const float* q;         // (batch, head) planes of 64 x T, bh_stride apart
  const float* k;
  const float* v;
  long long bh_stride;    // elements
  const float* bias;      // (H, T, T)
  float* out;             // (B, H*64, T)
  int B, H, T;
  float scale;
  int tma;      // 16-byte rows (T % 4 == 0): tiles by TMA and 16-byte
                // output stores (else element copies and element stores)
};

// Shared memory past its 1024-byte aligned base: the raw step (the bias
// tile, then K and V, as copied), the split operands, then the step's
// barrier, in the last bytes of the alignment slack.  Each is a 64 x 64
// fp32 tile kept as two 32-column halves of 64 rows x 128 bytes with the
// 128-byte swizzle, as TMA writes a 32 x 64 box (sw32).  Seven tiles fit
// two blocks an SM (all of its 228 KB).  Q never lands: each thread reads
// its A slices from device memory once.
constexpr int F_BOX = 32 * BT * 4;     // one TMA box, 8 KB
constexpr int F_TILE = 2 * F_BOX;
constexpr int F_BIAS = 0, F_K = F_TILE, F_V = 2 * F_TILE;
constexpr int F_KT_HI = 3 * F_TILE, F_KT_LO = 4 * F_TILE;
constexpr int F_V_HI = 5 * F_TILE, F_V_LO = 6 * F_TILE;
constexpr int F_BAR = 7 * F_TILE;
constexpr int F_SMEM = 7 * F_TILE + 1024;
constexpr int F_MIN_BLOCKS = 2;        // blocks an SM: 255 registers
constexpr int F_LDS = BT + 4;          // the output stage's row stride

// byte offset of element (r, c) of a 64 x 64 fp32 tile kept as two boxes
// of 32 columns with the 128-byte swizzle (16-byte chunk c / 4 of row r,
// within its box, at chunk (c / 4 ^ r) % 8), as TMA writes it
__device__ __forceinline__ uint32_t sw32(int r, int c) {
  return (c >> 5) * F_BOX + r * 128 + ((((c >> 2) ^ r) & 7) << 4) +
         (c & 3) * 4;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  const float h = tf32_hi(x);
  hi = __float_as_uint(h);
  lo = __float_as_uint(__fsub_rn(x, h));
}

// x's hi and lo parts to dst_hi and dst_lo, 16 bytes each
__device__ __forceinline__ void split_store(unsigned char* dst_hi,
                                            unsigned char* dst_lo,
                                            float x0, float x1, float x2,
                                            float x3) {
  uint4 hi, lo;
  split(x0, hi.x, lo.x);
  split(x1, hi.y, lo.y);
  split(x2, hi.z, lo.z);
  split(x3, hi.w, lo.w);
  *reinterpret_cast<uint4*>(dst_hi) = hi;
  *reinterpret_cast<uint4*>(dst_lo) = lo;
}

// One block of the fp32 kernel: (blockIdx.x, blockIdx.y, blockIdx.z) =
// (batch row, 64-query tile, head), as in bf16.  kmap/vmap: (T, 64, B*H)
// views of k and v; bmap: (T, T, H) of the bias; each a box of 32 x 64
// fp32 with the 128-byte swizzle (unused without a.tma).
//
// Per 64-key step: the raw step arrives; every thread reads its share of
// the bias into S's accumulator layout, writes its share of K^T_hi and
// K^T_lo (4 x 4 blocks: 16-byte reads along keys, 16-byte writes along
// channels, each quarter-warp on 8 distinct chunks of both swizzled
// layouts) and of V_hi and V_lo (each row's 8-key groups reordered
// 0, 2, 4, 6, 1, 3, 5, 7); a barrier frees the raw stage for the next
// step's copy; S = Q^T K (24 wgmma); the softmax; P V^T (24 wgmma into a
// fresh accumulator) added to O.
template <bool BIAS_T>
__device__ __forceinline__ void attn_bias_f32_block(const CUtensorMap* kmap,
                                                    const CUtensorMap* vmap,
                                                    const CUtensorMap* bmap,
                                                    const F32Args& a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t full = base + F_BAR;

  const int T = a.T, h = blockIdx.z, q0 = blockIdx.y * BT;
  const long long bh = (long long)blockIdx.x * a.H + h;
  const long long off = bh * a.bh_stride;
  const int nkt = (T + BT - 1) / BT;
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;

  if (tid == 0) {
    mbar_init(full, 1);
    fence_barrier_init();
  }
  __syncthreads();

  // Step j's bias, K and V tiles into the raw stage: by TMA, issued by
  // thread 0 and counted on the barrier, or by every thread's element
  // copies (T's rows off 16 bytes), published by `ready`.  Out-of-range rows
  // and columns arrive as zeros either way.
  auto fill = [&](int j) {
    const int k0 = j * BT;
    if (a.tma) {
      if (tid == 0) {
        mbar_expect_tx(full, 3 * F_TILE);
        for (int b = 0; b < 2; ++b) {
          const uint32_t o = b * F_BOX;
          if (BIAS_T)
            tma_load_3d(base + F_BIAS + o, bmap, full, q0 + 32 * b, k0, h);
          else
            tma_load_3d(base + F_BIAS + o, bmap, full, k0 + 32 * b, q0, h);
          tma_load_3d(base + F_K + o, kmap, full, k0 + 32 * b, 0, (int)bh);
          tma_load_3d(base + F_V + o, vmap, full, k0 + 32 * b, 0, (int)bh);
        }
      }
      return;
    }
    const float* bias_h = a.bias + (long long)h * T * T;
    for (int i = tid; i < BT * BT; i += THREADS) {
      const int r = i / BT, c = i % BT;
      const uint32_t o = sw32(r, c);
      const int br = (BIAS_T ? k0 : q0) + r, bc = (BIAS_T ? q0 : k0) + c;
      const bool key = k0 + c < T;
      *reinterpret_cast<float*>(sm + F_BIAS + o) =
          br < T && bc < T ? bias_h[(long long)br * T + bc] : 0.f;
      *reinterpret_cast<float*>(sm + F_K + o) =
          key ? a.k[off + (long long)r * T + k0 + c] : 0.f;
      *reinterpret_cast<float*>(sm + F_V + o) =
          key ? a.v[off + (long long)r * T + k0 + c] : 0.f;
    }
  };
  // step j's raw tiles are in, and every warp is done with step j - 1's
  // products (their split operands are rewritten next)
  auto ready = [&](int j) {
    if (a.tma) wait_or_trap(full, j & 1);
    __syncthreads();
  };
  fill(0);

  // Q^T's A slices for the whole key loop, split: slice kk's a[i] is
  // channel 8 kk + t4 + 4 (i / 2) of query 16 w + g + 8 (i % 2)
  uint32_t qh[8][4], ql[8][4];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = 8 * kk + t4 + 4 * (i / 2);
      const int t = q0 + 16 * w + g + 8 * (i % 2);
      split(t < T ? a.q[off + (long long)c * T + t] : 0.f, qh[kk][i],
            ql[kk][i]);
    }

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  // the exponent base (log2 units) and this thread's share of the row
  // sums, of rows g and g + 8
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  // MASK: keys past T in this step
  auto step = [&](int kt, auto mask) {
    constexpr bool MASK = decltype(mask)::value;
    ready(kt);

    // the bias in S's accumulator layout: bv[4 j + 2 hh + e] is query
    // 16 w + g + 8 hh, key 8 j + 2 t4 + e
    float bv[32];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = 16 * w + g + 8 * hh, c = 8 * j + 2 * t4;
        float* d = bv + 4 * j + 2 * hh;
        if (BIAS_T) {
          d[0] = *reinterpret_cast<const float*>(sm + F_BIAS + sw32(c, r));
          d[1] = *reinterpret_cast<const float*>(sm + F_BIAS + sw32(c + 1, r));
        } else {
          const float2 b2 =
              *reinterpret_cast<const float2*>(sm + F_BIAS + sw32(r, c));
          d[0] = b2.x;
          d[1] = b2.y;
        }
      }

    // K^T: unit u's 4 x 4 block is keys 4 (x + 4 (u / 8)) + {0..3} and
    // channels 4 ((y + 2 x + 2 (u % 4)) % 8 + 8 ((u / 4) % 2)) + {0..3}
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int u = tid / 8 + 16 * it, x = tid % 4, y = (tid / 4) % 2;
      const int n = 4 * (x + 4 * (u / 8));
      const int c = 4 * (((y + 2 * x + 2 * (u % 4)) & 7) + 8 * ((u / 4) % 2));
      float kr[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v4 =
            *reinterpret_cast<const float4*>(sm + F_K + sw32(c + i, n));
        kr[i][0] = v4.x;
        kr[i][1] = v4.y;
        kr[i][2] = v4.z;
        kr[i][3] = v4.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t kt_at = sw32(n + i, c);
        split_store(sm + F_KT_HI + kt_at, sm + F_KT_LO + kt_at, kr[0][i],
                    kr[1][i], kr[2][i], kr[3][i]);
      }
    }
    // V, each row's 8-key groups in the order of P's A columns
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int i = tid + THREADS * it, c = i % D, k8 = 8 * (i / D);
      const float4 e = *reinterpret_cast<const float4*>(sm + F_V + sw32(c, k8));
      const float4 f =
          *reinterpret_cast<const float4*>(sm + F_V + sw32(c, k8 + 4));
      split_store(sm + F_V_HI + sw32(c, k8), sm + F_V_LO + sw32(c, k8), e.x,
                  e.z, f.x, f.z);
      split_store(sm + F_V_HI + sw32(c, k8 + 4), sm + F_V_LO + sw32(c, k8 + 4),
                  e.y, e.w, f.y, f.w);
    }
    fence_proxy_async();   // the split operands, for wgmma
    __syncthreads();       // and the raw stage is free
    if (kt + 1 < nkt) fill(kt + 1);

    // S = Q^T K: per 8-channel slice lo hi + hi lo + hi hi
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint32_t so = (kk / 4) * F_BOX + 32 * (kk % 4);
      const uint64_t dh = desc_sw128(base + F_KT_HI + so, 16, 1024);
      const uint64_t dl = desc_sw128(base + F_KT_LO + so, 16, 1024);
      wgmma_tf32_rs<64>(sc, ql[kk], dh);
      wgmma_tf32_rs<64>(sc, qh[kk], dl);
      wgmma_tf32_rs<64>(sc, qh[kk], dh);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(sc);

    // the online softmax: x = s * scale + bias (-inf at or past T), then
    // p = 2^(x log2 e - m); the base m moves (and O and l are rescaled)
    // only where a row's max passes it by 8
    const int kvalid = T - kt * BT;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = fmaf(sc[i], a.scale, bv[i]);
      if (MASK && 8 * (i / 4) + 2 * t4 + (i & 1) >= kvalid) x = -INFINITY;
      sc[i] = x;
      if (i & 2)
        mx1 = fmaxf(mx1, x);
      else
        mx0 = fmaxf(mx0, x);
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    mx0 *= LOG2E;   // finite: the step's first key is valid
    mx1 *= LOG2E;
    const bool up0 = mx0 > m0 + 8.f, up1 = mx1 > m1 + 8.f;
    if (__any_sync(0xffffffffu, up0 || up1)) {
      const float n0 = up0 ? mx0 : m0, n1 = up1 ? mx1 : m1;
      const float al0 = ex2(m0 - n0), al1 = ex2(m1 - n1);   // 0 from -inf
      m0 = n0;
      m1 = n1;
      l0 *= al0;
      l1 *= al1;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[4 * j] *= al0;
        o[4 * j + 1] *= al0;
        o[4 * j + 2] *= al1;
        o[4 * j + 3] *= al1;
      }
    }
    const float nb0 = -m0, nb1 = -m1;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = ex2(fmaf(sc[i], LOG2E, i & 2 ? nb1 : nb0));
      sc[i] = p;
      if (i & 2)
        l1 += p;
      else
        l0 += p;
    }

    // O += P V^T: accumulator block kk's columns 2 t4 and 2 t4 + 1 are the
    // A slice's columns t4 and t4 + 4, the keys V's rows hold there.  The
    // step's products go to a fresh accumulator, added to O in fp32: the
    // tensor cores' accumulation is not round-to-nearest (a chain over all
    // 896 keys erred 1.0-1.8e-5 on an H100, as round-toward-zero does),
    // and one step's chain of 24 products stays near 1e-6.
    uint32_t ph[8][4], pl[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      split(sc[4 * kk], ph[kk][0], pl[kk][0]);
      split(sc[4 * kk + 2], ph[kk][1], pl[kk][1]);
      split(sc[4 * kk + 1], ph[kk][2], pl[kk][2]);
      split(sc[4 * kk + 3], ph[kk][3], pl[kk][3]);
    }
    float po[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) po[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint32_t so = (kk / 4) * F_BOX + 32 * (kk % 4);
      const uint64_t dh = desc_sw128(base + F_V_HI + so, 16, 1024);
      const uint64_t dl = desc_sw128(base + F_V_LO + so, 16, 1024);
      wgmma_tf32_rs<64>(po, pl[kk], dh);
      wgmma_tf32_rs<64>(po, ph[kk], dl);
      wgmma_tf32_rs<64>(po, ph[kk], dh);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(po);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      reg_fence(ph[kk]);
      reg_fence(pl[kk]);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] += po[i];
  };
  for (int kt = 0; kt < nkt - 1; ++kt) step(kt, std::false_type());
  step(nkt - 1, std::true_type());

  // o / l, staged channels-major over the split K (every product is
  // done), then coalesced stores
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float i0 = 1.f / l0, i1 = 1.f / l1;
  float* stage = reinterpret_cast<float*>(sm + F_KT_HI);
  const int r0 = 16 * w + g;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int ch = 8 * j + 2 * t4 + e;
      stage[ch * F_LDS + r0] = o[4 * j + e] * i0;
      stage[ch * F_LDS + r0 + 8] = o[4 * j + 2 + e] * i1;
    }
  __syncthreads();
  float* ob = a.out + bh * D * T;
  for (int i = tid; i < D * (BT / 4); i += THREADS) {
    const int ch = i / (BT / 4), c4 = (i % (BT / 4)) * 4, t = q0 + c4;
    if (t >= T) continue;
    const float4 v = *reinterpret_cast<const float4*>(stage + ch * F_LDS + c4);
    float* dst = ob + (long long)ch * T + t;
    if (a.tma) {
      *reinterpret_cast<float4*>(dst) = v;
    } else {
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (t + k < T) dst[k] = e[k];
    }
  }
}

// The host half of an fp32 call: the three tensor maps where a.tma, then
// Kernel (the source's own __global__) on (B, T tiles, H) blocks of
// THREADS, two an SM.
template <auto Kernel>
int launch_f32(const F32Args& a, cudaStream_t st) {
  CUtensorMap maps[3] = {};
  if (a.tma) {
    constexpr CUtensorMapDataType F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    const uint64_t T = a.T, BH = (uint64_t)a.B * a.H;
    const float* planes[2] = {a.k, a.v};
    for (int i = 0; i < 2; ++i)
      if (int rc = tensor_map_3d(&maps[i], planes[i], T, D, BH, 4 * T,
                                 4 * (uint64_t)a.bh_stride, 32, BT, F32))
        return rc;
    if (int rc = tensor_map_3d(&maps[2], a.bias, T, T, a.H, 4 * T,
                               4 * T * T, 32, BT, F32))
      return rc;
  }
  static int allowed = 0;
  if (!allowed) {
    int rc = static_cast<int>(cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F_SMEM));
    if (!rc)
      rc = static_cast<int>(cudaFuncSetAttribute(
          Kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100));
    if (rc) return rc;
    allowed = 1;
  }
  const dim3 grid(a.B, (a.T + BT - 1) / BT, a.H);
  Kernel<<<grid, THREADS, F_SMEM, st>>>(maps[0], maps[1], maps[2], a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
