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
// fp32 (the reference runs): attn_bias_f32_block, CUDA-core FMAs, one block
// of 4 warps per (batch, head, 64-query tile), each thread half a query
// row; TF32 would round the fp32 parity runs' inputs.
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

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t x) {
  return make_float2(__uint_as_float(x << 16),
                     __uint_as_float(x & 0xffff0000u));
}

// mbar_wait that faults (an illegal instruction, reported at the next
// synchronisation) instead of spinning forever if a phase never completes
// (about 10 s of cycles): a lost arrival must not hang the card
__device__ __forceinline__ void wait_or_trap(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1LL << 34)) __trap();
  } while (!done);
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
// fp32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int F_THREADS = 128;   // 4 warps x 16 query rows
constexpr int LDT = BT + 1;      // row stride of the staged fp32 tiles

constexpr size_t f32_smem_bytes() {   // q, k, v and p tiles
  return 4 * (size_t)BT * LDT * sizeof(float);
}

// dst[c][j] = src[c * ld + t0 + j] for 64 rows and 64 columns; zero past
// Tn columns and past `rows` rows
__device__ __forceinline__ void f32_tile(float* dst,
                                         const float* __restrict__ src,
                                         long long ld, int r0, int rows,
                                         int t0, int Tn) {
  for (int idx = threadIdx.x; idx < BT * BT; idx += F_THREADS) {
    const int c = idx / BT, j = idx % BT;
    dst[c * LDT + j] = r0 + c < rows && t0 + j < Tn
                           ? src[(r0 + c) * ld + t0 + j]
                           : 0.f;
  }
}

// One (batch, head, 64-query tile), the block at (blockIdx.x, blockIdx.y,
// blockIdx.z) = (batch, tile, head).  qp, kp, vp: this (batch, head)'s q,
// k and v, each 64 channels x Tn; bias: this head's (Tn, Tn) bias, (query,
// key) or with BIAS_T (key, query); ob: this (batch, head)'s 64 x Tn
// output.  Each thread owns half a query row: 32 keys of each step, then
// 32 output channels.
template <bool BIAS_T>
__device__ __forceinline__ void attn_bias_f32_block(
    const float* __restrict__ qp, const float* __restrict__ kp,
    const float* __restrict__ vp, const float* __restrict__ bias,
    float* __restrict__ ob, int Tn, float scale) {
  extern __shared__ __align__(16) unsigned char smem_f32[];
  float* Qs = reinterpret_cast<float*>(smem_f32);   // [c][t]
  float* Ks = Qs + BT * LDT;                        // [c][key]
  float* Vs = Ks + BT * LDT;                        // [c][key]
  float* Ps = Vs + BT * LDT;                        // [query][key]

  const int q0 = blockIdx.y * BT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = warp * 16 + lane / 2;   // this thread's query row
  const int c0 = (lane % 2) * 32;       // and its 32 keys / channels
  const bool row_ok = q0 + r < Tn;

  f32_tile(Qs, qp, Tn, 0, D, q0, Tn);
  float m = -INFINITY, l = 0.f, o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;

  for (int k0 = 0; k0 < Tn; k0 += BT) {
    __syncthreads();   // the previous step's K, V and P are consumed
    f32_tile(Ks, kp, Tn, 0, D, k0, Tn);
    f32_tile(Vs, vp, Tn, 0, D, k0, Tn);
    __syncthreads();

    float s[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = 0.f;
    for (int c = 0; c < D; ++c) {
      const float qv = Qs[c * LDT + r];
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] = fmaf(qv, Ks[c * LDT + c0 + j], s[j]);
    }
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int key = k0 + c0 + j;
      if (key < Tn) {
        const float bv = !row_ok ? 0.f
                         : BIAS_T ? bias[(long long)key * Tn + q0 + r]
                                  : bias[(long long)(q0 + r) * Tn + key];
        s[j] = s[j] * scale + bv;
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
      const float p = expf(s[j] - mn);
      ps += p;
      Ps[r * LDT + c0 + j] = p;
    }
    ps += __shfl_xor_sync(0xffffffffu, ps, 1);
    l = l * alpha + ps;
    m = mn;
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] *= alpha;
    __syncwarp();   // the warp's 16 P rows are complete
    for (int j = 0; j < BT; ++j) {
      const float p = Ps[r * LDT + j];
#pragma unroll
      for (int i = 0; i < 32; ++i)
        o[i] = fmaf(p, Vs[(c0 + i) * LDT + j], o[i]);
    }
  }

  // o / l, staged channels-major in the q tile, then coalesced stores
  __syncthreads();
  const float inv = 1.f / l;
#pragma unroll
  for (int i = 0; i < 32; ++i) Qs[(c0 + i) * LDT + r] = o[i] * inv;
  __syncthreads();
  for (int idx = threadIdx.x; idx < D * BT; idx += F_THREADS) {
    const int c = idx / BT, j = idx % BT;
    if (q0 + j < Tn) ob[(long long)c * Tn + q0 + j] = Qs[c * LDT + j];
  }
}

// Launches the fp32 kernel on (B, T tiles, H) blocks of F_THREADS.
template <typename Kernel, typename... Args>
int launch_f32(Kernel kernel, int B, int H, int Tn, cudaStream_t st,
               Args... args) {
  constexpr size_t bytes = f32_smem_bytes();
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(B, (Tn + BT - 1) / BT, H);
  kernel<<<grid, F_THREADS, bytes, st>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
