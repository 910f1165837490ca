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
// Design (bf16), two kernels a call:
//   1. group_norm_act: one cluster of 1 or 2 blocks per (batch, group),
//      each block a slice of the group's channels (two where the groups
//      are too few to fill the SMs: 64 at B=2).  The slice's
//      elements are contiguous; the block reads them once into shared
//      memory (a second time from global memory where they do not fit),
//      and the cluster takes the two-pass statistics, each sum reduced
//      across its blocks through distributed shared memory (the variance
//      of jnp.var and F.group_norm, not the TPU kernel's E[x^2]-mu^2,
//      which loses digits when |mean| >> std).  Each block then writes
//      Y = act(GroupNorm(x)) once per element of its slice: normalise
//      with the channel's gamma/beta in fp32, (K5: times 1 + scale, plus
//      shift), round to bf16, then silu as the TPU kernel does it (fp32
//      sigmoid rounded to bf16, the product rounded again).  Every fp32
//      step is rounded on its own (no fused multiply-add), so a plain
//      PyTorch version given the same statistics makes the same bits.  Y goes to a time-major (B, T, C) scratch:
//      TMA reads a box from any outer coordinate but only from innermost
//      coordinates on 16 bytes (an H100 raises an illegal instruction at
//      an odd time step), and the k=3 taps below shift by one step.
//   2. gemm: out[b] (M x T) = W (M x K) * Y_b (K x T) + bias (+ x) with
//      wgmma.  A block owns a 128 x BN output tile (BN = 64 or 128, the
//      wrapper's choice by grid size) and walks K in 64-deep steps through
//      a ring of 4 shared-memory stages guarded by mbarriers: one producer
//      thread issues TMA loads (the weight box, 128 rows x 64 channels;
//      the Y box, BN steps x 64 channels), both K-major with the 128-byte
//      swizzle; two consumer warpgroups each run m64nBNk16 wgmma on 64 of
//      the rows, keeping one group of products in flight while the next
//      stage lands.  K5's k=3 convolution is three tap-shifted
//      accumulations over a tap-major (3, C, C) weight, the TPU kernel's
//      [W(-1) | W(0) | W(+1)] (made once per weight by the caller): tap s
//      loads its Y box at time t0 + s - 1, and TMA's zero fill outside
//      [0, T) is the convolution's padding.  Ragged M, K and T arrive as
//      zeros; the epilogue stages the tile in shared memory, adds the
//      fp32 bias (K5: and the residual x in fp32), rounds once and stores
//      whole rows in 16-byte pieces, masked at the ragged edges.
// fp32, the same two kernels (3xTF32: fp32 accuracy on the tensor cores):
//   1. group_norm_act<float>: as in bf16, but Y stays fp32 (no rounding
//      between the steps) and leaves as two time-major arrays, Y_hi = Y
//      rounded to TF32 (cvt.rna, the low 13 bits zero) and Y_lo = Y - Y_hi
//      (exact).
//   2. gemm_tf32: out = W (M x K, fp32) * Y + bias (+ x) with
//      wgmma m64nBNk8 tf32 (BN = 64, 104 or 128), TMA boxes 32 channels
//      deep (one 128-byte swizzle row of fp32) in a ring of 4 stages of
//      [W tile | Y_hi box | Y_lo box].  Each consumer thread reads its A
//      fragments of the weight tile from shared memory and splits them in
//      registers (W_hi = rna(W), W_lo = W - W_hi), so W leaves device
//      memory once, in fp32; each 8-deep slice is three products into the
//      fp32 accumulators, W_lo Y_hi + W_hi Y_lo + W_hi Y_hi (the dropped
//      W_lo Y_lo is about 2^-22 of a product; the tensor cores read the lo
//      parts truncated to TF32).  The bound is 3x the operations at 495
//      TFLOP/s (TF32) or the fp32 bytes, whichever is larger.  Where the
//      output tiles are too few to fill the SMs (B = 1, C = 2048, T = 101
//      -> 6144: 48 tiles) K is split over a cluster of `split` blocks
//      along grid x; each block leaves its partial tile in its shared
//      memory and the cluster sums them through distributed shared memory
//      in rank order (no atomics: the same bits on every call), each block
//      storing its share of the rows.  The tile width and the split are
//      the wrapper's (kernels/gn_conv.plan).
// K must be a multiple of 8 (16-byte weight rows), for both.
//
// The backward (tts_resblock_bwd: K4's and K5's, under autograd) replaces
// no TPU kernel: the JAX package differentiates its XLA formulation
// (models/arch.py _gn_qkv_bwd, models/diffusion.py _ts_rb_bwd).  At the
// diffusion training step's (16, 1024, 2240) it is two products of the
// forward's size, da = W^T g and dW = g a^T (150 GFLOP for K4 -> 1024, 451
// for the qkv head and K5) against 0.22-0.38 GB of inputs and outputs:
// bound by operations (0.152, 0.456 ms at 989 TFLOP/s).  Rounding: a is the
// forward's bf16 Y (what its GEMM read); silu' and the GroupNorm backward
// take fp32 z and x^; dn leaves rounded to x's type, its sums in fp32.
// Six kernels, every sum in a fixed order (no atomics: the same bits on
// every call):
//   1. bwd_apply_norm: a from the forward's recorded mean and rstd through
//      norm_value, time-major (B, T, C), a 64 x 64 tile at a time.
//   2. bwd_transpose: the upstream g (B, M, T) -> gt (B, T, M), so that
//      K5's tap shifts are outer TMA coordinates, and db's partial sums.
//      K4 (one tap) at T % 8 == 0 (16-byte rows of g, as TMA reads them)
//      skips it: its GEMMs read g as it comes (the wrapper's bwd_plan
//      says which), a pass over the upstream fewer.
//   3. bwd_da_wgmma (K4): da = W^T g on the forward's TMA ring and wgmma
//      main loop, over W^T (1, C, M); its epilogue applies silu'(z) where
//      act, writes dn and each 64- or 128-step tile's channel sums (dn, dn
//      x^).  Reading g itself, the upstream is an MN-major B (boxes of 64
//      steps x 64 rows of M, one or two a stage).  K5 (bf16):
//      bwd_da_pingpong, persistent and warp-specialised, on the forward's
//      tap-major weight (no per-call copy: the taps reversed by the TMA
//      coordinate, transposed by wgmma's transpose bit), two consumer
//      warpgroups taking whole 128 x 128 tiles in turn, each epilogue (x
//      (1 + scale) silu'(z) into dn, and the channel sums dn, dn x^, dz n,
//      dz) straight from the accumulators beside the other's products.
//      The taps still need gt: TMA refuses a box whose innermost start is
//      off 16 bytes (an illegal instruction on an H100 at an odd step,
//      swizzled or not), so a tap's one-step shift cannot be an inner
//      coordinate of g as it comes.
//   4. bwd_norm: a (batch, group) a block: the tiles' sums in order, then
//      dx = rstd (gamma dn - mean(gamma dn) - x^ mean(gamma dn x^)).
//   5. bwd_dw_wgmma: dW partials over slices of the B T reduction, both
//      operands MN-major from the time-major gt and a (m64n128, both
//      transpose bits), fp32 partials.  Reading g itself, A (M x steps) is
//      K-major, and the blocks of the first 128 channels sum their A rows
//      into each slice's db partials.
//   6. bwd_reduce: dW over the slices, db, dgamma and dbeta.
// fp32 takes the same passes with both products on the tensor cores in
// 3xTF32, as the forward's fp32 GEMM (bound: 3x the operations at 495
// TFLOP/s, 0.911 ms for K4 -> 1024 at (16, 1024, 2240), 2.73 for the qkv
// head and K5; the fp32 bytes 0.13-0.23 ms).  TF32 wgmma reads its shared
// operands K-major only, so:
//   2. bwd_split_upstream replaces the transpose: g split into TF32 hi and
//      lo parts, time-major (gt_hi, gt_lo (B, T, M)) and as it comes
//      (g_hi, g_lo (B, M, Tp), Tp = T rounded up to 4, zeros past T: TMA
//      rows on 16 bytes at any T), with db's partials;
//   3. bwd_da_tf32: da = W^T gt on the forward's main loop
//      (tf32_mainloop: wb split in registers, gt_hi and gt_lo K-major by
//      TMA, tap s' shifted by s' - 1 steps), then da_epilogue;
//   5. bwd_dw_tf32: dW^T = a g^T over slices of the B T reduction, g_hi
//      and g_lo as the K-major B (64 rows of M x 32 steps a box), the
//      time-major a as the register A operand, each thread's fragments
//      read across the stage's steps and split (the tap shift an outer
//      coordinate of a); each stage's products in a fresh accumulator
//      added in fp32, the partials stored transposed.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

// The per-channel vectors as the caller stores them, fp32 or bf16, so no
// call converts them first: gamma, beta (C) and bias (M) in one type
// (bf = 1: bf16), emb (B, 2C) = [scale | shift] (K5) or null in its own.
struct Vecs {
  const void* gamma;
  const void* beta;
  const void* bias;
  const void* emb;
  int bf, emb_bf;
};

__device__ __forceinline__ float ld(const void* p, long long i, int bf) {
  return bf ? __bfloat162float(static_cast<const bf16*>(p)[i])
            : static_cast<const float*>(p)[i];
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

// ---------------------------------------------------------------------------
// bf16: the normalise kernel
// ---------------------------------------------------------------------------

constexpr int NORM_THREADS = 512;
constexpr int NORM_CACHE_MAX = 160 * 1024;   // bytes of one slice kept

template <typename TX>
struct NormArgs {
  const TX* x;     // (B, C, T)
  TX* y;           // (B, T, C): time-major (fp32: Y_hi)
  float* ylo;      // (B, T, C): fp32 Y_lo, or null (bf16)
  float* stats;    // mu (B*G), then rstd (B*G), or null
  Vecs v;          // gamma, beta; emb (K5) or null
  int B, C, G, T, act;
  float eps;
};

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }

// The sum of v over the block, then over the cluster's blocks in rank
// order (every block of the cluster gets the same value).  slot: this
// reduction's own shared float, read by the other blocks through
// distributed shared memory.
__device__ float cluster_sum(float v, float* red, float* slot) {
  namespace cg = cooperative_groups;
  const float s = block_sum(v, red);
  if (threadIdx.x == 0) *slot = s;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  float total = 0.f;
  for (unsigned r = 0; r < cluster.num_blocks(); ++r)
    total += *cluster.map_shared_rank(slot, r);
  return total;
}

// Y of one (time step, channel) of the slice: ((x - mu) * rstd) * gamma +
// beta, (times 1 + scale, plus shift), then silu where act; every fp32
// step rounded on its own (no fused multiply-add).  bf16 rounds the
// normalised value and the sigmoid to bf16 as the TPU kernel does; fp32
// rounds nothing.
template <typename TX>
__device__ __forceinline__ float norm_value(TX xv, const float* q4,
                                            float mu, float rs, bool film,
                                            int act) {
  constexpr bool BF = sizeof(TX) == 2;
  float yn = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(to_f(xv), mu), rs),
                                 q4[0]),
                       q4[1]);
  if (film) yn = __fadd_rn(__fmul_rn(yn, q4[2]), q4[3]);
  float y = BF ? __bfloat162float(__float2bfloat16(yn)) : yn;
  if (act) {
    float sg = 1.f / (1.f + expf(-y));
    if (BF) sg = __bfloat162float(__float2bfloat16(sg));
    y = __fmul_rn(y, sg);
  }
  return y;
}

// One cluster of blocks per (batch, group); block `rank` of the cluster
// normalises `ps` = (C/G)/cluster of the group's channels, which are
// contiguous in x.  Dynamic shared memory: the slice's channel parameters
// (4 floats a channel: gamma, beta, 1 + scale, shift), then the cached
// slice.
template <typename TX, bool CACHED>
__global__ void __launch_bounds__(NORM_THREADS)
    group_norm_act(NormArgs<TX> a) {
  namespace cg = cooperative_groups;
  constexpr bool BF = sizeof(TX) == 2;
  constexpr int E = 16 / sizeof(TX);   // elements a 16-byte load
  extern __shared__ __align__(16) unsigned char norm_smem[];
  __shared__ float red[NORM_THREADS / 32];
  __shared__ float slots[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int bg = blockIdx.x / cl, b = bg / a.G, g = bg % a.G;
  const int per = a.C / a.G, ps = per / cl, T = a.T;
  const int c0 = g * per + rank * ps;   // the slice's first channel
  const int n = ps * T;
  float* prm = reinterpret_cast<float*>(norm_smem);
  TX* cache = reinterpret_cast<TX*>(prm + 4 * ((ps + 3) & ~3));
  const TX* p = a.x + ((long long)b * a.C + c0) * T;
  const int tid = threadIdx.x;
  const bool film = a.v.emb != nullptr;
  for (int r = tid; r < ps; r += NORM_THREADS) {
    const int c = c0 + r;
    const long long e = 2LL * b * a.C + c;
    prm[4 * r] = ld(a.v.gamma, c, a.v.bf);
    prm[4 * r + 1] = ld(a.v.beta, c, a.v.bf);
    prm[4 * r + 2] = film ? __fadd_rn(1.f, ld(a.v.emb, e, a.v.emb_bf)) : 1.f;
    prm[4 * r + 3] = film ? ld(a.v.emb, e + a.C, a.v.emb_bf) : 0.f;
  }

  float s = 0.f;
  if (((reinterpret_cast<uintptr_t>(p) & 15) | (n % E)) == 0) {
    // four 16-byte loads in flight a thread before any is used
    constexpr int U = 4;
    const int4* p4 = reinterpret_cast<const int4*>(p);
    for (int i0 = tid; i0 < n / E; i0 += U * NORM_THREADS) {
      int4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (i0 + u * NORM_THREADS < n / E) v[u] = p4[i0 + u * NORM_THREADS];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * NORM_THREADS;
        if (i < n / E) {
          if (CACHED) reinterpret_cast<int4*>(cache)[i] = v[u];
          if constexpr (BF) {
            const TX* e = reinterpret_cast<const TX*>(&v[u]);
#pragma unroll
            for (int j = 0; j < E; ++j) s += to_f(e[j]);
          } else {
            s += __int_as_float(v[u].x);
            s += __int_as_float(v[u].y);
            s += __int_as_float(v[u].z);
            s += __int_as_float(v[u].w);
          }
        }
      }
    }
  } else {
    for (int i = tid; i < n; i += NORM_THREADS) {
      const TX v = p[i];
      if (CACHED) cache[i] = v;
      s += to_f(v);
    }
  }
  const TX* src = CACHED ? cache : p;
  const float cnt = (float)per * (float)T;
  const float mu = cluster_sum(s, red, &slots[0]) / cnt;
  float q = 0.f;
  for (int i = tid; i < n; i += NORM_THREADS) {
    const float d = to_f(src[i]) - mu;
    q = fmaf(d, d, q);
  }
  const float rs = rsqrtf(cluster_sum(q, red, &slots[1]) / cnt + a.eps);
  if (a.stats != nullptr && tid == 0 && rank == 0) {
    a.stats[bg] = mu;
    a.stats[a.B * a.G + bg] = rs;
  }
  // Y, time-major: a thread makes one time step of a run of 8 channels and
  // stores it as 16-byte pieces where the slice's channel count allows; the
  // runs of a step go to consecutive threads, so a step's ps channels leave
  // as one contiguous piece (whole 32-byte sectors when ps % 16 == 0: a
  // sector written in halves costs the H100 several times as much)
  const int runs = (ps + 7) / 8;
  const bool vec_out = ps % 8 == 0;
  const long long yoff = (long long)b * T * a.C + c0;
  for (int i = tid; i < runs * T; i += NORM_THREADS) {
    const int t = i / runs, r0 = 8 * (i - t * runs);
    const int nr = min(8, ps - r0);
    float y[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      y[k] = k < nr ? norm_value(src[(r0 + k) * T + t], prm + 4 * (r0 + k),
                                 mu, rs, film, a.act)
                    : 0.f;
    const long long o = yoff + (long long)t * a.C + r0;
    if constexpr (BF) {
      __nv_bfloat162 v2[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v2[k] = __floats2bfloat162_rn(y[2 * k], y[2 * k + 1]);
      bf16* dst = a.y + o;
      if (vec_out) {
        *reinterpret_cast<int4*>(dst) = make_int4(
            *reinterpret_cast<const int*>(&v2[0]),
            *reinterpret_cast<const int*>(&v2[1]),
            *reinterpret_cast<const int*>(&v2[2]),
            *reinterpret_cast<const int*>(&v2[3]));
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (k < nr) dst[k] = k % 2 ? v2[k / 2].y : v2[k / 2].x;
      }
    } else {
      float hi[8], lo[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        hi[k] = tf32_hi(y[k]);
        lo[k] = __fsub_rn(y[k], hi[k]);
      }
      float* dh = a.y + o;
      float* dl = a.ylo + o;
      if (vec_out) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          reinterpret_cast<float4*>(dh)[h] = make_float4(
              hi[4 * h], hi[4 * h + 1], hi[4 * h + 2], hi[4 * h + 3]);
          reinterpret_cast<float4*>(dl)[h] = make_float4(
              lo[4 * h], lo[4 * h + 1], lo[4 * h + 2], lo[4 * h + 3]);
        }
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (k < nr) {
            dh[k] = hi[k];
            dl[k] = lo[k];
          }
      }
    }
  }
  cluster.sync();   // the other blocks have read this block's slots
}

// ---------------------------------------------------------------------------
// bf16: the wgmma GEMM
// ---------------------------------------------------------------------------

constexpr int BM = 128;         // output channels a block (two warpgroups)
constexpr int BK = 64;          // reduction step: one 128-byte swizzle row
constexpr int STAGES = 4;
constexpr int GEMM_THREADS = 384;   // consumers 0-255, producer 256-383
constexpr int A_BYTES = BM * BK * 2;

template <int BN>
struct Ring {
  static constexpr int B_BYTES = BK * BN * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;   // a multiple of 1024
  static constexpr int BARS = STAGES * STAGE;       // full[], then empty[]
  static constexpr int SMEM = BARS + 2 * STAGES * 8 + 1024;   // + alignment
  // the epilogue tile and, in the backward, its rows' parameters
  static_assert(BM * (BN + 8) * 4 + BM * 32 <= BARS, "the tile fits the ring");
};

// a barrier of the two consumer warpgroups alone (the producer has left)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// The GEMM's main loop: acc (this consumer warpgroup's 64 of the BM rows x
// BN steps) = the (taps, rows, K) weight's rows m0.. against Y_b's steps
// n0.. (Y (B, T, K) time-major), K walked in BK-deep steps; TAPS = 3: tap
// s against Y shifted by s - 1 steps.  GT (TAPS = 1 only): Y is (B, K, T),
// its map's boxes 64 steps wide, one or two a stage, read as an MN-major
// B.  Returns false in the producer warpgroup, which has nothing left to
// do.  base: the ring, 1024-aligned.
template <int TAPS, int BN, bool GT = false>
__device__ __forceinline__ bool ring_mainloop(const CUtensorMap* wmap,
                                              const CUtensorMap* ymap,
                                              int K, int m0, int n0, int b,
                                              uint32_t base,
                                              float (&acc)[BN / 2]) {
  using L = Ring<BN>;
  const uint32_t full0 = base + L::BARS, empty0 = full0 + STAGES * 8;
  const int tid = threadIdx.x, wg = tid / 128;
  const int kc = (K + BK - 1) / BK, kt = TAPS * kc;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2);   // one arrival per consumer warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {   // producer: one thread keeps the ring full
    if (tid == 256) {
      for (int it = 0; it < kt; ++it) {
        const int s = it % STAGES;
        const uint32_t ph = (it / STAGES) & 1;
        mbar_wait(empty0 + 8 * s, ph ^ 1);
        mbar_expect_tx(full0 + 8 * s, L::STAGE);
        const int tap = it / kc, c0 = (it - tap * kc) * BK;
        const uint32_t sa = base + s * L::STAGE;
        tma_load_3d(sa, wmap, full0 + 8 * s, c0, m0, tap);
        if constexpr (GT) {
#pragma unroll
          for (int h = 0; h < BN / 64; ++h)
            tma_load_3d(sa + A_BYTES + h * 8192, ymap, full0 + 8 * s,
                        n0 + 64 * h, c0, b);
        } else {
          tma_load_3d(sa + A_BYTES, ymap, full0 + 8 * s, c0,
                      n0 + (TAPS == 3 ? tap - 1 : 0), b);
        }
      }
    }
    return false;
  }

#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  int prev = 0;
  for (int it = 0; it < kt; ++it) {
    const int s = it % STAGES;
    mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
    const uint32_t sa = base + s * L::STAGE + wg * 64 * 128;
    const uint32_t sb = base + s * L::STAGE + A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      if constexpr (GT)
        wgmma_bf16<BN, 1>(acc, desc_sw128(sa + kk * 32, 16, 1024),
                          desc_sw128(sb + kk * 2048, 8192, 1024));
      else
        wgmma_bf16<BN>(acc, desc_sw128(sa + kk * 32, 16, 1024),
                       desc_sw128(sb + kk * 32, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait<1>();   // the previous step's products are done
    if (it > 0 && tid % 128 == 0) mbar_arrive(empty0 + 8 * prev);
    prev = s;
  }
  wgmma_wait<0>();
  return true;
}

// The consumers' accumulators to an fp32 BM x BN tile over the ring (row
// stride BN + 8 floats: 2-way stores), once both warpgroups are done
// reading the ring (every load in it consumed); returns the tile.
template <int BN>
__device__ __forceinline__ float* acc_to_tile(const float (&acc)[BN / 2],
                                              uint32_t base) {
  extern __shared__ unsigned char gemm_smem[];
  constexpr int TS = BN + 8;
  float* tile =
      reinterpret_cast<float*>(gemm_smem + (base - smem_u32(gemm_smem)));
  const int tid = threadIdx.x, wg = tid / 128;
  consumers_sync();
  const int w = (tid % 128) / 32, lane = tid % 32;
  const int r0 = wg * 64 + w * 16 + lane / 4;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      *reinterpret_cast<float2*>(tile + (r0 + 8 * h) * TS + 8 * j +
                                 2 * (lane % 4)) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  consumers_sync();
  return tile;
}

// out[b] = W * Y_b + bias (+ res[b]).  TAPS = 1: K = C; TAPS = 3: tap s of
// the (3, M, C) weight against Y shifted by s - 1 steps.
template <int TAPS, int BN>
__device__ __forceinline__ void conv_gemm(const CUtensorMap* wmap,
                                          const CUtensorMap* ymap,
                                          const void* bias, int bias_bf,
                                          const bf16* __restrict__ res,
                                          bf16* __restrict__ out, int M,
                                          int C, int T) {
  extern __shared__ unsigned char gemm_smem[];
  const uint32_t base = (smem_u32(gemm_smem) + 1023) & ~1023u;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, b = blockIdx.z;
  float acc[BN / 2];
  if (!ring_mainloop<TAPS, BN>(wmap, ymap, C, m0, n0, b, base, acc)) return;

  // Epilogue through shared memory: the accumulators go to an fp32 tile
  // over the ring, then whole output rows leave in 16-byte pieces, the
  // residual read the same way; bias and residual added in fp32, rounded
  // once.
  constexpr int TS = BN + 8;
  const float* tile = acc_to_tile<BN>(acc, base);
  const bool vec = T % 8 == 0 &&
                   ((reinterpret_cast<uintptr_t>(res) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  for (int i = tid; i < BM * (BN / 8); i += 256) {
    const int r = i / (BN / 8), c8 = (i % (BN / 8)) * 8;
    const int m = m0 + r, t = n0 + c8;
    if (m >= M || t >= T) continue;
    const float bm = ld(bias, m, bias_bf);
    const float4 lo = *reinterpret_cast<const float4*>(tile + r * TS + c8);
    const float4 hi = *reinterpret_cast<const float4*>(tile + r * TS + c8 + 4);
    float v[8] = {lo.x + bm, lo.y + bm, lo.z + bm, lo.w + bm,
                  hi.x + bm, hi.y + bm, hi.z + bm, hi.w + bm};
    const long long o = ((long long)b * M + m) * T + t;
    if (vec && t + 8 <= T) {
      if (res) {
        const int4 rv = *reinterpret_cast<const int4*>(res + o);
        const bf16* re = reinterpret_cast<const bf16*>(&rv);
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] += __bfloat162float(re[k]);
      }
      __nv_bfloat162 p[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        p[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
      *reinterpret_cast<int4*>(out + o) =
          make_int4(*reinterpret_cast<const int*>(&p[0]),
                    *reinterpret_cast<const int*>(&p[1]),
                    *reinterpret_cast<const int*>(&p[2]),
                    *reinterpret_cast<const int*>(&p[3]));
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (t + k < T) {
          const float vk = res ? v[k] + __bfloat162float(res[o + k]) : v[k];
          out[o + k] = __float2bfloat16(vk);
        }
      }
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
    gn_conv_wgmma(const __grid_constant__ CUtensorMap wmap,
                  const __grid_constant__ CUtensorMap ymap, const void* bias,
                  int bias_bf, bf16* __restrict__ out, int M, int C, int T) {
  conv_gemm<1, BN>(&wmap, &ymap, bias, bias_bf, nullptr, out, M, C, T);
}

template <int BN>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
    ts_res_block_wgmma(const __grid_constant__ CUtensorMap wmap,
                       const __grid_constant__ CUtensorMap ymap,
                       const void* bias, int bias_bf,
                       const bf16* __restrict__ res, bf16* __restrict__ out,
                       int C, int T) {
  conv_gemm<3, BN>(&wmap, &ymap, bias, bias_bf, res, out, C, C, T);
}

// lets Kernel take `bytes` of dynamic shared memory (set once for the
// largest size asked so far; the port drives one card)
template <auto Kernel>
int allow_smem(int bytes) {
  static int allowed = 0;
  if (bytes <= allowed) return 0;
  const int rc = static_cast<int>(cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  if (rc == 0) allowed = bytes;
  return rc;
}

// the normalise kernel into y (B, T, C): a cluster of two blocks a
// (batch, group) where the groups are too few for two blocks an SM and
// the halves stay multiples of 16 channels (whole sectors of Y; in fp32
// clusters of four blocks of 8 channels ran slower on an H100)
template <typename TX>
int run_norm(const NormArgs<TX>& a, cudaStream_t st) {
  const int per = a.C / a.G, groups = a.B * a.G;
  const int cl = groups < 2 * 132 && per % 32 == 0 ? 2 : 1;
  const int ps = per / cl;
  const long long prm = 16LL * ((ps + 3) & ~3);
  const long long cached = prm + (long long)sizeof(TX) * ps * a.T;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(groups * cl);
  cfg.blockDim = dim3(NORM_THREADS);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int rc;
  if (cached <= NORM_CACHE_MAX) {
    cfg.dynamicSmemBytes = cached;
    rc = allow_smem<group_norm_act<TX, true>>((int)cached);
    if (!rc) rc = cudaLaunchKernelEx(&cfg, group_norm_act<TX, true>, a);
  } else {
    cfg.dynamicSmemBytes = prm;
    rc = allow_smem<group_norm_act<TX, false>>((int)prm);
    if (!rc) rc = cudaLaunchKernelEx(&cfg, group_norm_act<TX, false>, a);
  }
  return rc ? rc : static_cast<int>(cudaGetLastError());
}

// the GEMM over y (B, T, C): w is (taps, M, C), out (B, M, T), res null or
// (B, M, T)
int run_gemm(const bf16* w, const bf16* y, const void* bias, int bias_bf,
             const bf16* res, bf16* out, int B, int C, int T, int M, int taps,
             int bn, cudaStream_t st) {
  CUtensorMap wmap, ymap;
  if (int rc = tensor_map_3d(&wmap, w, C, M, taps, 2ull * C, 2ull * C * M,
                             BK, BM))
    return rc;
  if (int rc = tensor_map_3d(&ymap, y, C, T, B, 2ull * C, 2ull * C * T, BK,
                             bn))
    return rc;
  const dim3 grid((T + bn - 1) / bn, (M + BM - 1) / BM, B);
  int rc = 0;
#define TTS_LAUNCH(BN_)                                                     \
  if (taps == 3) {                                                          \
    rc = allow_smem<ts_res_block_wgmma<BN_>>(Ring<BN_>::SMEM);              \
    if (!rc)                                                                \
      ts_res_block_wgmma<BN_><<<grid, GEMM_THREADS, Ring<BN_>::SMEM, st>>>( \
          wmap, ymap, bias, bias_bf, res, out, C, T);                       \
  } else {                                                                  \
    rc = allow_smem<gn_conv_wgmma<BN_>>(Ring<BN_>::SMEM);                   \
    if (!rc)                                                                \
      gn_conv_wgmma<BN_><<<grid, GEMM_THREADS, Ring<BN_>::SMEM, st>>>(      \
          wmap, ymap, bias, bias_bf, out, M, C, T);                         \
  }
  if (bn == 64) {
    TTS_LAUNCH(64)
  } else {
    TTS_LAUNCH(128)
  }
#undef TTS_LAUNCH
  return rc ? rc : static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// fp32: the 3xTF32 wgmma GEMM
// ---------------------------------------------------------------------------

constexpr int TK = 32;                 // fp32 channels a K step (128 bytes)
constexpr int TA_BYTES = BM * TK * 4;  // the weight tile of a stage

template <int BN>
struct RingF {
  static constexpr int B_BYTES = BN * TK * 4;           // one Y box
  static constexpr int STAGE = TA_BYTES + 2 * B_BYTES;  // W | Y_hi | Y_lo
  static constexpr int BARS = STAGES * STAGE;           // full[], then empty[]
  static constexpr int SMEM = BARS + 2 * STAGES * 8 + 1024;
  // the epilogue tile's row stride in floats: 8 mod 32, so a warp's float2
  // stores of eight rows fall in distinct banks
  static constexpr int TS = BN + (40 - BN % 32) % 32;
  static_assert(B_BYTES % 1024 == 0, "Y boxes stay on the swizzle atom");
  static_assert(BM * TS * 4 <= BARS, "the epilogue tile fits the ring");
};

// The 3xTF32 GEMM's main loop: acc (this consumer warpgroup's 64 of the
// BM rows x BN steps) = the (taps, rows, K) fp32 weight's rows m0..
// against Y_b's steps n0.. from Y_hi and Y_lo (B, T, K), the K steps k0 ..
// k1 - 1 of the TAPS * ceil(K / TK), each TK deep; TAPS = 3: tap s against
// Y shifted by s - 1 steps.  Every thread of the block calls it (the
// producer warpgroup's issue the copies, then return with acc untouched).
// base: the ring, 1024-aligned.
template <int TAPS, int BN>
__device__ __forceinline__ void tf32_mainloop(
    const CUtensorMap* wmap, const CUtensorMap* hmap, const CUtensorMap* lmap,
    int K, int m0, int n0, int b, int k0, int k1, uint32_t base,
    float (&acc)[BN / 2]) {
  extern __shared__ unsigned char gemm_smem[];
  using L = RingF<BN>;
  unsigned char* const ring = gemm_smem + (base - smem_u32(gemm_smem));
  const uint32_t full0 = base + L::BARS, empty0 = full0 + STAGES * 8;
  const int tid = threadIdx.x, wg = tid / 128;
  const int kc = (K + TK - 1) / TK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2);   // one arrival per consumer warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  if (wg == 2) {   // producer: one thread keeps the ring full
    if (tid == 256) {
      for (int it = k0; it < k1; ++it) {
        const int i = it - k0, s = i % STAGES;
        mbar_wait(empty0 + 8 * s, ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * s, L::STAGE);
        const int tap = it / kc, c0 = (it - tap * kc) * TK;
        const int t0 = n0 + (TAPS == 3 ? tap - 1 : 0);
        const uint32_t sa = base + s * L::STAGE;
        tma_load_3d(sa, wmap, full0 + 8 * s, c0, m0, tap);
        tma_load_3d(sa + TA_BYTES, hmap, full0 + 8 * s, c0, t0, b);
        tma_load_3d(sa + TA_BYTES + L::B_BYTES, lmap, full0 + 8 * s, c0, t0,
                    b);
      }
    }
  } else {
    // this thread's A fragment rows (wgmma_tf32_rs) in the warpgroup's 64
    // rows of the weight tile, and its channel within each 4-channel half
    const int lane = tid % 32;
    const int r0 = wg * 64 + ((tid % 128) / 32) * 16 + lane / 4;
    const int kq = lane % 4;
    for (int it = k0; it < k1; ++it) {
      const int i = it - k0, s = i % STAGES;
      mbar_wait(full0 + 8 * s, (i / STAGES) & 1);
      const float* wt =
          reinterpret_cast<const float*>(ring + s * L::STAGE);
      // the 128-byte swizzle: row r's 16-byte chunk j lies at chunk
      // j ^ (r % 8); rows r0 and r0 + 8 share r % 8
      uint32_t hi[TK / 8][4], lo[TK / 8][4];
#pragma unroll
      for (int kk = 0; kk < TK / 8; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = r0 + 8 * (q & 1), k = 8 * kk + kq + 4 * (q >> 1);
          const float v = wt[r * TK + (((k >> 2) ^ (r & 7)) << 2) + (k & 3)];
          const float h = tf32_hi(v);
          hi[kk][q] = __float_as_uint(h);
          lo[kk][q] = __float_as_uint(__fsub_rn(v, h));
        }
      const uint32_t sh = base + s * L::STAGE + TA_BYTES;
      const uint32_t sl = sh + L::B_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TK / 8; ++kk) {
        wgmma_tf32_rs<BN>(acc, lo[kk], desc_sw128(sh + kk * 32, 16, 1024));
        wgmma_tf32_rs<BN>(acc, hi[kk], desc_sw128(sl + kk * 32, 16, 1024));
        wgmma_tf32_rs<BN>(acc, hi[kk], desc_sw128(sh + kk * 32, 16, 1024));
      }
      wgmma_commit();
      wgmma_wait<0>();
      if (tid % 128 == 0) mbar_arrive(empty0 + 8 * s);
    }
  }
}

// out[b] = W * Y_b + bias (+ res[b]) in fp32 from Y_hi and Y_lo (B, T, C)
// on the 3xTF32 products; TAPS = 3: tap s of the (3, M, C) weight against
// Y shifted by s - 1 steps.  Block (x, y, z) = (n tile * split + K slice,
// m tile, b); the `split` blocks of a cluster share the output tile and
// each walks its own K slice.
template <int TAPS, int BN>
__device__ __forceinline__ void conv_gemm_tf32(
    const CUtensorMap* wmap, const CUtensorMap* hmap, const CUtensorMap* lmap,
    const void* bias, int bias_bf, const float* __restrict__ res,
    float* __restrict__ out, int M, int C, int T, int split) {
  namespace cg = cooperative_groups;
  using L = RingF<BN>;
  extern __shared__ unsigned char gemm_smem[];
  const uint32_t base = (smem_u32(gemm_smem) + 1023) & ~1023u;
  unsigned char* const ring = gemm_smem + (base - smem_u32(gemm_smem));
  const int tid = threadIdx.x, wg = tid / 128;
  const int ks = blockIdx.x % split, n0 = (blockIdx.x / split) * BN;
  const int m0 = blockIdx.y * BM, b = blockIdx.z;
  const int kt = TAPS * ((C + TK - 1) / TK);
  const int k0 = ks * kt / split, k1 = (ks + 1) * kt / split;

  float acc[BN / 2];
  tf32_mainloop<TAPS, BN>(wmap, hmap, lmap, C, m0, n0, b, k0, k1, base, acc);

  // Epilogue: every block's partial tile to its shared memory over the
  // ring (every stage consumed), then each block of the cluster sums its
  // share of the rows over the cluster's tiles in rank order, adds the
  // bias (and the residual) and stores whole rows of T.
  constexpr int TS = L::TS;
  float* tile = reinterpret_cast<float*>(ring);
  __syncthreads();
  if (wg < 2) {
    const int w = (tid % 128) / 32, lane = tid % 32;
    const int r0 = wg * 64 + w * 16 + lane / 4;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        *reinterpret_cast<float2*>(tile + (r0 + 8 * h) * TS + 8 * j +
                                   2 * (lane % 4)) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
  cg::cluster_group cluster = cg::this_cluster();
  if (split > 1)
    cluster.sync();
  else
    __syncthreads();
  const int rows = (BM + split - 1) / split;
  const int ra = ks * rows, rb = min(BM, ra + rows);
  for (int i = tid; i < (rb - ra) * BN; i += GEMM_THREADS) {
    const int r = ra + i / BN, c = i % BN;
    const int m = m0 + r, t = n0 + c;
    if (m >= M || t >= T) continue;
    float v = 0.f;
    for (int q = 0; q < split; ++q)
      v += (split > 1 ? cluster.map_shared_rank(tile, q) : tile)[r * TS + c];
    v += ld(bias, m, bias_bf);
    const long long o = ((long long)b * M + m) * T + t;
    if (res) v += res[o];
    out[o] = v;
  }
  if (split > 1) cluster.sync();   // no block leaves while its tile is read
}

template <int BN>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
    gn_conv_tf32(const __grid_constant__ CUtensorMap wmap,
                 const __grid_constant__ CUtensorMap hmap,
                 const __grid_constant__ CUtensorMap lmap, const void* bias,
                 int bias_bf, float* __restrict__ out, int M, int C, int T,
                 int split) {
  conv_gemm_tf32<1, BN>(&wmap, &hmap, &lmap, bias, bias_bf, nullptr, out, M,
                        C, T, split);
}

template <int BN>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
    ts_res_block_tf32(const __grid_constant__ CUtensorMap wmap,
                      const __grid_constant__ CUtensorMap hmap,
                      const __grid_constant__ CUtensorMap lmap,
                      const void* bias, int bias_bf,
                      const float* __restrict__ res, float* __restrict__ out,
                      int C, int T, int split) {
  conv_gemm_tf32<3, BN>(&wmap, &hmap, &lmap, bias, bias_bf, res, out, C, C, T,
                        split);
}

template <auto Kernel, typename... Args>
int launch_tf32(dim3 grid, int split, int smem, cudaStream_t st,
                Args... args) {
  if (int rc = allow_smem<Kernel>(smem)) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(GEMM_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, Kernel, args...));
}

// the 3xTF32 GEMM over Y_hi, Y_lo (B, T, C): w is (taps, M, C) fp32, out
// (B, M, T), res null or (B, M, T); bn 64, 104 or 128, split 1 to 8 (at
// most the K steps)
int run_gemm_tf32(const float* w, const float* yhi, const float* ylo,
                  const void* bias, int bias_bf, const float* res, float* out,
                  int B, int C, int T, int M, int taps, int bn, int split,
                  cudaStream_t st) {
  constexpr CUtensorMapDataType F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  if (split < 1 || split > 8 || split > taps * ((C + TK - 1) / TK))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap wmap, hmap, lmap;
  if (int rc = tensor_map_3d(&wmap, w, C, M, taps, 4ull * C, 4ull * C * M,
                             TK, BM, F32))
    return rc;
  if (int rc = tensor_map_3d(&hmap, yhi, C, T, B, 4ull * C, 4ull * C * T, TK,
                             bn, F32))
    return rc;
  if (int rc = tensor_map_3d(&lmap, ylo, C, T, B, 4ull * C, 4ull * C * T, TK,
                             bn, F32))
    return rc;
  const dim3 grid((T + bn - 1) / bn * split, (M + BM - 1) / BM, B);
  int rc;
#define TTS_LAUNCH_TF32(BN_)                                                 \
  if (taps == 3)                                                             \
    rc = launch_tf32<ts_res_block_tf32<BN_>>(grid, split, RingF<BN_>::SMEM,  \
                                             st, wmap, hmap, lmap, bias,     \
                                             bias_bf, res, out, C, T,        \
                                             split);                         \
  else                                                                       \
    rc = launch_tf32<gn_conv_tf32<BN_>>(grid, split, RingF<BN_>::SMEM, st,   \
                                        wmap, hmap, lmap, bias, bias_bf,     \
                                        out, M, C, T, split);
  if (bn == 64) {
    TTS_LAUNCH_TF32(64)
  } else if (bn == 104) {
    TTS_LAUNCH_TF32(104)
  } else if (bn == 128) {
    TTS_LAUNCH_TF32(128)
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TTS_LAUNCH_TF32
  return rc ? rc : static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// The backwards: K4's and K5's gradients under autograd
// ---------------------------------------------------------------------------

__device__ __forceinline__ void st(void* p, long long i, float v, int bf) {
  if (bf)
    static_cast<bf16*>(p)[i] = __float2bfloat16(v);
  else
    static_cast<float*>(p)[i] = v;
}

template <typename TX>
__device__ __forceinline__ TX from_f(float v);
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}

// What the backward's kernels share.  A tile of dn leaves NS sums a
// channel: sum dn and sum dn x^ (K5 also sum dz n and sum dz).
template <typename TX>
struct BwdArgs {
  const TX* x;          // (B, C, T): K4's x, K5's h
  const float* stats;   // the forward's mu (B*G), then rstd (B*G)
  Vecs v;               // gamma, beta; emb (B, 2C) (K5) or null
  TX* dn;               // (B, C, T): the gradient of n = gamma x^ + beta
  float* part;          // (B, ntt, NS, C): each time tile's channel sums
  int B, C, T, M, G, act, ntt;
};

// 16 bytes of TX values, loaded or stored as one piece
template <typename TX>
union Pack {
  int4 v;
  TX e[16 / sizeof(TX)];
};

// The da GEMM's epilogue: da of channels c0.. (ROWS rows) x steps t0..
// (COLS columns) in an fp32 shared-memory tile (row stride COLS + 8) ->
// dn, rounded to TX, and the tile's channel sums, all from fp32 values:
// x^ = (x - mu) rstd, n = gamma x^ + beta, z = n (K5: n (1 + scale) +
// shift), dz = da silu'(z) where act (else da), dn = dz (K5: dz (1 +
// scale)).  prm: 8 floats a row of shared memory for the rows' parameters.
// 256 threads (bar 1) take part: a thread a 16-byte piece of a row, its
// x pieces all loaded before any is used, the row's pieces on neighbouring
// lanes, their sums reduced by shuffles in a fixed order.
template <typename TX, bool FILM, int ROWS, int COLS>
__device__ void da_epilogue(const float* tile, float* prm, int c0, int t0,
                            int b, int tt, const BwdArgs<TX>& a) {
  constexpr int NS = FILM ? 4 : 2, E = 16 / sizeof(TX), CPR = COLS / E;
  constexpr int TS = COLS + 8, U = ROWS * CPR / 256;
  static_assert(ROWS * CPR % 256 == 0 && CPR <= 32, "whole warps a pass");
  const int tid = threadIdx.x, per = a.C / a.G;
  for (int r = tid; r < ROWS; r += 256) {
    const int c = min(c0 + r, a.C - 1);   // rows past C are never stored
    const int bg = b * a.G + c / per;
    float* q = prm + 8 * r;
    q[0] = a.stats[bg];
    q[1] = a.stats[a.B * a.G + bg];
    q[2] = ld(a.v.gamma, c, a.v.bf);
    q[3] = ld(a.v.beta, c, a.v.bf);
    q[4] = 1.f;
    q[5] = 0.f;
    if constexpr (FILM) {
      const long long e = 2LL * b * a.C + c;
      q[4] = 1.f + ld(a.v.emb, e, a.v.emb_bf);
      q[5] = ld(a.v.emb, e + a.C, a.v.emb_bf);
    }
  }
  consumers_sync();
  const bool vec = a.T % E == 0 &&
                   ((reinterpret_cast<uintptr_t>(a.x) |
                     reinterpret_cast<uintptr_t>(a.dn)) & 15) == 0;
  Pack<TX> xin[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = tid + 256 * u, c = c0 + i / CPR, t = t0 + (i % CPR) * E;
    if (vec && c < a.C && t < a.T)
      xin[u].v = *reinterpret_cast<const int4*>(
          a.x + ((long long)b * a.C + c) * a.T + t);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = tid + 256 * u, r = i / CPR, j0 = (i % CPR) * E;
    const int c = c0 + r, t = t0 + j0;
    float s[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) s[k] = 0.f;
    if (c < a.C && t < a.T) {
      const float* q = prm + 8 * r;
      const long long o = ((long long)b * a.C + c) * a.T + t;
      Pack<TX> out;
#pragma unroll
      for (int k = 0; k < E; ++k) {
        const bool in = t + k < a.T;
        const float xv = vec ? to_f(xin[u].e[k])
                             : (in ? to_f(a.x[o + k]) : 0.f);
        const float xh = (xv - q[0]) * q[1];
        const float n = xh * q[2] + q[3];
        const float z = FILM ? n * q[4] + q[5] : n;
        float dz = tile[r * TS + j0 + k];
        if (a.act) {
          const float sg = 1.f / (1.f + expf(-z));
          dz *= sg * (1.f + z * (1.f - sg));
        }
        const float dn = FILM ? dz * q[4] : dz;
        out.e[k] = from_f<TX>(dn);
        if (in) {
          s[0] += dn;
          s[1] += dn * xh;
          if constexpr (FILM) {
            s[2] += dz * n;
            s[3] += dz;
          }
        }
      }
      if (vec) {
        *reinterpret_cast<int4*>(a.dn + o) = out.v;
      } else {
#pragma unroll
        for (int k = 0; k < E; ++k)
          if (t + k < a.T) a.dn[o + k] = out.e[k];
      }
    }
#pragma unroll
    for (int k = 0; k < NS; ++k)
#pragma unroll
      for (int o = CPR / 2; o > 0; o >>= 1)
        s[k] += __shfl_xor_sync(0xffffffffu, s[k], o);
    if (tid % CPR == 0 && c < a.C)
#pragma unroll
      for (int k = 0; k < NS; ++k)
        a.part[(((long long)b * a.ntt + tt) * NS + k) * a.C + c] = s[k];
  }
}

// K4's bf16 da = W^T g as the forward's GEMM: the transposed weight wb
// (1, C, M) against the time-major upstream gt (B, T, M), K = M; GT (T %
// 8 == 0): against the upstream g (B, M, T) as it comes, an MN-major B; a
// block's 128 channels x BN steps, then da_epilogue over the tile.  (K5's
// is bwd_da_pingpong, below.)
template <int BN, bool GT>
__global__ void __launch_bounds__(GEMM_THREADS, BN == 64 ? 2 : 1)
    bwd_da_wgmma(const __grid_constant__ CUtensorMap wmap,
                 const __grid_constant__ CUtensorMap gmap,
                 const BwdArgs<bf16> a) {
  extern __shared__ unsigned char gemm_smem[];
  const uint32_t base = (smem_u32(gemm_smem) + 1023) & ~1023u;
  const int n0 = blockIdx.x * BN, c0 = blockIdx.y * BM, b = blockIdx.z;
  float acc[BN / 2];
  if (!ring_mainloop<1, BN, GT>(&wmap, &gmap, a.M, c0, n0, b, base, acc))
    return;
  const float* tile = acc_to_tile<BN>(acc, base);
  // the rows' parameters after the tile, in the ring
  float* prm = reinterpret_cast<float*>(gemm_smem + (base - smem_u32(gemm_smem))
                                        + BM * (BN + 8) * 4);
  da_epilogue<bf16, false, BM, BN>(tile, prm, c0, n0, b, blockIdx.x, a);
}

// K5's bf16 da (three taps), persistent and warp-specialised, one block
// an SM.  Block i walks the 128-channel x 128-step output tiles t = i, i +
// gridDim.x, ... (batch-major, then the time tiles, then the channel
// blocks: the blocks that run together read one batch's upstream).  One
// producer thread keeps a ring of PP_STAGES stages full by TMA: per K
// step, the two 64-channel x 64-row boxes of w_taps[2 - s'] (the
// forward's tap-major weight, read MN-major by wgmma's transpose bit: no
// transposed, reversed copy of it) and the time-major upstream's box of
// 128 steps shifted by s' - 1.  Two consumer warpgroups take the block's
// tiles in turn (ping-pong), each a whole 128 x 128 tile (two m64n128
// products a 16-deep slice, 128 accumulators a thread): a warpgroup
// starts a tile's main loop once the other has issued its last products
// (a named barrier each way), so their ring uses never overlap and no
// parity wait can pass a phase early, and its epilogue then runs beside
// the other's main loop, straight from the accumulators: x's 32 values of
// a half tile loaded first (their loads in flight together), then
// silu'(z) (1 + scale) into dn (bf16 pairs, the upstream's element order)
// and each row's channel sums over the tile's steps (dn, dn x^, dz n, dz:
// a thread's 32 values in order, then its quad's four partials by
// shuffles), the four rows' parameters loaded before the main loop.
// On an H100 the epilogue's global loads and stores, not its arithmetic,
// hold it above its main loop's time (PERF.md); a cluster of two
// blocks sharing the weight tile by TMA multicast, other ring depths,
// streaming cache hints and x and dn staged through shared memory for
// whole-row copies were no faster there.
constexpr int PP_BN = 128;                    // steps a tile
constexpr int PP_STAGES = 6;
constexpr int PP_A = BM * BK * 2;             // two 64 x 64 weight boxes
constexpr int PP_STAGE = PP_A + PP_BN * BK * 2;
constexpr int PP_BARS = PP_STAGES * PP_STAGE;  // full[], then empty[]
constexpr int PP_SMEM = PP_BARS + 2 * PP_STAGES * 8 + 1024;
constexpr int PP_PRODUCER_REGS = 40;          // setmaxnreg: 40 x 128 +
constexpr int PP_CONSUMER_REGS = 232;         // 232 x 256 = 168 x 384

template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// the warpgroups' turns: warpgroup w arrives on barrier 2 + w once it has
// issued a tile's last products; the other waits there before its next
__device__ __forceinline__ void turn_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

// tile t: (batch b, 128-step tile tt, 128-channel block cb)
__device__ __forceinline__ void pp_tile(int t, int nt, int nc, int& b,
                                        int& tt, int& cb) {
  b = t / (nt * nc);
  tt = (t / nc) % nt;
  cb = t % nc;
}

__global__ void __launch_bounds__(GEMM_THREADS, 1)
    bwd_da_pingpong(const __grid_constant__ CUtensorMap wmap,
                    const __grid_constant__ CUtensorMap gmap,
                    const BwdArgs<bf16> a) {
  extern __shared__ unsigned char gemm_smem[];
  const uint32_t base = (smem_u32(gemm_smem) + 1023) & ~1023u;
  const uint32_t full0 = base + PP_BARS, empty0 = full0 + PP_STAGES * 8;
  const int tid = threadIdx.x;
  // warp-uniform to the compiler (a shuffle): a branch on it does not
  // serialise the products
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int C = a.C, T = a.T;
  const int nc = (C + BM - 1) / BM, nt = (T + PP_BN - 1) / PP_BN;
  const int tiles = a.B * nt * nc, kc = (a.M + BK - 1) / BK, kt = 3 * kc;

  if (tid == 0) {
    for (int s = 0; s < PP_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 1);   // the one warpgroup that used it
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {   // producer
    regs_dec<PP_PRODUCER_REGS>();
    if (tid == 256) {
      int n = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int b, tt, cb;
        pp_tile(t, nt, nc, b, tt, cb);
        for (int it = 0; it < kt; ++it, ++n) {
          const int s = n % PP_STAGES;
          mbar_wait(empty0 + 8 * s, ((n / PP_STAGES) & 1) ^ 1);
          mbar_expect_tx(full0 + 8 * s, PP_STAGE);
          const int tap = it / kc, k0 = (it - tap * kc) * BK;
          const uint32_t sa = base + s * PP_STAGE, bar = full0 + 8 * s;
          tma_load_3d(sa, &wmap, bar, BM * cb, k0, 2 - tap);
          tma_load_3d(sa + PP_A / 2, &wmap, bar, BM * cb + 64, k0, 2 - tap);
          tma_load_3d(sa + PP_A, &gmap, bar, k0, PP_BN * tt + tap - 1, b);
        }
      }
    }
    return;
  }
  regs_inc<PP_CONSUMER_REGS>();

  const int w = (tid & 127) >> 5, lane = tid & 31, g = lane >> 2;
  const int t4 = lane & 3, per = C / a.G;
  const bool pairs = T % 2 == 0 &&
                     ((reinterpret_cast<uintptr_t>(a.x) |
                       reinterpret_cast<uintptr_t>(a.dn)) & 3) == 0;
  int j = wg;   // the block's tile index: this warpgroup takes j, j + 2, ...
  for (int t = blockIdx.x + wg * gridDim.x; t < tiles;
       t += 2 * gridDim.x, j += 2) {
    int b, tt, cb;
    pp_tile(t, nt, nc, b, tt, cb);
    const int c0 = BM * cb, n0 = PP_BN * tt;
    // this thread's rows c0 + 64 h + 16 w + g + 8 hh (i = 2 h + hh): mu,
    // rstd, gamma, beta, 1 + scale, shift
    float q[4][6];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = min(c0 + 64 * (i / 2) + 16 * w + g + 8 * (i % 2), C - 1);
      const int bg = b * a.G + c / per;
      const long long e = 2LL * b * C + c;
      q[i][0] = a.stats[bg];
      q[i][1] = a.stats[a.B * a.G + bg];
      q[i][2] = ld(a.v.gamma, c, a.v.bf);
      q[i][3] = ld(a.v.beta, c, a.v.bf);
      q[i][4] = 1.f + ld(a.v.emb, e, a.v.emb_bf);
      q[i][5] = ld(a.v.emb, e + C, a.v.emb_bf);
    }

    float acc[2][64];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
    if (j > 0) turn_wait(3 - wg);   // the other's last tile is issued
    int n = j * kt, prev = 0;
    for (int it = 0; it < kt; ++it, ++n) {
      const int s = n % PP_STAGES;
      mbar_wait(full0 + 8 * s, (n / PP_STAGES) & 1);
      const uint32_t sa = base + s * PP_STAGE, sb = sa + PP_A;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t db = desc_sw128(sb + kk * 32, 16, 1024);
        wgmma_n128<0, 1>(acc[0], desc_sw128(sa + kk * 2048, 16, 1024), db);
        wgmma_n128<0, 1>(acc[1],
                         desc_sw128(sa + PP_A / 2 + kk * 2048, 16, 1024), db);
      }
      wgmma_commit();
      wgmma_wait<1>();   // the previous step's products are done
      if (it > 0 && (tid & 127) == 0) mbar_arrive(empty0 + 8 * prev);
      prev = s;
    }
    if (t + (int)gridDim.x < tiles) turn_arrive(2 + wg);
    wgmma_wait<0>();
    if ((tid & 127) == 0) mbar_arrive(empty0 + 8 * prev);
    reg_fence(acc[0]);
    reg_fence(acc[1]);

    // the epilogue: acc[h][4 jj + 2 hh + e] is row 2 h + hh, step n0 + 8
    // jj + 2 t4 + e; x's values of a half tile first, so their loads are
    // in flight together, then dn and the sums
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      __nv_bfloat162 xr[2][16];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int c = c0 + 64 * h + 16 * w + g + 8 * hh;
        const bf16* xrow = a.x + ((long long)b * C + min(c, C - 1)) * T;
#pragma unroll
        for (int jj = 0; jj < 16; ++jj) {
          const int t0 = n0 + 8 * jj + 2 * t4;
          if (c < C && pairs && t0 < T) {
            xr[hh][jj] = *reinterpret_cast<const __nv_bfloat162*>(xrow + t0);
          } else {
            const bf16 z0 = __float2bfloat16(0.f);
            xr[hh][jj] =
                __halves2bfloat162(c < C && t0 < T ? xrow[t0] : z0,
                                   c < C && t0 + 1 < T ? xrow[t0 + 1] : z0);
          }
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = 2 * h + hh;
        const int c = c0 + 64 * h + 16 * w + g + 8 * hh;
        const bool row = c < C;
        bf16* dnrow = a.dn + ((long long)b * C + c) * T;
        float sm[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int jj = 0; jj < 16; ++jj) {
          const int t0 = n0 + 8 * jj + 2 * t4;
          const float xv[2] = {__low2float(xr[hh][jj]),
                               __high2float(xr[hh][jj])};
          float dn[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float xh = (xv[e] - q[i][0]) * q[i][1];
            const float nv = xh * q[i][2] + q[i][3];
            const float z = nv * q[i][4] + q[i][5];
            float dz = acc[h][4 * jj + 2 * hh + e];
            const float sg = __frcp_rn(1.f + __expf(-z));
            dz *= sg * (1.f + z * (1.f - sg));
            dn[e] = dz * q[i][4];
            if (row && t0 + e < T) {
              sm[0] += dn[e];
              sm[1] += dn[e] * xh;
              sm[2] += dz * nv;
              sm[3] += dz;
            }
          }
          if (row && pairs && t0 < T) {
            *reinterpret_cast<__nv_bfloat162*>(dnrow + t0) =
                __floats2bfloat162_rn(dn[0], dn[1]);
          } else if (row) {
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (t0 + e < T) dnrow[t0 + e] = __float2bfloat16(dn[e]);
          }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          sm[k] += __shfl_xor_sync(0xffffffffu, sm[k], 1);
          sm[k] += __shfl_xor_sync(0xffffffffu, sm[k], 2);
        }
        if (row && t4 == 0)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            a.part[(((long long)b * a.ntt + tt) * 4 + k) * C + c] = sm[k];
      }
    }
  }
}

constexpr int DW_BK = 64;                   // steps a K step
constexpr int DW_BOX = 64 * DW_BK * 2;      // one 64-wide box, 8 KB
constexpr int DW_STAGE = 4 * DW_BOX;        // gt's two boxes | Y's two
constexpr int DW_BARS = STAGES * DW_STAGE;  // full[], then empty[]
constexpr int DW_SMEM = DW_BARS + 2 * STAGES * 8 + 1024;

// bf16 dW: part[q, tap] (M x C, fp32) = the sum over the q-th of `split`
// slices of the (batch, 64-step tile) pairs of gt_b^T (M x steps) Y_b
// (steps x C), Y shifted by tap - 1 steps (TAPS = 3).  Block (x, y, z) =
// (128 channels, 128 rows of M, tap * split + q).  Both operands are
// MN-major (M and C contiguous in the time-major arrays), both TMA boxes
// 64 wide; each consumer warpgroup takes 64 rows and one m64n128 product a
// 16-step slice (two m64n64 products read 33% more shared memory, which
// about matches the tensor cores' time).  GT (K4 at T % 8 == 0): A is the
// upstream g (B, M, T) as it comes, K-major (64 steps x 64 rows a box),
// and the channel blocks (x) split the rows of their A tiles between them
// to sum into dbp[q] (M): db's partial over the slice, in step order.
template <int TAPS, bool GT>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
    bwd_dw_wgmma(const __grid_constant__ CUtensorMap gmap,
                 const __grid_constant__ CUtensorMap ymap,
                 float* __restrict__ part, float* __restrict__ dbp, int B,
                 int M, int C, int T, int split) {
  extern __shared__ unsigned char gemm_smem[];
  const uint32_t base = (smem_u32(gemm_smem) + 1023) & ~1023u;
  const uint32_t full0 = base + DW_BARS, empty0 = full0 + STAGES * 8;
  const int tid = threadIdx.x, wg = tid / 128;
  const int c0 = blockIdx.x * 128, m0 = blockIdx.y * 128;
  const int tap = blockIdx.z / split, q = blockIdx.z % split;
  const int ntt = (T + DW_BK - 1) / DW_BK, kt = B * ntt;
  const int k0 = (int)((long long)q * kt / split);
  const int k1 = (int)((long long)(q + 1) * kt / split);
  const int shift = TAPS == 3 ? tap - 1 : 0;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    if (tid == 256) {
      for (int it = k0; it < k1; ++it) {
        const int i = it - k0, s = i % STAGES;
        mbar_wait(empty0 + 8 * s, ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * s, DW_STAGE);
        const int bb = it / ntt, t0 = (it - bb * ntt) * DW_BK;
        const uint32_t sa = base + s * DW_STAGE, bar = full0 + 8 * s;
        if constexpr (GT) {
          tma_load_3d(sa, &gmap, bar, t0, m0, bb);
          tma_load_3d(sa + DW_BOX, &gmap, bar, t0, m0 + 64, bb);
        } else {
          tma_load_3d(sa, &gmap, bar, m0, t0, bb);
          tma_load_3d(sa + DW_BOX, &gmap, bar, m0 + 64, t0, bb);
        }
        tma_load_3d(sa + 2 * DW_BOX, &ymap, bar, c0, t0 + shift, bb);
        tma_load_3d(sa + 3 * DW_BOX, &ymap, bar, c0 + 64, t0 + shift, bb);
      }
    }
    return;
  }

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  // db's share (GT): block x of the gridDim.x channel blocks sums rows
  // [x rpb, (x + 1) rpb) of the 128-row A tiles; a thread the 16-byte chunk
  // tid % 8 of the rows lo + (tid % 128) / 8 + 16 k of its warpgroup's
  const int rpb = (128 + gridDim.x - 1) / gridDim.x;
  const int lo = max((int)blockIdx.x * rpb, wg * 64);
  const int hi = min(((int)blockIdx.x + 1) * rpb, wg * 64 + 64);
  const int ci = tid % 8, ri = lo + (tid % 128) / 8;
  const bool sums = GT && lo < hi;
  float dsum[4] = {0.f, 0.f, 0.f, 0.f};
  int prev = 0;
  for (int it = k0; it < k1; ++it) {
    const int i = it - k0, s = i % STAGES;
    mbar_wait(full0 + 8 * s, (i / STAGES) & 1);
    const uint32_t sa = base + s * DW_STAGE + wg * DW_BOX;
    const uint32_t sb = base + s * DW_STAGE + 2 * DW_BOX;
    if (sums) {   // read before this step's products are issued: the
                  // stage is released once they are done
      const unsigned char* tile = gemm_smem + (sa - smem_u32(gemm_smem));
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = ri + 16 * k - wg * 64;   // the row in this A tile
        if (ri + 16 * k < hi) {
          const int4 v = *reinterpret_cast<const int4*>(
              tile + r * 128 + ((ci ^ (r & 7)) << 4));
          const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
          for (int u = 0; u < 8; ++u) dsum[k] += __bfloat162float(e[u]);
        }
      }
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DW_BK / 16; ++kk) {
      if constexpr (GT)
        wgmma_n128<1>(acc, desc_sw128(sa + kk * 32, 16, 1024),
                      desc_sw128(sb + kk * 2048, DW_BOX, 1024));
      else
        wgmma_n128_tt(acc, desc_sw128(sa + kk * 2048, 16, 1024),
                      desc_sw128(sb + kk * 2048, DW_BOX, 1024));
    }
    wgmma_commit();
    wgmma_wait<1>();   // the previous step's products are done
    if (i > 0 && tid % 128 == 0) mbar_arrive(empty0 + 8 * prev);
    prev = s;
  }
  wgmma_wait<0>();
  if (sums) {   // the row's 8 chunks, in a fixed order
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        dsum[k] += __shfl_xor_sync(0xffffffffu, dsum[k], o);
      const int m = m0 + ri + 16 * k;
      if (ci == 0 && ri + 16 * k < hi && m < M)
        dbp[(long long)q * M + m] = dsum[k];
    }
  }

  const int w = (tid % 128) / 32, lane = tid % 32;
  const int r0 = m0 + wg * 64 + w * 16 + lane / 4;
  float* dst = part + (long long)(q * TAPS + tap) * M * C;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = r0 + 8 * h;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = c0 + 8 * j + 2 * (lane % 4);
      if (c < C)
        *reinterpret_cast<float2*>(dst + (long long)m * C + c) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// fp32 da = W^T g on the forward's 3xTF32 main loop (tf32_mainloop): the
// reversed, transposed weight wb (taps, C, M), split in registers, against
// the split time-major upstream gt_hi, gt_lo (B, T, M), tap s' shifted by
// s' - 1 steps, K = M; a block's 128 channels x BN steps, then
// da_epilogue over the tile.
template <int TAPS, int BN>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
    bwd_da_tf32(const __grid_constant__ CUtensorMap wmap,
                const __grid_constant__ CUtensorMap hmap,
                const __grid_constant__ CUtensorMap lmap,
                const BwdArgs<float> a) {
  extern __shared__ unsigned char gemm_smem[];
  static_assert(BM * (BN + 8) * 4 + BM * 32 <= RingF<BN>::BARS,
                "the tile and its rows' parameters fit the ring");
  const uint32_t base = (smem_u32(gemm_smem) + 1023) & ~1023u;
  const int n0 = blockIdx.x * BN, c0 = blockIdx.y * BM, b = blockIdx.z;
  float acc[BN / 2];
  tf32_mainloop<TAPS, BN>(&wmap, &hmap, &lmap, a.M, c0, n0, b, 0,
                          TAPS * ((a.M + TK - 1) / TK), base, acc);
  if (threadIdx.x >= 256) return;   // the producer warpgroup
  const float* tile = acc_to_tile<BN>(acc, base);
  float* prm = reinterpret_cast<float*>(gemm_smem + (base - smem_u32(gemm_smem))
                                        + BM * (BN + 8) * 4);
  da_epilogue<float, TAPS == 3, BM, BN>(tile, prm, c0, n0, b, blockIdx.x, a);
}

constexpr int DWF_BN = 64;                     // rows of M a block
constexpr int DWF_A = BM * TK * 4;             // a's tile, four 4 KB boxes
constexpr int DWF_B = DWF_BN * TK * 4;         // a g box (hi or lo), 8 KB
constexpr int DWF_STAGE = DWF_A + 2 * DWF_B;   // a | g_hi | g_lo
constexpr int DWF_STAGES = 6;
constexpr int DWF_BARS = DWF_STAGES * DWF_STAGE;
constexpr int DWF_SMEM = DWF_BARS + 2 * DWF_STAGES * 8 + 1024;

// fp32 dW^T: part[q, tap] (M x C, fp32), transposed, = the sum over the
// q-th of `split` slices of the (batch, 32-step tile) pairs of Y_b^T
// (C x steps, Y shifted by tap - 1 steps) g_b^T (steps x M), in 3xTF32.
// Block (x, y, z) = (128 channels, 64 rows of M, tap * split + q).  TF32
// wgmma reads shared operands K-major only, so the reduction over the
// steps takes g as it comes, split (g_hi, g_lo (B, M, Tp): 64 rows of 32
// steps a box, K-major), and the time-major a (B, T, C) as the register A
// operand: each consumer thread reads its fragments of its warpgroup's 64
// channels across the stage's 32 steps from shared memory and splits them
// (the tap shift is an outer TMA coordinate of a).  Each stage's products
// go to a fresh accumulator added to the slice's in fp32: the tensor
// cores' accumulation is not round-to-nearest, and a slice chains up to
// 1120 stages.
template <int TAPS>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
    bwd_dw_tf32(const __grid_constant__ CUtensorMap ymap,
                const __grid_constant__ CUtensorMap hmap,
                const __grid_constant__ CUtensorMap lmap,
                float* __restrict__ part, int B, int M, int C, int T,
                int split) {
  extern __shared__ unsigned char gemm_smem[];
  const uint32_t base = (smem_u32(gemm_smem) + 1023) & ~1023u;
  const unsigned char* const ring = gemm_smem + (base - smem_u32(gemm_smem));
  const uint32_t full0 = base + DWF_BARS, empty0 = full0 + DWF_STAGES * 8;
  const int tid = threadIdx.x, wg = tid / 128;
  const int c0 = blockIdx.x * BM, m0 = blockIdx.y * DWF_BN;
  const int tap = blockIdx.z / split, q = blockIdx.z % split;
  const int ntt = (T + TK - 1) / TK, kt = B * ntt;
  const int k0 = (int)((long long)q * kt / split);
  const int k1 = (int)((long long)(q + 1) * kt / split);
  const int shift = TAPS == 3 ? tap - 1 : 0;

  if (tid == 0) {
    for (int s = 0; s < DWF_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    if (tid == 256) {
      for (int it = k0; it < k1; ++it) {
        const int i = it - k0, s = i % DWF_STAGES;
        mbar_wait(empty0 + 8 * s, ((i / DWF_STAGES) & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * s, DWF_STAGE);
        const int bb = it / ntt, t0 = (it - bb * ntt) * TK;
        const uint32_t sa = base + s * DWF_STAGE, bar = full0 + 8 * s;
#pragma unroll
        for (int j = 0; j < BM / 32; ++j)
          tma_load_3d(sa + j * 4096, &ymap, bar, c0 + 32 * j, t0 + shift, bb);
        tma_load_3d(sa + DWF_A, &hmap, bar, t0, m0, bb);
        tma_load_3d(sa + DWF_A + DWF_B, &lmap, bar, t0, m0, bb);
      }
    }
    return;
  }

  const int w = (tid % 128) / 32, lane = tid % 32, kq = lane % 4;
  // this thread's A rows (channels within the block's 128) r0 and r0 + 8
  const int r0 = wg * 64 + w * 16 + lane / 4;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  for (int it = k0; it < k1; ++it) {
    const int i = it - k0, s = i % DWF_STAGES;
    mbar_wait(full0 + 8 * s, (i / DWF_STAGES) & 1);
    const unsigned char* at = ring + s * DWF_STAGE;
    // a's element (step k, channel r): box r / 32, row k, 16-byte chunk
    // (r % 32) / 4 at chunk ((r % 32) / 4) ^ (k % 8)
    uint32_t hi[TK / 8][4], lo[TK / 8][4];
#pragma unroll
    for (int kk = 0; kk < TK / 8; ++kk)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = r0 + 8 * (u & 1), k = 8 * kk + kq + 4 * (u >> 1);
        const float v = *reinterpret_cast<const float*>(
            at + (r >> 5) * 4096 + k * 128 +
            ((((r & 31) >> 2) ^ (k & 7)) << 4) + (r & 3) * 4);
        const float h = tf32_hi(v);
        hi[kk][u] = __float_as_uint(h);
        lo[kk][u] = __float_as_uint(__fsub_rn(v, h));
      }
    const uint32_t sh = base + s * DWF_STAGE + DWF_A, sl = sh + DWF_B;
    float fresh[32];
#pragma unroll
    for (int x = 0; x < 32; ++x) fresh[x] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TK / 8; ++kk) {
      wgmma_tf32_rs<64>(fresh, lo[kk], desc_sw128(sh + kk * 32, 16, 1024));
      wgmma_tf32_rs<64>(fresh, hi[kk], desc_sw128(sl + kk * 32, 16, 1024));
      wgmma_tf32_rs<64>(fresh, hi[kk], desc_sw128(sh + kk * 32, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(fresh);
#pragma unroll
    for (int kk = 0; kk < TK / 8; ++kk) {
      reg_fence(hi[kk]);
      reg_fence(lo[kk]);
    }
    if (tid % 128 == 0) mbar_arrive(empty0 + 8 * s);
#pragma unroll
    for (int x = 0; x < 32; ++x) acc[x] += fresh[x];
  }

  // acc[4 j + 2 h + e] is channel c0 + r0 + 8 h, row m0 + 8 j + 2 (lane %
  // 4) + e of M: stored transposed, eight channels of a row contiguous
  float* dst = part + (long long)(q * TAPS + tap) * M * C;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = c0 + r0 + 8 * h;
    if (c >= C) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + 8 * j + 2 * kq + e;
        if (m < M) dst[(long long)m * C + c] = acc[4 * j + 2 * h + e];
      }
  }
}

// fp32: the upstream g (B, M, T) split for the 3xTF32 GEMMs, through a 64 x
// 64 tile read in 16-byte pieces (element by element where T's rows are
// off 16 bytes): gt_hi and gt_lo (B, T, M), time-major (da's B: K5's taps
// shift it along an outer coordinate), and g_hi and g_lo (B, M, Tp), Tp = T
// rounded up to 4, zeros past T (dW's B: rows on 16 bytes, as TMA reads
// them, at any T); each tile's row sums to dbp (B, ceil(T/64), M), db's
// partials, as bwd_transpose.
__global__ void __launch_bounds__(256)
    bwd_split_upstream(const float* __restrict__ g, float* __restrict__ gth,
                       float* __restrict__ gtl, float* __restrict__ gh,
                       float* __restrict__ gl, float* __restrict__ dbp,
                       int M, int T, int Tp) {
  __shared__ float s[64][65];
  const int t0 = blockIdx.x * 64, m0 = blockIdx.y * 64, b = blockIdx.z;
  const int tid = threadIdx.x;
  const bool vec = T % 4 == 0 && (reinterpret_cast<uintptr_t>(g) & 15) == 0;
  float4 in[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = tid + 256 * u, m = m0 + i / 16, t = t0 + (i % 16) * 4;
    const long long o = ((long long)b * M + m) * T + t;
    if (vec) {
      in[u] = m < M && t < T ? *reinterpret_cast<const float4*>(g + o)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      float e[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) e[k] = m < M && t + k < T ? g[o + k] : 0.f;
      in[u] = make_float4(e[0], e[1], e[2], e[3]);
    }
    if (m < M && t < Tp) {
      uint4 hi, lo;
      tf32_split4(in[u], hi, lo);
      const long long p = ((long long)b * M + m) * Tp + t;
      *reinterpret_cast<uint4*>(gh + p) = hi;
      *reinterpret_cast<uint4*>(gl + p) = lo;
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = tid + 256 * u, r = i / 16, j = (i % 16) * 4;
    s[r][j] = in[u].x;
    s[r][j + 1] = in[u].y;
    s[r][j + 2] = in[u].z;
    s[r][j + 3] = in[u].w;
  }
  __syncthreads();
  if (tid < 64 && m0 + tid < M) {
    float v = 0.f;
    for (int j = 0; j < 64; ++j) v += s[tid][j];
    dbp[((long long)b * gridDim.x + blockIdx.x) * M + m0 + tid] = v;
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = tid + 256 * u, r = i / 16, j = (i % 16) * 4;
    const int t = t0 + r, m = m0 + j;   // M % 8 == 0: whole pieces
    if (t < T && m < M) {
      uint4 hi, lo;
      tf32_split4(make_float4(s[j][r], s[j + 1][r], s[j + 2][r],
                              s[j + 3][r]), hi, lo);
      const long long p = ((long long)b * T + t) * M + m;
      *reinterpret_cast<uint4*>(gth + p) = hi;
      *reinterpret_cast<uint4*>(gtl + p) = lo;
    }
  }
}

// The upstream g (B, M, T) -> gt (B, T, M), time-major (the GEMMs' layout:
// K5's taps shift it along an outer coordinate), through a 64 x 64 tile
// read and written in 16-byte pieces (element by element where T's rows
// are off 16 bytes); each tile's row sums go to dbp (B, ceil(T/64), M),
// db's partials.
template <typename TX>
__global__ void __launch_bounds__(256)
    bwd_transpose(const TX* __restrict__ g, TX* __restrict__ gt,
                  float* __restrict__ dbp, int M, int T) {
  constexpr int E = 16 / sizeof(TX), CH = 64 / E, U = 64 * CH / 256;
  __shared__ float s[64][65];
  const int t0 = blockIdx.x * 64, m0 = blockIdx.y * 64, b = blockIdx.z;
  const int tid = threadIdx.x;
  const bool vec = T % E == 0 && (reinterpret_cast<uintptr_t>(g) & 15) == 0;
  Pack<TX> in[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = tid + 256 * u, m = m0 + i / CH, t = t0 + (i % CH) * E;
    const long long o = ((long long)b * M + m) * T + t;
    if (vec) {
      in[u].v = m < M && t < T ? *reinterpret_cast<const int4*>(g + o)
                               : make_int4(0, 0, 0, 0);
    } else {
#pragma unroll
      for (int k = 0; k < E; ++k)
        in[u].e[k] = m < M && t + k < T ? g[o + k] : from_f<TX>(0.f);
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = tid + 256 * u, r = i / CH, j = (i % CH) * E;
#pragma unroll
    for (int k = 0; k < E; ++k) s[r][j + k] = to_f(in[u].e[k]);
  }
  __syncthreads();
  if (tid < 64 && m0 + tid < M) {
    float v = 0.f;
    for (int j = 0; j < 64; ++j) v += s[tid][j];
    dbp[((long long)b * gridDim.x + blockIdx.x) * M + m0 + tid] = v;
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = tid + 256 * u, r = i / CH, j = (i % CH) * E;
    const int t = t0 + r, m = m0 + j;   // M % 8 == 0: whole pieces
    if (t < T && m < M) {
      Pack<TX> out;
#pragma unroll
      for (int k = 0; k < E; ++k) out.e[k] = from_f<TX>(s[j + k][r]);
      *reinterpret_cast<int4*>(gt + ((long long)b * T + t) * M + m) = out.v;
    }
  }
}

// a = the normalise kernel's Y, recomputed from the forward's statistics:
// x (B, C, T) -> y (B, T, C) time-major, through a 64-channel x 64-step
// tile, read and written in 16-byte pieces (element by element where T's
// rows are off 16 bytes).  norm_value with the forward's mu, rstd and
// channel parameters gives the bits the forward's GEMM read (fp32: Y,
// which is Y_hi + Y_lo exactly).
template <typename TX>
__global__ void __launch_bounds__(256)
    bwd_apply_norm(const TX* __restrict__ x, TX* __restrict__ y,
                   const float* __restrict__ stats, Vecs v, int C, int T,
                   int G, int B, int act) {
  constexpr int E = 16 / sizeof(TX), CH = 64 / E, U = 64 * CH / 256;
  __shared__ float s[64][65];
  __shared__ float q4[64][4];
  __shared__ float ms[64][2];
  const int t0 = blockIdx.x * 64, c0 = blockIdx.y * 64, b = blockIdx.z;
  const int tid = threadIdx.x, per = C / G;
  const bool film = v.emb != nullptr;
  if (tid < 64) {
    const int c = min(c0 + tid, C - 1);
    const long long e = 2LL * b * C + c;
    const int bg = b * G + c / per;
    q4[tid][0] = ld(v.gamma, c, v.bf);
    q4[tid][1] = ld(v.beta, c, v.bf);
    q4[tid][2] = film ? __fadd_rn(1.f, ld(v.emb, e, v.emb_bf)) : 1.f;
    q4[tid][3] = film ? ld(v.emb, e + C, v.emb_bf) : 0.f;
    ms[tid][0] = stats[bg];
    ms[tid][1] = stats[B * G + bg];
  }
  const bool vec = T % E == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  Pack<TX> in[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = tid + 256 * u, c = c0 + i / CH, t = t0 + (i % CH) * E;
    const long long o = ((long long)b * C + c) * T + t;
    if (vec) {
      in[u].v = c < C && t < T ? *reinterpret_cast<const int4*>(x + o)
                               : make_int4(0, 0, 0, 0);
    } else {
#pragma unroll
      for (int k = 0; k < E; ++k)
        in[u].e[k] = c < C && t + k < T ? x[o + k] : from_f<TX>(0.f);
    }
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = tid + 256 * u, r = i / CH, j = (i % CH) * E;
#pragma unroll
    for (int k = 0; k < E; ++k)
      s[r][j + k] = norm_value(in[u].e[k], q4[r], ms[r][0], ms[r][1], film,
                               act);
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = tid + 256 * u, r = i / CH, j = (i % CH) * E;
    const int t = t0 + r, c = c0 + j;   // C % 8 == 0: whole pieces
    if (t < T && c < C) {
      Pack<TX> out;
#pragma unroll
      for (int k = 0; k < E; ++k) out.e[k] = from_f<TX>(s[j + k][r]);
      *reinterpret_cast<int4*>(y + ((long long)b * T + t) * C + c) = out.v;
    }
  }
}

// dx (K5: dh) of one (batch, group) a block: the time tiles' channel sums
// reduced in order, the group's means of gamma dn and gamma dn x^, then
// dx = rstd (gamma dn - mean(gamma dn) - x^ mean(gamma dn x^)) over the
// group's contiguous elements.  Also each channel's sum dn x^ and sum dn of
// this batch (sgb (B, 2, C): dgamma's and dbeta's) and K5's d(emb) = [sum
// dz n | sum dz].  Dynamic shared memory: NS x per sums, per gammas.
template <typename TX, bool FILM>
__global__ void __launch_bounds__(256)
    bwd_norm(const BwdArgs<TX> a, TX* __restrict__ dx,
             float* __restrict__ sgb, void* demb) {
  constexpr int NS = FILM ? 4 : 2;
  extern __shared__ float nsum[];
  __shared__ float means[2];
  const int bg = blockIdx.x, b = bg / a.G, per = a.C / a.G;
  const int c0 = (bg % a.G) * per, tid = threadIdx.x;
  float* gam = nsum + NS * per;
  for (int i = tid; i < NS * per; i += 256) {
    const int k = i / per, c = c0 + i % per;
    float v = 0.f;
    for (int tt = 0; tt < a.ntt; ++tt)
      v += a.part[(((long long)b * a.ntt + tt) * NS + k) * a.C + c];
    nsum[i] = v;
  }
  for (int r = tid; r < per; r += 256) gam[r] = ld(a.v.gamma, c0 + r, a.v.bf);
  __syncthreads();
  for (int r = tid; r < per; r += 256) {
    const int c = c0 + r;
    sgb[2LL * b * a.C + c] = nsum[per + r];
    sgb[(2LL * b + 1) * a.C + c] = nsum[r];
    if constexpr (FILM) {
      st(demb, 2LL * b * a.C + c, nsum[2 * per + r], a.v.emb_bf);
      st(demb, 2LL * b * a.C + a.C + c, nsum[3 * per + r], a.v.emb_bf);
    }
  }
  if (tid == 0) {
    float s0 = 0.f, s1 = 0.f;
    for (int r = 0; r < per; ++r) {
      s0 += gam[r] * nsum[r];
      s1 += gam[r] * nsum[per + r];
    }
    const float cnt = (float)per * (float)a.T;
    means[0] = s0 / cnt;
    means[1] = s1 / cnt;
  }
  __syncthreads();
  const float mu = a.stats[bg], rs = a.stats[a.B * a.G + bg];
  const float m0 = means[0], m1 = means[1];
  const long long base = ((long long)b * a.C + c0) * a.T;
  const int n = per * a.T;
  constexpr int E = 16 / sizeof(TX), U = 4;
  if (a.T % E == 0 && ((reinterpret_cast<uintptr_t>(a.x) |
                        reinterpret_cast<uintptr_t>(a.dn) |
                        reinterpret_cast<uintptr_t>(dx)) & 15) == 0) {
    // 16-byte pieces, U of x and of dn loaded before any is used; a piece
    // lies in one channel (T % E == 0)
    for (int p0 = tid; p0 < n / E; p0 += U * 256) {
      Pack<TX> xv[U], dv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int p = p0 + u * 256;
        if (p < n / E) {
          xv[u].v = *reinterpret_cast<const int4*>(a.x + base + p * E);
          dv[u].v = *reinterpret_cast<const int4*>(a.dn + base + p * E);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int p = p0 + u * 256;
        if (p >= n / E) break;
        const float ga = gam[p * E / a.T];
        Pack<TX> out;
#pragma unroll
        for (int k = 0; k < E; ++k) {
          const float xh = (to_f(xv[u].e[k]) - mu) * rs;
          out.e[k] = from_f<TX>(rs * (ga * to_f(dv[u].e[k]) - m0 - xh * m1));
        }
        *reinterpret_cast<int4*>(dx + base + p * E) = out.v;
      }
    }
    return;
  }
  for (int i = tid; i < n; i += 256) {
    const float xh = (to_f(a.x[base + i]) - mu) * rs;
    const float u = gam[i / a.T] * to_f(a.dn[base + i]);
    dx[base + i] = from_f<TX>(rs * (u - m0 - xh * m1));
  }
}

// The last sums, each in a fixed order: dW over the split slices, written
// in the conv weight's layout (K4 (M, C); K5 (C, C, 3): [m][c][tap]) and
// dgamma and dbeta over the batch, an element a thread, in the first
// `wblocks` blocks; db over the upstream's nbp (batch, 64-step tile)
// partials, a warp a row of M (its lanes' strided sums, then shuffles),
// in the rest.
template <typename TX>
__global__ void __launch_bounds__(256)
    bwd_reduce(const float* __restrict__ wpart, int split, int taps, int M,
               int C, TX* __restrict__ dw, const float* __restrict__ dbp,
               int nbp, void* db, const float* __restrict__ sgb, int B,
               void* dgamma, void* dbeta, int vec_bf, int wblocks) {
  const long long mc = (long long)M * C, nw = taps * mc;
  if ((int)blockIdx.x >= wblocks) {
    const int lane = threadIdx.x % 32;
    const int m = ((int)blockIdx.x - wblocks) * 8 + threadIdx.x / 32;
    if (m >= M) return;
    float v = 0.f;
    for (int k = lane; k < nbp; k += 32) v += dbp[(long long)k * M + m];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) st(db, m, v, vec_bf);
    return;
  }
  const long long total = nw + 2LL * C;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < total;
       i += (long long)wblocks * 256) {
    if (i < nw) {
      float v = 0.f;
      for (int q = 0; q < split; ++q) v += wpart[q * nw + i];
      const long long tap = i / mc, e = i - tap * mc;
      dw[taps == 1 ? e : e * 3 + tap] = from_f<TX>(v);
    } else {
      const int j = (int)(i - nw), which = j / C, c = j % C;
      float v = 0.f;
      for (int bb = 0; bb < B; ++bb) v += sgb[(2LL * bb + which) * C + c];
      st(which ? dbeta : dgamma, c, v, vec_bf);
    }
  }
}

struct BwdIo {
  const void *x, *wb, *g;
  const float* stats;
  Vecs v;
  void *ybuf, *gt, *dn;
  float *part, *dbp, *wpart, *sgb;
  void *dx, *dw, *dgamma, *dbeta, *db, *demb;
  int B, C, T, M, G, taps, act, bn, split;
  float eps;
};

// K5's bf16 da by bwd_da_pingpong: wb is the tap-major w_taps (3, M, C),
// read through its transposed boxes; gt the time-major upstream; a
// persistent grid of one block an SM
int da_pingpong(const BwdIo& o, const BwdArgs<bf16>& a, cudaStream_t st) {
  const int B = o.B, C = o.C, T = o.T, M = o.M;
  CUtensorMap wmap, gmap;
  int rc;
  if ((rc = tensor_map_3d(&wmap, o.wb, C, M, 3, 2ull * C, 2ull * C * M, 64,
                          BK)) ||
      (rc = tensor_map_3d(&gmap, o.gt, M, T, B, 2ull * M, 2ull * M * T, BK,
                          PP_BN)))
    return rc;
  if (o.bn != PP_BN) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = B * ((T + PP_BN - 1) / PP_BN) * ((C + BM - 1) / BM);
  if ((rc = allow_smem<bwd_da_pingpong>(PP_SMEM))) return rc;
  bwd_da_pingpong<<<std::min(tiles, 132), GEMM_THREADS, PP_SMEM, st>>>(
      wmap, gmap, a);
  return 0;
}

template <typename TX, int TAPS, bool GT = false>
int run_bwd(const BwdIo& o, cudaStream_t st) {
  constexpr bool BF = sizeof(TX) == 2;
  constexpr bool FILM = TAPS == 3;
  constexpr int NS = FILM ? 4 : 2;
  const int ntt = (o.T + o.bn - 1) / o.bn, ntg = (o.T + 63) / 64;
  const int B = o.B, C = o.C, T = o.T, M = o.M;
  // 1. a, recomputed from the forward's statistics: the bits the forward's
  // GEMM read
  bwd_apply_norm<TX><<<dim3(ntg, (C + 63) / 64, B), 256, 0, st>>>(
      static_cast<const TX*>(o.x), static_cast<TX*>(o.ybuf), o.stats, o.v, C,
      T, o.G, B, o.act);
  // 2. the upstream time-major, and db's partials (GT: the GEMMs read it
  // as it comes; dW's blocks take db's partials); fp32: split, both
  // time-major and as it comes, in gt's four arrays
  const long long ngt = (long long)B * T * M;
  const int Tp = (T + 3) / 4 * 4;
  float* const gth = static_cast<float*>(o.gt);
  float* const gh = gth + 2 * ngt;
  if constexpr (BF) {
    if (!GT)
      bwd_transpose<TX><<<dim3(ntg, (M + 63) / 64, B), 256, 0, st>>>(
          static_cast<const TX*>(o.g), static_cast<TX*>(o.gt), o.dbp, M, T);
  } else {
    bwd_split_upstream<<<dim3(ntg, (M + 63) / 64, B), 256, 0, st>>>(
        static_cast<const float*>(o.g), gth, gth + ngt, gh,
        gh + (long long)B * M * Tp, o.dbp, M, T, Tp);
  }
  const BwdArgs<TX> a{static_cast<const TX*>(o.x), o.stats, o.v,
                      static_cast<TX*>(o.dn), o.part, B, C, T, M, o.G,
                      o.act, ntt};
  int rc = 0;
  // 3. da, with dn and the time tiles' channel sums
  if constexpr (BF && TAPS == 3) {
    rc = da_pingpong(o, a, st);
  } else if constexpr (BF) {
    CUtensorMap wmap, gmap;
    if ((rc = tensor_map_3d(&wmap, o.wb, M, C, TAPS, 2ull * M, 2ull * M * C,
                            BK, BM)))
      return rc;
    if ((rc = GT ? tensor_map_3d(&gmap, o.g, T, M, B, 2ull * T,
                                 2ull * T * M, 64, BK)
                 : tensor_map_3d(&gmap, o.gt, M, T, B, 2ull * M,
                                 2ull * M * T, BK, o.bn)))
      return rc;
    const dim3 grid(ntt, (C + BM - 1) / BM, B);
    if (o.bn == 64) {
      rc = allow_smem<bwd_da_wgmma<64, GT>>(Ring<64>::SMEM);
      if (!rc)
        bwd_da_wgmma<64, GT>
            <<<grid, GEMM_THREADS, Ring<64>::SMEM, st>>>(wmap, gmap, a);
    } else if (o.bn == 128) {
      rc = allow_smem<bwd_da_wgmma<128, GT>>(Ring<128>::SMEM);
      if (!rc)
        bwd_da_wgmma<128, GT>
            <<<grid, GEMM_THREADS, Ring<128>::SMEM, st>>>(wmap, gmap, a);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    constexpr CUtensorMapDataType F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    CUtensorMap wmap, hmap, lmap;
    if ((rc = tensor_map_3d(&wmap, o.wb, M, C, TAPS, 4ull * M, 4ull * M * C,
                            TK, BM, F32)) ||
        (rc = tensor_map_3d(&hmap, gth, M, T, B, 4ull * M, 4ull * M * T, TK,
                            o.bn, F32)) ||
        (rc = tensor_map_3d(&lmap, gth + ngt, M, T, B, 4ull * M,
                            4ull * M * T, TK, o.bn, F32)))
      return rc;
    const dim3 grid(ntt, (C + BM - 1) / BM, B);
    if (o.bn == 64) {
      rc = allow_smem<bwd_da_tf32<TAPS, 64>>(RingF<64>::SMEM);
      if (!rc)
        bwd_da_tf32<TAPS, 64><<<grid, GEMM_THREADS, RingF<64>::SMEM, st>>>(
            wmap, hmap, lmap, a);
    } else if (o.bn == 128) {
      rc = allow_smem<bwd_da_tf32<TAPS, 128>>(RingF<128>::SMEM);
      if (!rc)
        bwd_da_tf32<TAPS, 128><<<grid, GEMM_THREADS, RingF<128>::SMEM, st>>>(
            wmap, hmap, lmap, a);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (rc) return rc;
  // 4. dx, the batch's dgamma/dbeta sums, d(emb)
  const int per = C / o.G;
  const int nsmem = (NS + 1) * per * 4;
  if ((rc = allow_smem<bwd_norm<TX, FILM>>(nsmem))) return rc;
  bwd_norm<TX, FILM><<<B * o.G, 256, nsmem, st>>>(
      a, static_cast<TX*>(o.dx), o.sgb, o.demb);
  // 5. dW's split partials
  if constexpr (BF) {
    CUtensorMap gmap, ymap;
    if ((rc = GT ? tensor_map_3d(&gmap, o.g, T, M, B, 2ull * T,
                                 2ull * T * M, DW_BK, 64)
                 : tensor_map_3d(&gmap, o.gt, M, T, B, 2ull * M,
                                 2ull * M * T, 64, DW_BK)))
      return rc;
    if ((rc = tensor_map_3d(&ymap, o.ybuf, C, T, B, 2ull * C, 2ull * C * T,
                            64, DW_BK)))
      return rc;
    if ((rc = allow_smem<bwd_dw_wgmma<TAPS, GT>>(DW_SMEM))) return rc;
    bwd_dw_wgmma<TAPS, GT><<<dim3((C + 127) / 128, (M + 127) / 128,
                                  TAPS * o.split),
                             GEMM_THREADS, DW_SMEM, st>>>(
        gmap, ymap, o.wpart, o.dbp, B, M, C, T, o.split);
  } else {
    constexpr CUtensorMapDataType F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    CUtensorMap ymap, hmap, lmap;
    if ((rc = tensor_map_3d(&ymap, o.ybuf, C, T, B, 4ull * C, 4ull * C * T,
                            32, TK, F32)) ||
        (rc = tensor_map_3d(&hmap, gh, Tp, M, B, 4ull * Tp, 4ull * Tp * M,
                            TK, DWF_BN, F32)) ||
        (rc = tensor_map_3d(&lmap, gh + (long long)B * M * Tp, Tp, M, B,
                            4ull * Tp, 4ull * Tp * M, TK, DWF_BN, F32)))
      return rc;
    if ((rc = allow_smem<bwd_dw_tf32<TAPS>>(DWF_SMEM))) return rc;
    bwd_dw_tf32<TAPS><<<dim3((C + BM - 1) / BM, (M + DWF_BN - 1) / DWF_BN,
                             TAPS * o.split),
                        GEMM_THREADS, DWF_SMEM, st>>>(
        ymap, hmap, lmap, o.wpart, B, M, C, T, o.split);
  }
  // 6. dW, db, dgamma, dbeta
  const long long total = (long long)TAPS * M * C + 2LL * C;
  const int wblocks = (int)std::min<long long>((total + 255) / 256, 132 * 8);
  bwd_reduce<TX><<<wblocks + (M + 7) / 8, 256, 0, st>>>(
      o.wpart, o.split, TAPS, M, C, static_cast<TX*>(o.dw), o.dbp,
      GT ? o.split : B * ntg,
      o.db, o.sgb, B, o.dgamma, o.dbeta, o.v.bf, wblocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The normalise kernel alone (each path's first kernel, for checks):
// x (B, C, T) -> y (B, T, C) in x's type (dtype 1: bf16; 0: fp32, then
// Y_hi in y and Y_lo in ylo), stats 2*B*G fp32 (mu, then rstd).  gamma,
// beta: (C), bf16 if vec_bf else fp32; emb: (B, 2C) [scale | shift]
// (bf16 if emb_bf else fp32) or null.
extern "C" int tts_group_norm_act(const void* x, const void* gamma,
                                  const void* beta, const void* emb, void* y,
                                  void* ylo, float* stats, int B, int C,
                                  int T, int G, int act, float eps,
                                  int vec_bf, int emb_bf, int dtype,
                                  void* stream) {
  const Vecs v{gamma, beta, nullptr, emb, vec_bf, emb_bf};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run_norm(NormArgs<float>{static_cast<const float*>(x),
                                    static_cast<float*>(y),
                                    static_cast<float*>(ylo), stats, v, B, C,
                                    G, T, act, eps},
                    st);
  return run_norm(NormArgs<bf16>{static_cast<const bf16*>(x),
                                 static_cast<bf16*>(y), nullptr, stats, v, B,
                                 C, G, T, act, eps},
                  st);
}

// K4.  x: (B, C, T) contiguous; w: (M, C) contiguous in x's type, 16-byte
// aligned; gamma, beta: (C) and bias: (M), all bf16 if vec_bf else fp32;
// out: (B, M, T); stats: 2*B*G fp32 (where the statistics go) or null;
// ybuf: (B, T, C) scratch in x's type (fp32: Y_hi), ylo: fp32 (B, T, C)
// scratch for Y_lo (fp32 only).  dtype: 0 = float32, 1 = bfloat16; bn:
// the GEMM's time steps a block (bf16: 64 or 128; fp32: 64, 104 or 128),
// split: K slices a tile (fp32; bf16: 1).  C % 8 == 0, C % G == 0.
extern "C" int tts_gn_conv1x1(const void* x, const void* gamma,
                              const void* beta, const void* w,
                              const void* bias, void* out, float* stats,
                              void* ybuf, void* ylo, int B, int C, int T,
                              int M, int G, int act, float eps, int dtype,
                              int vec_bf, int bn, int split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Vecs v{gamma, beta, bias, nullptr, vec_bf, 0};
  if (dtype == 0) {
    const NormArgs<float> a{static_cast<const float*>(x),
                            static_cast<float*>(ybuf),
                            static_cast<float*>(ylo), stats, v, B, C, G, T,
                            act, eps};
    if (int rc = run_norm(a, st)) return rc;
    return run_gemm_tf32(static_cast<const float*>(w), a.y, a.ylo, bias,
                         vec_bf, nullptr, static_cast<float*>(out), B, C, T,
                         M, 1, bn, split, st);
  }
  const NormArgs<bf16> a{static_cast<const bf16*>(x),
                         static_cast<bf16*>(ybuf), nullptr, stats, v, B, C,
                         G, T, act, eps};
  if (int rc = run_norm(a, st)) return rc;
  return run_gemm(static_cast<const bf16*>(w), static_cast<bf16*>(ybuf), bias,
                  vec_bf, nullptr, static_cast<bf16*>(out), B, C, T, M, 1,
                  bn, st);
}

// K5.  h, x, out: (B, C, T) contiguous; emb: (B, 2C) [scale | shift], bf16
// if emb_bf else fp32; w: the tap-major (3, C, C) conv weight (w[s] =
// W[:, :, s]), contiguous, in h's type, 16-byte aligned; gamma, beta,
// bias: (C), bf16 if vec_bf else fp32; stats, ybuf, ylo, bn, split: as for
// K4.  C % 8 == 0, C % G == 0.
extern "C" int tts_ts_res_block_out(const void* h, const void* x,
                                    const void* gamma, const void* beta,
                                    const void* emb, const void* w,
                                    const void* bias, void* out, float* stats,
                                    void* ybuf, void* ylo, int B, int C,
                                    int T, int G, float eps, int dtype,
                                    int vec_bf, int emb_bf, int bn,
                                    int split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Vecs v{gamma, beta, bias, emb, vec_bf, emb_bf};
  if (dtype == 0) {
    const NormArgs<float> a{static_cast<const float*>(h),
                            static_cast<float*>(ybuf),
                            static_cast<float*>(ylo), stats, v, B, C, G, T, 1,
                            eps};
    if (int rc = run_norm(a, st)) return rc;
    return run_gemm_tf32(static_cast<const float*>(w), a.y, a.ylo, bias,
                         vec_bf, static_cast<const float*>(x),
                         static_cast<float*>(out), B, C, T, C, 3, bn, split,
                         st);
  }
  const NormArgs<bf16> a{static_cast<const bf16*>(h),
                         static_cast<bf16*>(ybuf), nullptr, stats, v, B, C,
                         G, T, 1, eps};
  if (int rc = run_norm(a, st)) return rc;
  return run_gemm(static_cast<const bf16*>(w), static_cast<bf16*>(ybuf), bias,
                  vec_bf, static_cast<const bf16*>(x),
                  static_cast<bf16*>(out), B, C, T, C, 3, bn, st);
}

// K4's and K5's backward: taps 1 is K4 (x; act as the forward's), taps 3
// K5 (h, act 1, emb).  x: (B, C, T) contiguous; wb: (taps, C, M) in x's
// type, 16-byte aligned: K4's W^T, K5's (fp32) reversed taps, wb[s'] =
// W[:, :, 2 - s']^T, so that tap s' shifts the upstream by s' - 1 steps as
// the forward shifts Y (K5 in bf16: mode 2, the tap-major weight, below); g: the upstream (B, M, T) contiguous (16-byte
// aligned where direct); stats: the
// forward's mu, then rstd (2*B*G fp32); gamma, beta: (C), bf16 if vec_bf
// else fp32; emb: (B, 2C) [scale | shift] (K5; bf16 if emb_bf else fp32).
// Scratch: ybuf (B, T, C) (a, time-major), gt (B, T, M) and dn (B, C, T)
// in x's type; part (B, ntt, NS, C) with ntt = ceil(T / bn) and NS = 2 (K4)
// or 4 (K5), dbp (B, ceil(T / 64), M), wpart (split, taps, M, C) and sgb
// (B, 2, C), all fp32.  Out: dx (B, C, T) and dw (the weight's layout: K4
// (M, C), K5 (C, C, 3)) in x's type; dgamma, dbeta (C) and db (M) in the
// vectors' type; demb (B, 2C) in emb's (K5).  dtype: 0 = float32, 1 =
// bfloat16; bn: the da GEMM's steps a block (64 or 128); split: dW's K
// slices.  fp32: gt is gt_hi, gt_lo (B, T, M) and g_hi, g_lo (B, M, Tp),
// Tp = T rounded up to 4, in one fp32 scratch (bwd_split_upstream).
// direct (K4 in bf16 at T % 8 == 0 only): the GEMMs read g as it comes
// (no gt: null) and dbp is (split, M), dW's blocks' partials.  K5 in bf16
// (bn 128): wb is the forward's tap-major weight w_taps (3, M, C),
// w_taps[s] = W[:, :, s], and da runs on bwd_da_pingpong.  C % 8 == 0, M
// % 8 == 0, C % G == 0.
extern "C" int tts_resblock_bwd(
    const void* x, const void* gamma, const void* beta, const void* emb,
    const void* wb, const void* g, const float* stats, void* ybuf,
    void* gt, void* dn, float* part, float* dbp, float* wpart, float* sgb,
    void* dx, void* dw, void* dgamma, void* dbeta, void* db, void* demb,
    int B, int C, int T, int M, int G, int taps, int act, float eps,
    int dtype, int vec_bf, int emb_bf, int bn, int split, int direct,
    void* stream) {
  if ((taps != 1 && taps != 3) || split < 1 || (taps == 3 && emb == nullptr)
      || (direct && (taps != 1 || dtype != 1 || T % 8 != 0))
      || (taps == 3 && dtype == 1 && bn != PP_BN))
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdIo o{x, wb, g, stats,
                Vecs{gamma, beta, nullptr, taps == 3 ? emb : nullptr, vec_bf,
                     emb_bf},
                ybuf, gt, dn, part, dbp, wpart, sgb, dx, dw, dgamma,
                dbeta, db, demb, B, C, T, M, G, taps, taps == 3 ? 1 : act,
                bn, split, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return taps == 3 ? run_bwd<float, 3>(o, st) : run_bwd<float, 1>(o, st);
  if (direct) return run_bwd<bf16, 1, true>(o, st);
  return taps == 3 ? run_bwd<bf16, 3>(o, st) : run_bwd<bf16, 1>(o, st);
}
