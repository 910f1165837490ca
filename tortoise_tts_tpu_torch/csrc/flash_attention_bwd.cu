// K1's backward: the gradients of the UnifiedVoice trunk's causal
// attention (the AR training step), q, k and v given the forward's
// log-sum-exp and the upstream gradient dO.
//
// Replaces no Pallas kernel: the JAX package's trunk attention is a
// jax.custom_vjp (tortoise_tts_tpu/models/unified_voice.py
// _flash_trunk_attention, :44-64) whose backward, _flash_trunk_bwd, is
// XLA's jax.vjp of _xla_trunk_attention (ops/attention.py mha), which XLA
// fuses on the TPU.  This is that backward written by hand.  With the
// forward's scale and its finite -1e9 for a masked or causally excluded
// key (whose weight is then 0: every row of the trunk has a valid key):
//     P = exp(S - LSE),  dP = dO V^T,  Delta = rowsum(P dP),  dV = P^T dO,
//     dS = P (dP - Delta),  dQ = scale dS K,  dK = scale dS^T Q.
// Delta is rowsum(dO o) for the exact o, taken here as autograd's softmax
// backward takes it, from the backward's own P and dP in fp32: the
// forward's bf16 o (its P rounded for P V, the output rounded) is off it
// by 2^-9 |dO| |o|, which a row with few keys (dQ = scale dS K, the K of
// two or three keys, none averaged away) carries into dQ at up to 1.5x
// the training check's bound (measured on an H100).  Every sum runs in a
// fixed order (no atomics): two calls give the same bits.  Two launches a
// call:
// - bwd_dq_*: a block owns a query tile and walks the key tiles up to the
//   diagonal twice, recomputing S and dP: first into its rows' Delta
//   (written for the next kernel), then into dQ;
// - bwd_dkdv_*: a block owns a key tile and walks the query tiles from the
//   diagonal down, recomputing S^T and dP^T, into dK and dV.
// Blocks go heaviest first (the last query tile, the first key tile).
//
// Bound on an H100: at the AR steps' shapes, (B, H, S, D) = (16, 16, 773,
// 64) and (8, 16, 389, 64), the function needs five S x S x 64 products
// over the causal half (S, dP, dV, dK, dQ; 49 and 6.2 GFLOP, 0.050 and
// 0.0063 ms at 989 TFLOP/s) and moves q, k, v, dO in and dq, dk, dv out
// (178 and 45 MB in bf16, 0.053 and 0.013 ms at 3.35 TB/s).  The kernels
// run nine products (S and dP three times: Delta's pass, dQ's, dK's and
// dV's; 0.089 and 0.011 ms): the price of a deterministic dQ without
// atomics and of a Delta consistent with P.  What sets the time is
// keeping the tensor cores fed between the products' dependent steps.
//
// bf16 design: a block is one warpgroup (128 threads).  Keys as rows suits
// wgmma: in bwd_dkdv_tc the warpgroup owns 64 keys, S^T = K Q^T and dP^T =
// V dO^T land with P^T and dS^T in the accumulator layout of a register A
// operand (two n8 accumulator blocks, rounded to bf16, are one k16 slice),
// so dV += P^T dO and dK += dS^T Q take them from registers with the Q and
// dO tiles, already in shared memory for S^T and dP^T, as MN-major B.  K
// and V stay resident in shared memory; the Q and dO tiles stream through
// a double-buffered ring fed by cp.async (16-byte copies into the 128-byte
// swizzle that wgmma reads), the next tile's copies in flight during the
// current tile's products; LSE and Delta come by plain loads one tile
// ahead.  bwd_dq_tc is the mirror: Q and dO resident, K and V streaming
// (the two passes one sequence of 2 x tiles steps through the ring), S =
// Q K^T and dP = dO V^T as K-major products, dQ += dS K with dS from
// registers and the K tile as MN-major B.  Three blocks an SM (at most
// 168 registers a thread: bwd_dkdv_tc holds dK, dV, S^T and dP^T, 163
// registers, and ran 17% faster than at two blocks; bwd_dq_tc 135)
// overlap one block's softmax and copies with another's products.  Every
// product is wgmma m64n64k16 with fp32 accumulation; P and dS are rounded
// to bf16 only as a product's operand, dP, Delta, LSE and the softmax
// stay fp32.  Rows past S arrive as zeros and take no weight; nothing is
// padded.
//
// fp32 design (bwd_dq_f32, bwd_dkdv_f32): the same split on CUDA cores
// (FFMA), 32-key (or 32-query) tiles in shared memory, a thread four
// channels apart of one row: fp32 throughout, as the forward's fp32 form.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int D = 64;
constexpr int BT = 64;                // keys or queries a bf16 tile
constexpr int TILE = BT * D * 2;      // one bf16 tile, 8 KB
constexpr int THREADS = 128;          // one warpgroup
constexpr float LOG2E = 1.4426950408889634f;

// tensors by index in BwdArgs::st
enum { TQ, TK, TV, TDO, TDQ, TDK, TDV, NT };

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;       // (B*H, S), natural log
  float* delta;           // (B*H, S): rowsum(P dP), made by bwd_dq_*
  const uint8_t* mask;    // (B, S) or null
  void* dq;
  void* dk;
  void* dv;
  int H, S, causal;
  float scale;
  long long st[NT][3];    // (batch, head, row) strides, elements
};

template <typename T>
__device__ __forceinline__ T* rows_of(const void* p, const BwdArgs& a,
                                      int t, int b, int h) {
  return const_cast<T*>(static_cast<const T*>(p)) + b * a.st[t][0] +
         h * a.st[t][1];
}

// --- bf16: tensor cores ------------------------------------------------------

// byte offset of 16-byte chunk c of row r in a tile of 128-byte rows with
// the 128-byte swizzle (as TMA writes it and wgmma reads it)
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ void cp16(uint32_t dst, const void* src,
                                     int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows r0 .. r0 + 63 (row stride rs) into the swizzled tile at dst; rows
// at or past S arrive as zeros
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* base,
                                          long long rs, int r0, int S,
                                          int tid) {
#pragma unroll
  for (int i = tid; i < BT * 8; i += THREADS) {
    const int r = i >> 3, c = i & 7;
    const bool in = r0 + r < S;
    cp16(dst + swz(r, c), base + (in ? r0 + r : 0) * rs + 8 * c,
         in ? 16 : 0);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the accumulator's n8 blocks 2 kk and 2 kk + 1, rounded to bf16, are the
// k16 slice kk of a register A operand (thread layouts of hopper.cuh)
__device__ __forceinline__ void to_a(const float (&x)[32],
                                     uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = pack_bf16(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
}

__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk) {
  return desc_sw128(tile + 32 * kk, 16, 1024);   // 16 channels a slice
}
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk) {
  return desc_sw128(tile + 2048 * kk, 16, 1024);   // 16 rows a slice
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

// Shared memory of both bf16 kernels: two resident tiles, a ring of two
// stages of two tiles, then (bwd_dkdv_tc) fp32 row data: LSE in base 2
// and Delta, a stage each.
constexpr int SMEM_TILES = 6 * TILE;
constexpr int SMEM_DQ = SMEM_TILES + 1024;
constexpr int SMEM_DKDV = SMEM_TILES + 2 * 2 * BT * 4 + 1024;

// One block: query tile qt (heaviest, the last, first) of one (batch,
// head).  Q and dO stay in shared memory; K and V tiles 0 .. the diagonal
// stream through the ring twice: step i < nk adds tile i to Delta, step nk
// + i tile i to dQ.
__global__ void __launch_bounds__(THREADS, 3)
    bwd_dq_tc(const __grid_constant__ BwdArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t qs = base, dos = base + TILE;
  const int S = a.S, nt = (S + BT - 1) / BT;
  const int qt = nt - 1 - blockIdx.x, q0 = qt * BT;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int nk = a.causal ? qt + 1 : nt;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bf16* kb = rows_of<bf16>(a.k, a, TK, b, h);
  const bf16* vb = rows_of<bf16>(a.v, a, TV, b, h);
  // step i's K and V tiles into stage i % 2
  auto load_kv = [&](int i) {
    const uint32_t st = base + (2 + 2 * (i & 1)) * TILE;
    const int kt = i < nk ? i : i - nk;
    load_tile(st, kb, a.st[TK][2], kt * BT, S, tid);
    load_tile(st + TILE, vb, a.st[TV][2], kt * BT, S, tid);
  };
  load_tile(qs, rows_of<bf16>(a.q, a, TQ, b, h), a.st[TQ][2], q0, S, tid);
  load_tile(dos, rows_of<bf16>(a.dout, a, TDO, b, h), a.st[TDO][2], q0, S,
            tid);
  load_kv(0);
  cp_commit();

  // this thread's rows q0 + lr and q0 + lr + 8: LSE in base 2 (+inf past
  // S: P = 0 there)
  const int lr = 16 * w + g, r0 = q0 + lr, r1 = r0 + 8;
  const float* lrow = a.lse + (long long)bh * S;
  const float l0 = r0 < S ? lrow[r0] * LOG2E : INFINITY;
  const float l1 = r1 < S ? lrow[r1] * LOG2E : INFINITY;
  const float sl2 = a.scale * LOG2E;
  const uint8_t* mrow = a.mask ? a.mask + (long long)b * S : nullptr;

  float dq[32];
  zero(dq);
  float dl0 = 0.f, dl1 = 0.f;   // Delta: this thread's share, then whole
  for (int i = 0; i < 2 * nk; ++i) {
    cp_wait_all();
    fence_proxy_async();
    __syncthreads();   // step i landed; every read of step i - 1 done
    if (i + 1 < 2 * nk) load_kv(i + 1);
    cp_commit();
    const bool delta_pass = i < nk;
    const int kt = delta_pass ? i : i - nk;
    const uint32_t ks = base + (2 + 2 * (i & 1)) * TILE, vs = ks + TILE;

    // S = Q K^T and dP = dO V^T
    float s[32], dp[32];
    zero(s);
    zero(dp);
    reg_fence(s);   // the zeros defined before the fence, not sunk past it
    reg_fence(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_n64(s, kmajor(qs, kk), kmajor(ks, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_n64(dp, kmajor(dos, kk), kmajor(vs, kk));
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);
    reg_fence(dp);

    // P = 2^(s scale log2 e - LSE2): s[4j + 2hh + e] is query row r0 + 8
    // hh, key k0 + 8 j + 2 t4 + e
    const int k0 = kt * BT;
    const bool check = mrow || k0 + BT > S || (a.causal && kt == qt);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * j + 2 * hh + e;
          float p = exp2f(fmaf(s[x], sl2, -(hh ? l1 : l0)));
          if (check) {
            const int key = k0 + 8 * j + 2 * t4 + e;
            if (key >= S || (a.causal && key > r0 + 8 * hh) ||
                (mrow && !mrow[key]))
              p = 0.f;
          }
          s[x] = p;
        }
      }
    }
    if (delta_pass) {   // Delta += rowsum(P dP), warp-uniform
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        dl0 = fmaf(s[4 * j], dp[4 * j], dl0);
        dl0 = fmaf(s[4 * j + 1], dp[4 * j + 1], dl0);
        dl1 = fmaf(s[4 * j + 2], dp[4 * j + 2], dl1);
        dl1 = fmaf(s[4 * j + 3], dp[4 * j + 3], dl1);
      }
      if (i == nk - 1) {   // the quad's shares: the rows' Delta
        dl0 += __shfl_xor_sync(0xffffffffu, dl0, 1);
        dl0 += __shfl_xor_sync(0xffffffffu, dl0, 2);
        dl1 += __shfl_xor_sync(0xffffffffu, dl1, 1);
        dl1 += __shfl_xor_sync(0xffffffffu, dl1, 2);
        float* drow = a.delta + (long long)bh * S;
        if (t4 == 0 && r0 < S) drow[r0] = dl0;
        if (t4 == 0 && r1 < S) drow[r1] = dl1;
      }
      continue;
    }

    // dS = P (dP - Delta), then dQ += dS K (K as MN-major B: key rows,
    // channels contiguous)
#pragma unroll
    for (int x = 0; x < 32; ++x) s[x] *= dp[x] - ((x & 2) ? dl1 : dl0);
    uint32_t da[4][4];
    to_a(s, da);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) reg_fence(da[kk]);
    reg_fence(dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_n64_rs_mn<true>(dq, da[kk], mnmajor(ks, kk));
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(dq);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) reg_fence(da[kk]);
  }

  bf16* out = rows_of<bf16>(a.dq, a, TDQ, b, h);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = r0 + 8 * hh;
    if (row >= S) continue;
    bf16* orow = out + row * a.st[TDQ][2] + 2 * t4;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j) =
          pack_bf16(dq[4 * j + 2 * hh] * a.scale,
                    dq[4 * j + 2 * hh + 1] * a.scale);
  }
}

// One block: key tile kt (heaviest, the first, first) of one (batch,
// head).  K and V stay in shared memory; the Q and dO tiles of the
// diagonal down stream through the ring, LSE and Delta beside them.
__global__ void __launch_bounds__(THREADS, 3)
    bwd_dkdv_tc(const __grid_constant__ BwdArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  // stage s's row data: LSE2 at fl[128 s], Delta at fl[128 s + 64]
  float* fl = reinterpret_cast<float*>(smem_raw + (base - raw) + SMEM_TILES);
  const uint32_t ks = base, vs = base + TILE;
  const int S = a.S, nt = (S + BT - 1) / BT;
  const int kt = blockIdx.x, k0 = kt * BT;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int j0 = a.causal ? kt : 0;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bf16* qb = rows_of<bf16>(a.q, a, TQ, b, h);
  const bf16* gb = rows_of<bf16>(a.dout, a, TDO, b, h);
  auto load_qdo = [&](int j) {
    const uint32_t st = base + (2 + 2 * (j & 1)) * TILE;
    load_tile(st, qb, a.st[TQ][2], j * BT, S, tid);
    load_tile(st + TILE, gb, a.st[TDO][2], j * BT, S, tid);
  };
  // thread tid's word of query tile j's row data: LSE2 (tid < 64, +inf
  // past S) or Delta (0 past S)
  const float* rowsrc = tid < BT ? a.lse : a.delta;
  auto row_word = [&](int j) {
    const int row = j * BT + (tid & (BT - 1));
    if (row >= S) return tid < BT ? INFINITY : 0.f;
    const float x = rowsrc[(long long)bh * S + row];
    return tid < BT ? x * LOG2E : x;
  };
  load_tile(ks, rows_of<bf16>(a.k, a, TK, b, h), a.st[TK][2], k0, S, tid);
  load_tile(vs, rows_of<bf16>(a.v, a, TV, b, h), a.st[TV][2], k0, S, tid);
  load_qdo(j0);
  cp_commit();
  fl[2 * BT * (j0 & 1) + tid] = row_word(j0);

  // this thread's key rows kr and kr + 8 of the tile: in range and valid
  const int kr = k0 + 16 * w + g;
  const uint8_t* mrow = a.mask ? a.mask + (long long)b * S : nullptr;
  const bool kin0 = kr < S && (!mrow || mrow[kr]);
  const bool kin1 = kr + 8 < S && (!mrow || mrow[kr + 8]);
  const float sl2 = a.scale * LOG2E;

  float dk[32], dv[32];
  zero(dk);
  zero(dv);
  for (int j = j0; j < nt; ++j) {
    cp_wait_all();
    fence_proxy_async();
    __syncthreads();   // tile j landed; every read of tile j - 1 done
    float next = 0.f;
    if (j + 1 < nt) {
      load_qdo(j + 1);
      next = row_word(j + 1);
    }
    cp_commit();
    const uint32_t qs = base + (2 + 2 * (j & 1)) * TILE, dos = qs + TILE;
    const float* rd = fl + 2 * BT * (j & 1);

    // S^T = K Q^T and dP^T = V dO^T
    float s[32], dp[32];
    zero(s);
    zero(dp);
    reg_fence(s);   // the zeros defined before the fence, not sunk past it
    reg_fence(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_n64(s, kmajor(ks, kk), kmajor(qs, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_n64(dp, kmajor(vs, kk), kmajor(dos, kk));
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);
    reg_fence(dp);

    // P^T into s, dS^T into dp: s[4 jj + 2 hh + e] is key kr + 8 hh,
    // query q0 + 8 jj + 2 t4 + e
    const int q0 = j * BT;
    const bool check = mrow || k0 + BT > S || (a.causal && j == kt);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float2 lse2 =
          *reinterpret_cast<const float2*>(rd + 8 * jj + 2 * t4);
      const float2 dl =
          *reinterpret_cast<const float2*>(rd + BT + 8 * jj + 2 * t4);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * jj + 2 * hh + e;
          float p = exp2f(fmaf(s[i], sl2, -(e ? lse2.y : lse2.x)));
          if (check) {
            const int query = q0 + 8 * jj + 2 * t4 + e;
            if (!(hh ? kin1 : kin0) || (a.causal && kr + 8 * hh > query))
              p = 0.f;
          }
          s[i] = p;
          dp[i] = p * (dp[i] - (e ? dl.y : dl.x));
        }
      }
    }
    uint32_t pa[4][4], da[4][4];
    to_a(s, pa);
    to_a(dp, da);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      reg_fence(pa[kk]);
      reg_fence(da[kk]);
    }

    // dV += P^T dO, dK += dS^T Q (dO and Q as MN-major B: query rows,
    // channels contiguous)
    reg_fence(dv);
    reg_fence(dk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_n64_rs_mn<true>(dv, pa[kk], mnmajor(dos, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_n64_rs_mn<true>(dk, da[kk], mnmajor(qs, kk));
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(dv);
    reg_fence(dk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      reg_fence(pa[kk]);
      reg_fence(da[kk]);
    }
    // the next tile's row data, into the stage tile j - 1 used
    if (j + 1 < nt) fl[2 * BT * ((j + 1) & 1) + tid] = next;
  }

  bf16* dkb = rows_of<bf16>(a.dk, a, TDK, b, h);
  bf16* dvb = rows_of<bf16>(a.dv, a, TDV, b, h);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = kr + 8 * hh;
    if (row >= S) continue;
    bf16* krow = dkb + row * a.st[TDK][2] + 2 * t4;
    bf16* vrow = dvb + row * a.st[TDV][2] + 2 * t4;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<uint32_t*>(krow + 8 * j) =
          pack_bf16(dk[4 * j + 2 * hh] * a.scale,
                    dk[4 * j + 2 * hh + 1] * a.scale);
      *reinterpret_cast<uint32_t*>(vrow + 8 * j) =
          pack_bf16(dv[4 * j + 2 * hh], dv[4 * j + 2 * hh + 1]);
    }
  }
}

// --- fp32: CUDA-core FMAs ----------------------------------------------------

constexpr int FB = 32;      // queries or keys a tile
constexpr int FP = D + 1;   // padded row: conflict-free column reads
constexpr int LANES = 4;    // threads a row, channels LANES apart

// rows r0 .. r0 + FB - 1 of an fp32 tensor into a padded tile, zeros
// past S
__device__ __forceinline__ void load_f32(float (&dst)[FB][FP],
                                         const float* base, long long rs,
                                         int r0, int S, int tid) {
  for (int i = tid; i < FB * D; i += THREADS) {
    const int r = i / D, c = i % D;
    dst[r][c] = r0 + r < S ? base[(r0 + r) * rs + c] : 0.f;
  }
}

__device__ __forceinline__ float dot_f32(const float* x, const float* y) {
  float acc = 0.f;
#pragma unroll 16
  for (int c = 0; c < D; ++c) acc = fmaf(x[c], y[c], acc);
  return acc;
}

// One block: FB queries of one (batch, head), the key tiles up to the
// diagonal twice (step i < nk into Delta, step nk + i into dQ).  Thread
// tid: query row tid / 4, keys and channels tid % 4 + 4 u.
__global__ void __launch_bounds__(THREADS)
    bwd_dq_f32(const __grid_constant__ BwdArgs a) {
  __shared__ float Qs[FB][FP], Gs[FB][FP], Ks[FB][FP], Vs[FB][FP];
  __shared__ float Ss[FB][FB + 1];
  const int S = a.S, nt = (S + FB - 1) / FB;
  const int qt = nt - 1 - blockIdx.x, q0 = qt * FB;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int tid = threadIdx.x, r = tid / LANES, sub = tid % LANES;
  const int row = q0 + r;
  load_f32(Qs, rows_of<float>(a.q, a, TQ, b, h), a.st[TQ][2], q0, S, tid);
  load_f32(Gs, rows_of<float>(a.dout, a, TDO, b, h), a.st[TDO][2], q0, S,
           tid);
  const float lse = row < S ? a.lse[(long long)bh * S + row] : INFINITY;
  const uint8_t* mrow = a.mask ? a.mask + (long long)b * S : nullptr;
  const float* kb = rows_of<float>(a.k, a, TK, b, h);
  const float* vb = rows_of<float>(a.v, a, TV, b, h);
  const int nk = a.causal ? qt + 1 : nt;
  float acc[D / LANES];
#pragma unroll
  for (int i = 0; i < D / LANES; ++i) acc[i] = 0.f;
  float dl = 0.f;   // Delta: this thread's share, then the row's
  for (int i = 0; i < 2 * nk; ++i) {
    const bool delta_pass = i < nk;
    const int k0 = (delta_pass ? i : i - nk) * FB;
    __syncthreads();   // the previous tile's reads are done
    load_f32(Ks, kb, a.st[TK][2], k0, S, tid);
    load_f32(Vs, vb, a.st[TV][2], k0, S, tid);
    __syncthreads();
#pragma unroll
    for (int u = 0; u < FB / LANES; ++u) {
      const int c = sub + LANES * u, key = k0 + c;
      const float s = dot_f32(Qs[r], Ks[c]);
      const float dp = dot_f32(Gs[r], Vs[c]);
      const bool ok = key < S && !(a.causal && key > row) &&
                      (!mrow || mrow[key]);
      const float p = ok ? expf(fmaf(s, a.scale, -lse)) : 0.f;
      if (delta_pass)
        dl = fmaf(p, dp, dl);
      else
        Ss[r][c] = p * (dp - dl);
    }
    if (delta_pass) {
      if (i == nk - 1) {   // the row's four shares
        dl += __shfl_xor_sync(0xffffffffu, dl, 1);
        dl += __shfl_xor_sync(0xffffffffu, dl, 2);
        if (sub == 0 && row < S) a.delta[(long long)bh * S + row] = dl;
      }
      continue;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < FB; ++c) {
      const float ds = Ss[r][c];
#pragma unroll
      for (int e = 0; e < D / LANES; ++e)
        acc[e] = fmaf(ds, Ks[c][sub + LANES * e], acc[e]);
    }
  }
  if (row < S) {
    float* out = rows_of<float>(a.dq, a, TDQ, b, h) + row * a.st[TDQ][2];
#pragma unroll
    for (int i = 0; i < D / LANES; ++i)
      out[sub + LANES * i] = acc[i] * a.scale;
  }
}

// One block: FB keys of one (batch, head), the query tiles from the
// diagonal down.  Thread tid: key row tid / 4, queries and channels
// tid % 4 + 4 u.
__global__ void __launch_bounds__(THREADS)
    bwd_dkdv_f32(const __grid_constant__ BwdArgs a) {
  __shared__ float Ks[FB][FP], Vs[FB][FP], Qs[FB][FP], Gs[FB][FP];
  __shared__ float Ps[FB][FB + 1], Ss[FB][FB + 1];
  __shared__ float Ls[FB], Dl[FB];
  const int S = a.S, nt = (S + FB - 1) / FB;
  const int kt = blockIdx.x, k0 = kt * FB;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int tid = threadIdx.x, r = tid / LANES, sub = tid % LANES;
  load_f32(Ks, rows_of<float>(a.k, a, TK, b, h), a.st[TK][2], k0, S, tid);
  load_f32(Vs, rows_of<float>(a.v, a, TV, b, h), a.st[TV][2], k0, S, tid);
  const uint8_t* mrow = a.mask ? a.mask + (long long)b * S : nullptr;
  const int key = k0 + r;
  const bool kin = key < S && (!mrow || mrow[key]);
  const float* qb = rows_of<float>(a.q, a, TQ, b, h);
  const float* gb = rows_of<float>(a.dout, a, TDO, b, h);
  float dk[D / LANES], dv[D / LANES];
#pragma unroll
  for (int i = 0; i < D / LANES; ++i) dk[i] = dv[i] = 0.f;
  for (int j = a.causal ? kt : 0; j < nt; ++j) {
    const int q0 = j * FB;
    __syncthreads();   // the previous tile's reads are done
    load_f32(Qs, qb, a.st[TQ][2], q0, S, tid);
    load_f32(Gs, gb, a.st[TDO][2], q0, S, tid);
    if (tid < FB) {
      const int row = q0 + tid;
      Ls[tid] = row < S ? a.lse[(long long)bh * S + row] : INFINITY;
      Dl[tid] = row < S ? a.delta[(long long)bh * S + row] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < FB / LANES; ++u) {
      const int c = sub + LANES * u;
      const float s = dot_f32(Ks[r], Qs[c]);
      const float dp = dot_f32(Vs[r], Gs[c]);
      const bool ok = kin && !(a.causal && key > q0 + c);
      const float p = ok ? expf(fmaf(s, a.scale, -Ls[c])) : 0.f;
      Ps[r][c] = p;
      Ss[r][c] = p * (dp - Dl[c]);
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < FB; ++c) {
      const float p = Ps[r][c], ds = Ss[r][c];
#pragma unroll
      for (int i = 0; i < D / LANES; ++i) {
        dv[i] = fmaf(p, Gs[c][sub + LANES * i], dv[i]);
        dk[i] = fmaf(ds, Qs[c][sub + LANES * i], dk[i]);
      }
    }
  }
  if (key < S) {
    float* kout = rows_of<float>(a.dk, a, TDK, b, h) + key * a.st[TDK][2];
    float* vout = rows_of<float>(a.dv, a, TDV, b, h) + key * a.st[TDV][2];
#pragma unroll
    for (int i = 0; i < D / LANES; ++i) {
      kout[sub + LANES * i] = dk[i] * a.scale;
      vout[sub + LANES * i] = dv[i];
    }
  }
}

int smem_attr(const void* fn, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, k, v, dout, dq, dk, dv: (B, H, S,
// 64) through (batch, head, row) strides in elements, head dim
// contiguous; bf16 rows on 16 bytes (base pointers and strides).  lse:
// (B, H, S) fp32, contiguous, the forward's natural log-sum-exp; delta: a
// (B, H, S) fp32 scratch (rowsum(P dP), written by the first launch).
// mask: (B, S) uint8 or null.  Two launches on `stream`.
extern "C" int tts_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, void* delta, const void* mask, void* dq, void* dk,
    void* dv, int B, int H, int S, int dtype, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, long long gsb,
    long long gsh, long long gss, long long dqsb,
    long long dqsh, long long dqss, long long dksb, long long dksh,
    long long dkss, long long dvsb, long long dvsh, long long dvss,
    int causal, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const BwdArgs a{q, k, v, dout, static_cast<const float*>(lse),
                  static_cast<float*>(delta),
                  static_cast<const uint8_t*>(mask), dq, dk, dv, H, S,
                  causal, scale,
                  {{qsb, qsh, qss}, {ksb, ksh, kss}, {vsb, vsh, vss},
                   {gsb, gsh, gss}, {dqsb, dqsh, dqss}, {dksb, dksh, dkss},
                   {dvsb, dvsh, dvss}}};
  if (dtype == 1) {
    static const int attr = [] {
      const int rc = smem_attr(reinterpret_cast<const void*>(bwd_dq_tc),
                               SMEM_DQ);
      return rc ? rc
                : smem_attr(reinterpret_cast<const void*>(bwd_dkdv_tc),
                            SMEM_DKDV);
    }();
    if (attr) return attr;
    const dim3 grid((S + BT - 1) / BT, B * H);
    bwd_dq_tc<<<grid, THREADS, SMEM_DQ, st>>>(a);
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc) return rc;
    bwd_dkdv_tc<<<grid, THREADS, SMEM_DKDV, st>>>(a);
  } else {
    const dim3 grid((S + FB - 1) / FB, B * H);
    bwd_dq_f32<<<grid, THREADS, 0, st>>>(a);
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc) return rc;
    bwd_dkdv_f32<<<grid, THREADS, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
