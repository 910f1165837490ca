// K1: causal flash-attention forward for the UnifiedVoice trunk (the AR
// prefill and the latent pass).
//
// Replaces the TPU kernel tortoise_tts_tpu/ops/pallas_attention.py
// flash_attention (_attn_kernel): softmax(q k^T / sqrt(D) + key mask) v
// with a causal test, head dim 64.
//
// Bound on an H100: at the trunk's shapes (B = 1 or 8, H = 16, S ~ 68 for
// the prefill and ~269 for the latent pass, D = 64) the inputs are a few
// hundred KB and the work a few tens of MFLOP, so the byte bound is under
// a microsecond and one launch is latency bound long before either roof:
// what counts is how few dependent steps stand between the launch and the
// last store.
//
// bf16 design (flash_attn_mma<WK>): a block of 4 warps owns 16 * 4 / WK
// consecutive queries of one (batch, head), and WK warps (4, 2 or 1; the
// wrapper's plan, kernels/flash_attention.plan) share the keys of each
// 16-query tile: in every 64-key tile a warp takes the 16-key slices
// kk = kw, kw + WK, ...; at the end the WK partial softmax states of a
// tile are merged through shared memory.  Splitting the keys shortens the
// heaviest block's chain (the last query tile sees every key), which is
// what sets a call's time at these sizes.  Every key tile the block needs
// (never one above the diagonal; the last one only up to the 16 keys
// that hold kend) is copied into shared memory as bf16 by 16-byte
// cp.async, all at once when they fit (up to `nbuf` tiles, 16 KB each for
// K and V; beyond that a ring of nbuf tiles), into rows whose 16-byte
// chunks are XOR-swizzled by the row so ldmatrix reads are conflict-free;
// q and the key mask are loaded before the copies are issued, so they do
// not queue behind them.  Both products run on the tensor cores,
// mma.sync m16n8k16 bf16 with fp32 accumulation: S = Q K^T with the Q
// fragments held in registers for the whole key loop and K read by
// ldmatrix, then O += P V with V read by ldmatrix.trans, where P is the
// S accumulators rounded to bf16 in registers (two m16n8 accumulator tiles
// are one m16k16 A fragment).  The softmax is online in fp32, in the
// base-2 domain; each accumulator row is held by the four threads of a
// quad, which take the row max with two shuffles and the row sum once at
// the end.  Tiles are visited heaviest query block first.
//
// Semantics, as the plain version (ops/attention.py mha): a masked or
// causally excluded key in a visited tile scores the finite -1e9, so a row
// whose keys are partly masked gives the plain version's result and never
// NaN; keys past S (the ragged edge, masked here, nothing padded) are
// zero-filled in shared memory and take no weight.  q/k/v/o are read and
// written through strides, so the caller passes views of the fused qkv
// projection and gets the output in its (B, S, H, D) layout.  k and v
// need 16-byte aligned rows (the wrapper raises otherwise).
//
// With a non-null `lse` (the wrapper passes one only when autograd records
// the call, so no serving route writes it) both forms also write each
// row's natural log-sum-exp of its scaled, masked scores, (B, H, S) fp32:
// in flash_attn_mma after the WK warps' merge, so the merged row's max and
// sum.  K1's backward (flash_attention_bwd.cu) reads it.
//
// fp32 (flash_attn_f32, the fp32 training step and fp32 serving runs):
// the tensor cores in 3xTF32.  Each fp32 operand x is split into hi =
// cvt.rna.tf32(x) (13 low bits cleared) and lo = x - hi (exact), and each
// product sums lo hi + hi lo + hi hi in fp32 (lo lo, about 2^-22 of a
// term, dropped): fp32 accuracy, where one TF32 product would round every
// input to 11 significant bits.  Bound on an H100 at the AR training
// shapes (16, 16, 773, 64) and (8, 16, 389, 64): the two S x S x 64
// products of the causal half, three TF32 products each at 495 TFLOP/s,
// 0.119 and 0.0151 ms; fp32 bytes (q, k, v in, o out) take 0.0605 and
// 0.0152.  The design is K6's fp32 block (attention_bias.cuh,
// attn_bias_f32_block) with K and V in each other's roles: K's rows come
// channel-contiguous, already the K-major B operand of S = Q K^T, so K is
// only split where it lies; V is split and transposed to channel rows, the
// K-major B of O = P V (TF32 wgmma has no transpose bits).  One launch, no
// scratch: a persistent grid of one-warpgroup blocks, two an SM
// (kernels/flash_attention.fwd_f32_plan), each taking 64-query work items
// in a fixed order and walking only the key tiles at or under the
// diagonal; one thread keeps the next step's K and V tiles in flight by
// TMA (4-d maps over the strided views, 128-byte swizzle).  The causal
// test runs on the diagonal tile only, the key mask on every tile where
// there is one, S's edge on the last tile.  The details are at
// f32::flash_attn_f32.
#include "hopper.cuh"
#include "small_m_gemm.cuh"

#include <math.h>

namespace {

using small_m::cp_async16;
using small_m::cp_async_commit;
using small_m::mma_bf16;
using small_m::smem_u32;
using bf16 = __nv_bfloat16;

constexpr int D = 64;
constexpr int KT = 64;                   // keys a shared-memory tile
constexpr int TILE_BYTES = KT * D * 2;   // one bf16 K or V tile
constexpr int MERGE_BYTES = 4 * 36 * 32 * 4;   // 4 warps' partial states
constexpr float NEG_INF = -1e9f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// wait until at most n of this thread's cp.async groups are pending (n is
// known only at run time; above 7 the wait is for 7, which is stricter)
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: small_m::cp_async_wait<0>(); break;
    case 1: small_m::cp_async_wait<1>(); break;
    case 2: small_m::cp_async_wait<2>(); break;
    case 3: small_m::cp_async_wait<3>(); break;
    case 4: small_m::cp_async_wait<4>(); break;
    case 5: small_m::cp_async_wait<5>(); break;
    case 6: small_m::cp_async_wait<6>(); break;
    default: small_m::cp_async_wait<7>(); break;
  }
}

// byte offset of (row r, 16-byte chunk c) in a tile of 128-byte rows
__device__ __forceinline__ int swz(int r, int c) {
  return r * (D * 2) + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// bf16x2 {lo, hi}, round to nearest
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const uint8_t* mask;   // (B, S) or null
  bf16* o;
  float* lse;            // (B, H, S) or null
  int H, S, causal, nbuf;
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss;
  float scale;
};

// A warp's running softmax over its 16 query rows g and g + 8 (g = lane
// / 4): the 16 x 64 output accumulators in the m16n8 layout, the rows'
// maxima (base 2) and this thread's share of their sums.
struct State {
  float o[8][4];
  float m0, m1, l0, l1;
};

// One 64-key tile for one warp, which takes its 16-key slices kk = kw +
// WK i (i < 4 / WK) of it.  CHECK: the tile ends before 64 keys, has a key
// mask or crosses the causal edge, so each score is tested; a slice past
// kend or wholly above the warp's last row is skipped (scores -inf).
template <int WK, bool CHECK>
__device__ __forceinline__ void tile_step(State& st,
                                          const uint32_t (&qa)[4][4],
                                          uint32_t kt, uint32_t vt, int k0,
                                          int kend, int kw, int qw,
                                          const uint8_t* ms, const Args& a,
                                          int lane) {
  constexpr int NS = 4 / WK;
  const int g = lane >> 2, t = lane & 3;
  bool live[NS];
  bool any = false;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int key = k0 + 16 * (kw + WK * i);
    live[i] = !CHECK || (key < kend && !(a.causal && key > qw + 15));
    any |= live[i];
  }
  if (!any) return;   // warp-uniform
  // S = Q K^T for the n8 tiles 2 kk, 2 kk + 1 of each slice
  float s[2 * NS][4];
#pragma unroll
  for (int i = 0; i < NS; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[2 * i + e][0] = s[2 * i + e][1] = s[2 * i + e][2] =
          s[2 * i + e][3] = 0.f;
      if (!live[i]) continue;
      const int row = 16 * (kw + WK * i) + 8 * e + (lane & 7);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t kf[4];
        ldmatrix_x4(kf, kt + swz(row, 4 * half + (lane >> 3)));
        mma_bf16(s[2 * i + e], qa[2 * half], kf[0], kf[1]);
        mma_bf16(s[2 * i + e], qa[2 * half + 1], kf[2], kf[3]);
      }
    }
  }
  // scale into the base-2 domain and mask: s[2 i + e][c] is row g (c < 2)
  // or g + 8, key k0 + 16 kk + 8 e + 2 t + (c & 1)
  const float sl2 = a.scale * LOG2E;
  const int r0 = qw + g, r1 = r0 + 8;
  float mx0 = st.m0, mx1 = st.m1;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key0 = k0 + 16 * (kw + WK * i) + 8 * e + 2 * t;
      uint32_t mk = 0x0101u;   // the mask bytes of key0, key0 + 1
      if (CHECK && a.mask && key0 < kend)
        mk = *reinterpret_cast<const uint16_t*>(ms + key0);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[2 * i + e][c] * sl2;
        if (CHECK) {
          const int key = key0 + (c & 1);
          const bool ok = ((mk >> (8 * (c & 1))) & 0xffu) &&
                          (!a.causal || key <= (c < 2 ? r0 : r1));
          x = (!live[i] || key >= kend) ? -INFINITY
                                        : (ok ? x : NEG_INF * LOG2E);
        }
        s[2 * i + e][c] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[2 * i + e][0], s[2 * i + e][1]));
      mx1 = fmaxf(mx1, fmaxf(s[2 * i + e][2], s[2 * i + e][3]));
    }
  }
  // a live slice holds key k0 + 16 kk < kend, so the row maxima are finite
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float al0 = exp2f(st.m0 - mx0), al1 = exp2f(st.m1 - mx1);
  st.m0 = mx0;
  st.m1 = mx1;
  st.l0 *= al0;
  st.l1 *= al1;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    st.o[j][0] *= al0;
    st.o[j][1] *= al0;
    st.o[j][2] *= al1;
    st.o[j][3] *= al1;
  }
  // P as the A fragment of each slice's k16 step: its n8 tiles 2 i, 2 i + 1
  uint32_t pa[NS][4];
#pragma unroll
  for (int i = 0; i < NS; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float* x = s[2 * i + e];
      const float p0 = exp2f(x[0] - mx0), p1 = exp2f(x[1] - mx0);
      const float p2 = exp2f(x[2] - mx1), p3 = exp2f(x[3] - mx1);
      st.l0 += p0 + p1;
      st.l1 += p2 + p3;
      pa[i][2 * e] = pack_bf16(p0, p1);
      pa[i][2 * e + 1] = pack_bf16(p2, p3);
    }
  }
  // O += P V, V by ldmatrix.trans: keys 16 kk .. + 15, channels 8 jj ..
  const int mat = lane >> 3;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    if (!live[i]) continue;
    const int row = 16 * (kw + WK * i) + (lane & 7) + (mat & 1) * 8;
#pragma unroll
    for (int jj = 0; jj < 8; jj += 2) {
      uint32_t vf[4];
      ldmatrix_x4_trans(vf, vt + swz(row, jj + (mat >> 1)));
      mma_bf16(st.o[jj], pa[i], vf[0], vf[1]);
      mma_bf16(st.o[jj + 1], pa[i], vf[2], vf[3]);
    }
  }
}

// Dynamic shared memory: nbuf K tiles, nbuf V tiles (or, after the key
// loop, the warps' partial states, MERGE_BYTES), then the key mask's first
// kend bytes (with a mask).
// LSE: write a.lse (a separate instance, so the serving calls, which pass
// none, run the code they ran before the log-sum-exp existed)
template <int WK, bool LSE>
__global__ void __launch_bounds__(128, 1)
    flash_attn_mma(const __grid_constant__ Args a) {
  constexpr int WQ = 4 / WK;   // 16-query warp tiles a block
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kw = warp % WK;   // this warp's share of the keys
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * 16 * WQ;   // heaviest first
  const int kend = a.causal ? min(a.S, q0 + 16 * WQ) : a.S;
  const int ntiles = (kend + KT - 1) / KT;
  const int nbuf = a.nbuf;
  unsigned char* ks = smem;
  unsigned char* vs = smem + nbuf * TILE_BYTES;
  uint8_t* ms = smem + max(2 * nbuf * TILE_BYTES, MERGE_BYTES);
  const bf16* kb = a.k + b * a.ksb + h * a.ksh;
  const bf16* vb = a.v + b * a.vsb + h * a.vsh;

  // tile `tile` into buffer tile % nbuf (one commit group, empty past the
  // last tile): its keys below kend, rounded up to the 16 keys of a k16
  // step of P V; the rows past kend are zero-filled so they add nothing
  auto load_tile = [&](int tile) {
    if (tile < ntiles) {
      const int off = (tile % nbuf) * TILE_BYTES;
      const int rows = min(KT, (kend - tile * KT + 15) & ~15);
      for (int i = threadIdx.x; i < rows * 8; i += blockDim.x) {
        const int r = i >> 3, c = i & 7, j = tile * KT + r;
        const bool in = j < kend;
        const long long jj = in ? j : 0;
        cp_async16(ks + off + swz(r, c), kb + jj * a.kss + c * 8,
                   in ? 16 : 0);
        cp_async16(vs + off + swz(r, c), vb + jj * a.vss + c * 8,
                   in ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  // this warp's 16 query rows: qw + g and qw + g + 8
  const int qw = q0 + 16 * (warp / WK);
  const int r0 = qw + g, r1 = r0 + 8;
  uint32_t qa[4][4];
  {
    const bf16* qb = a.q + b * a.qsb + h * a.qsh;
    const bf16* p0 = qb + (long long)min(r0, a.S - 1) * a.qss + 2 * t;
    const bf16* p1 = qb + (long long)min(r1, a.S - 1) * a.qss + 2 * t;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      qa[kk][0] = r0 < a.S ? ld32(p0 + 16 * kk) : 0u;
      qa[kk][1] = r1 < a.S ? ld32(p1 + 16 * kk) : 0u;
      qa[kk][2] = r0 < a.S ? ld32(p0 + 16 * kk + 8) : 0u;
      qa[kk][3] = r1 < a.S ? ld32(p1 + 16 * kk + 8) : 0u;
    }
  }

  // the key mask's bytes (MB a thread; longer rows take more rounds): the
  // first round and q are loaded before the tiles' copies are issued, so
  // these few bytes do not queue behind them
  constexpr int MB = 4;
  const uint8_t* mrow = a.mask ? a.mask + (long long)b * a.S : nullptr;
  const int nthr = blockDim.x;
  auto mask_round = [&](int j0, uint8_t (&mv)[MB]) {
#pragma unroll
    for (int u = 0; u < MB; ++u) {
      const int j = j0 + u * nthr;
      mv[u] = j < kend ? mrow[j] : 0;
    }
  };
  auto mask_store = [&](int j0, const uint8_t (&mv)[MB]) {
#pragma unroll
    for (int u = 0; u < MB; ++u)
      if (j0 + u * nthr < kend) ms[j0 + u * nthr] = mv[u];
  };
  uint8_t mv[MB];
  if (mrow) mask_round(threadIdx.x, mv);
  for (int i = 0; i < nbuf; ++i) load_tile(i);
  if (mrow) {
    mask_store(threadIdx.x, mv);
    for (int j0 = threadIdx.x + MB * nthr; j0 < kend; j0 += MB * nthr) {
      mask_round(j0, mv);
      mask_store(j0, mv);
    }
  }

  State st;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    st.o[j][0] = st.o[j][1] = st.o[j][2] = st.o[j][3] = 0.f;
  st.m0 = st.m1 = -INFINITY;
  st.l0 = st.l1 = 0.f;
  const bool warp_live = qw < a.S;

  for (int tile = 0; tile < ntiles; ++tile) {
    cp_async_wait_upto(nbuf - 1);
    __syncthreads();
    const int k0 = tile * KT;
    // warp-uniform: a tile wholly above this warp's last row is skipped
    if (warp_live && !(a.causal && k0 > qw + 15)) {
      const uint32_t kt = smem_u32(ks + (tile % nbuf) * TILE_BYTES);
      const uint32_t vt = smem_u32(vs + (tile % nbuf) * TILE_BYTES);
      if (k0 + KT > kend || a.mask || (a.causal && k0 + KT - 1 > qw))
        tile_step<WK, true>(st, qa, kt, vt, k0, kend, kw, qw, ms, a, lane);
      else
        tile_step<WK, false>(st, qa, kt, vt, k0, kend, kw, qw, ms, a, lane);
    }
    if (tile + nbuf < ntiles) __syncthreads();   // the buffer is reused
    load_tile(tile + nbuf);
  }

  if (WK > 1) {   // the key shares of each query tile, into warp kw = 0
    float* part = reinterpret_cast<float*>(smem);   // [warp][36][32]
    __syncthreads();   // every warp is done with the tiles
    if (warp_live && kw != 0) {
      float* pp = part + warp * 36 * 32 + lane;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) pp[(4 * j + c) * 32] = st.o[j][c];
      pp[32 * 32] = st.m0;
      pp[33 * 32] = st.m1;
      pp[34 * 32] = st.l0;
      pp[35 * 32] = st.l1;
    }
    __syncthreads();
    if (!warp_live || kw != 0) return;
#pragma unroll
    for (int r = 1; r < WK; ++r) {
      const float* pp = part + (warp + r) * 36 * 32 + lane;
      const float pm0 = pp[32 * 32], pm1 = pp[33 * 32];
      const float n0 = fmaxf(st.m0, pm0), n1 = fmaxf(st.m1, pm1);
      // a share that saw no key has m = -inf: its weight is 0
      const float c0 = exp2f(st.m0 - n0), d0 = exp2f(pm0 - n0);
      const float c1 = exp2f(st.m1 - n1), d1 = exp2f(pm1 - n1);
      st.l0 = st.l0 * c0 + pp[34 * 32] * d0;
      st.l1 = st.l1 * c1 + pp[35 * 32] * d1;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        st.o[j][0] = st.o[j][0] * c0 + pp[(4 * j) * 32] * d0;
        st.o[j][1] = st.o[j][1] * c0 + pp[(4 * j + 1) * 32] * d0;
        st.o[j][2] = st.o[j][2] * c1 + pp[(4 * j + 2) * 32] * d1;
        st.o[j][3] = st.o[j][3] * c1 + pp[(4 * j + 3) * 32] * d1;
      }
      st.m0 = n0;
      st.m1 = n1;
    }
  } else if (!warp_live) {
    return;
  }
  st.l0 += __shfl_xor_sync(0xffffffffu, st.l0, 1);
  st.l0 += __shfl_xor_sync(0xffffffffu, st.l0, 2);
  st.l1 += __shfl_xor_sync(0xffffffffu, st.l1, 1);
  st.l1 += __shfl_xor_sync(0xffffffffu, st.l1, 2);
  const float i0 = 1.f / st.l0, i1 = 1.f / st.l1;
  if (LSE && t == 0) {   // m is base 2, of the scaled scores
    float* lp = a.lse + (long long)blockIdx.y * a.S;
    if (r0 < a.S) lp[r0] = (st.m0 + log2f(st.l0)) * LN2;
    if (r1 < a.S) lp[r1] = (st.m1 + log2f(st.l1)) * LN2;
  }
  bf16* ob = a.o + b * a.osb + h * a.osh + 2 * t;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (r0 < a.S)
      *reinterpret_cast<uint32_t*>(ob + (long long)r0 * a.oss + 8 * j) =
          pack_bf16(st.o[j][0] * i0, st.o[j][1] * i0);
    if (r1 < a.S)
      *reinterpret_cast<uint32_t*>(ob + (long long)r1 * a.oss + 8 * j) =
          pack_bf16(st.o[j][2] * i1, st.o[j][3] * i1);
  }
}

// --- fp32: 3xTF32 tensor cores ------------------------------------------------

namespace f32 {

using hopper::desc_sw128;
using hopper::ex2;
using hopper::fence_barrier_init;
using hopper::fence_proxy_async;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::reg_fence;
using hopper::tf32_split;
using hopper::wait_or_trap;
using hopper::wgmma_commit;
using hopper::wgmma_fence;
using hopper::wgmma_tf32_rs;
using hopper::wgmma_wait;

constexpr int BT = 64;                  // queries an item, keys a step
constexpr int BOX = 32 * BT * 4;        // one TMA box: 32 channels x 64 rows
constexpr int TILE = 2 * BOX;           // a 64 x 64 fp32 tile, 16 KB
// shared memory past its 1024-byte aligned base: the raw step (K and V as
// copied), K's split (hi, lo), V's split and transposed (V^T hi, lo), the
// step's 64 key-mask bytes, the step's mbarrier
constexpr int K_RAW = 0, V_RAW = TILE, K_HI = 2 * TILE, K_LO = 3 * TILE;
constexpr int VT_HI = 4 * TILE, VT_LO = 5 * TILE;
constexpr int MASK_OFF = 6 * TILE, BAR_OFF = MASK_OFF + BT;
constexpr int SMEM = BAR_OFF + 8 + 1024;
constexpr int THREADS = 128;            // one warpgroup
constexpr int MIN_BLOCKS = 2;           // blocks an SM: 255 registers

// K and V as TMA maps over the (B, H, S, 64) fp32 views: four dimensions
// (64, S, H, B), or (64, H, S, B) where the head stride is the smaller
// (hfirst: the fused qkv), boxes of 32 channels x 64 rows
struct FwdArgs {
  CUtensorMap kmap, vmap;
  const float* q;
  const uint8_t* mask;    // (B, S) or null
  float* o;
  float* lse;             // (B, H, S) or null
  int H, S, BH, causal, items, order, khf, vhf;
  long long qsb, qsh, qss, osb, osh, oss;
  float scale;
};

// byte offset of element (r, c) of a 64 x 64 fp32 tile kept as two boxes
// of 32 columns with the 128-byte swizzle (16-byte chunk c / 4 of row r,
// within its box, at chunk (c / 4 ^ r) % 8), as TMA writes it
__device__ __forceinline__ uint32_t sw32(int r, int c) {
  return (c >> 5) * BOX + r * 128 + ((((c >> 2) ^ r) & 7) << 4) +
         (c & 3) * 4;
}

// x's hi and lo parts to dst_hi and dst_lo, 16 bytes each
__device__ __forceinline__ void split_store(unsigned char* dst_hi,
                                            unsigned char* dst_lo,
                                            float x0, float x1, float x2,
                                            float x3) {
  uint4 hi, lo;
  tf32_split(x0, hi.x, lo.x);
  tf32_split(x1, hi.y, lo.y);
  tf32_split(x2, hi.z, lo.z);
  tf32_split(x3, hi.w, lo.w);
  *reinterpret_cast<uint4*>(dst_hi) = hi;
  *reinterpret_cast<uint4*>(dst_lo) = lo;
}

// Work item w: (64-query tile qt, (batch, head) bh).  order 0: (batch,
// head)-major, each (batch, head)'s tiles heaviest (last) first; 1: the
// heaviest tiles of every (batch, head) first
// (kernels/flash_attention.fwd_f32_items mirrors this).
__device__ __forceinline__ void item_of(const FwdArgs& a, int w, int& qt,
                                        int& bh) {
  const int nq = (a.S + BT - 1) / BT;
  if (a.order == 0) {
    bh = w / nq;
    qt = nq - 1 - w % nq;
  } else {
    qt = nq - 1 - w / a.BH;
    bh = w % a.BH;
  }
}

// rows row .. row + 63 of (batch b, head h), both 32-channel boxes
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         int hf, uint32_t bar, int row, int h,
                                         int b) {
#pragma unroll
  for (int c = 0; c < 2; ++c)
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
            dst + c * BOX),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(32 * c),
        "r"(hf ? h : row), "r"(hf ? row : h), "r"(b)
        : "memory");
}

// One 64-key step's online softmax for a consumer thread (rows g and g + 8
// of its warp's 16, keys 8 j + 2 t4 + {0, 1}): x = s * scale, where CHECK
// a key at or past S at -inf and a masked or causally excluded key at the
// finite -1e9 (as the plain version); then p = 2^(x log2 e - m) in place.
// The base m (log2 units) moves, and O and l are rescaled, only where a
// row's max passes it by 8, so p <= 2^8.
template <bool CHECK>
__device__ __forceinline__ void softmax_step(float (&sc)[32], float (&o)[32],
                                             float& m0, float& m1, float& l0,
                                             float& l1, const FwdArgs& a,
                                             const uint8_t* ms, bool masked,
                                             int k0, int q0, int r, int t4) {
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    float x = sc[i] * a.scale;
    if (CHECK) {
      const int col = 8 * (i / 4) + 2 * t4 + (i & 1);
      const int row = q0 + r + 8 * ((i >> 1) & 1);
      const bool out = (a.causal && k0 + col > row) || (masked && !ms[col]);
      x = k0 + col >= a.S ? -INFINITY : (out ? NEG_INF : x);
    }
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
  mx0 *= LOG2E;   // finite: the step's first key is below S
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
}

// The persistent fp32 kernel: block i takes work items i, i + grid, ...
// (item_of).  An item is one (batch, head)'s 64-query tile, held by the
// block's warpgroup (each warp 16 rows), walking the key tiles 0 .. qt
// (causal) or all.  Thread 0 keeps one raw stage in flight: the next step's
// K and V tiles (the next item's first when this item ends) are issued as
// soon as this step's are split.
//
// Per step: the raw K and V arrive (TMA, rows past S as zeros); every
// thread splits its share of K as it lies (the K-major B of S = Q K^T) and
// of V transposed to channel rows (the K-major B of O = P V), each row's
// 8-key groups reordered 0, 2, 4, 6, 1, 3, 5, 7 (a P accumulator's two
// columns of each 8-key group are its A slice's columns t4 and t4 + 4),
// in units of 4 keys x 4 channels whose reads and writes each fall on 8
// distinct 16-byte chunks a quarter-warp; threads 0-63 bring the step's
// key-mask bytes; a barrier frees the raw stage; S = Q K^T (24 wgmma,
// Q's split A slices in registers since the item began); the softmax; P
// V (24 wgmma, P split in registers) into a fresh accumulator added to O
// in fp32.  Each step's products are lo hi + hi lo + hi hi of the TF32
// splits (lo lo dropped).
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    flash_attn_f32(const __grid_constant__ FwdArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const uint8_t* ms = sm + MASK_OFF;
  const uint32_t full = base + BAR_OFF;
  const int tid = threadIdx.x, lane = tid % 32;
  const int r = 16 * (tid / 32) + lane / 4, t4 = lane % 4;
  const int S = a.S, nq = (S + BT - 1) / BT;

  if (tid == 0) {
    mbar_init(full, 1);
    fence_barrier_init();
  }
  __syncthreads();

  // step j of item w: K and V rows 64 j .. 64 j + 63 into the raw stage
  auto fill = [&](int w, int j) {
    int qt, bh;
    item_of(a, w, qt, bh);
    const int b = bh / a.H, h = bh % a.H;
    mbar_expect_tx(full, 2 * TILE);
    tma_tile(base + K_RAW, &a.kmap, a.khf, full, BT * j, h, b);
    tma_tile(base + V_RAW, &a.vmap, a.vhf, full, BT * j, h, b);
  };
  if (tid == 0 && (int)blockIdx.x < a.items) fill(blockIdx.x, 0);
  uint32_t phase = 0;

  for (int w = blockIdx.x; w < a.items; w += gridDim.x) {
    int qt, bh;
    item_of(a, w, qt, bh);
    const int b = bh / a.H, h = bh % a.H, q0 = BT * qt;
    const int steps = a.causal ? qt + 1 : nq;
    const uint8_t* mrow = a.mask ? a.mask + (long long)b * S : nullptr;

    // Q's A slices for the item, split: slice kk's a[i] is channel 8 kk +
    // t4 + 4 (i / 2) of row r + 8 (i % 2) (zero past S)
    uint32_t qh[8][4], ql[8][4];
    {
      const float* qb = a.q + b * a.qsb + h * a.qsh;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = q0 + r + 8 * (i % 2);
          const float x =
              row < S ? qb[(long long)row * a.qss + 8 * kk + t4 + 4 * (i / 2)]
                      : 0.f;
          tf32_split(x, qh[kk][i], ql[kk][i]);
        }
    }
    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    // the exponent base (log2 units) and this thread's share of the row
    // sums, of rows r and r + 8
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    for (int j = 0; j < steps; ++j) {
      const int k0 = BT * j;
      // this step's raw tiles are in, and every warp is done with the
      // previous step's products (their split operands are rewritten)
      wait_or_trap(full, phase);
      phase ^= 1;
      __syncthreads();
      // K as it lies: the same swizzled layout, split
#pragma unroll
      for (int it = 0; it < 8; ++it) {
        const int off = 16 * (tid + THREADS * it);
        const float4 x = *reinterpret_cast<const float4*>(sm + K_RAW + off);
        split_store(sm + K_HI + off, sm + K_LO + off, x.x, x.y, x.z, x.w);
      }
      // V transposed: unit u (of 256) is keys 8 G + par + {0, 2, 4, 6} and
      // channels 4 c4 + {0..3}; a quarter-warp's 8 units (z = u / 8)
      // differ in par, c4's bits 1-2 and G's bits 0-1, so the raw rows' and
      // V^T rows' 16-byte chunks it touches are 8 distinct ones
#pragma unroll
      for (int it = 0; it < 2; ++it) {
        const int u = tid + THREADS * it, qq = u & 7, z = u >> 3;
        const int par = qq & 1;
        const int c4 = (qq & 6) | ((z >> 2) & 1) | (((z >> 3) & 1) << 3);
        const int G = (((qq >> 1) ^ z) & 3) | (((z >> 4) & 1) << 2);
        float vr[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 x = *reinterpret_cast<const float4*>(
              sm + V_RAW + sw32(8 * G + par + 2 * i, 4 * c4));
          vr[i][0] = x.x;
          vr[i][1] = x.y;
          vr[i][2] = x.z;
          vr[i][3] = x.w;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const uint32_t at = sw32(4 * c4 + c, 8 * G + 4 * par);
          split_store(sm + VT_HI + at, sm + VT_LO + at, vr[0][c], vr[1][c],
                      vr[2][c], vr[3][c]);
        }
      }
      if (mrow && tid < BT)
        sm[MASK_OFF + tid] = k0 + tid < S ? mrow[k0 + tid] : 0;
      fence_proxy_async();   // the split operands, for wgmma
      __syncthreads();       // and the raw stage is free
      if (tid == 0) {
        if (j + 1 < steps)
          fill(w, j + 1);
        else if (w + (int)gridDim.x < a.items)
          fill(w + gridDim.x, 0);
      }

      // S = Q K^T: per 8-channel slice lo hi + hi lo + hi hi
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint32_t so = (kk / 4) * BOX + 32 * (kk % 4);
        const uint64_t dh = desc_sw128(base + K_HI + so, 16, 1024);
        const uint64_t dl = desc_sw128(base + K_LO + so, 16, 1024);
        wgmma_tf32_rs<64>(sc, ql[kk], dh);
        wgmma_tf32_rs<64>(sc, qh[kk], dl);
        wgmma_tf32_rs<64>(sc, qh[kk], dh);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(sc);

      // causal on the diagonal tile, the key mask on every tile, S's edge
      // on the last
      if ((a.causal && j == qt) || mrow || k0 + BT > S)
        softmax_step<true>(sc, o, m0, m1, l0, l1, a, ms, mrow != nullptr,
                           k0, q0, r, t4);
      else
        softmax_step<false>(sc, o, m0, m1, l0, l1, a, ms, false, k0, q0, r,
                            t4);

      // O += P V: accumulator block kk's columns 2 t4 and 2 t4 + 1 are the
      // A slice's columns t4 and t4 + 4, the keys V^T's rows hold there.
      // The step's products go to a fresh accumulator, added to O in fp32:
      // the tensor cores' accumulation is not round-to-nearest.
      uint32_t ph[8][4], pl[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        tf32_split(sc[4 * kk], ph[kk][0], pl[kk][0]);
        tf32_split(sc[4 * kk + 2], ph[kk][1], pl[kk][1]);
        tf32_split(sc[4 * kk + 1], ph[kk][2], pl[kk][2]);
        tf32_split(sc[4 * kk + 3], ph[kk][3], pl[kk][3]);
      }
      float po[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) po[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint32_t so = (kk / 4) * BOX + 32 * (kk % 4);
        const uint64_t dh = desc_sw128(base + VT_HI + so, 16, 1024);
        const uint64_t dl = desc_sw128(base + VT_LO + so, 16, 1024);
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
    }

    // O / l into the (B, S, H, 64) rows; each row's log-sum-exp
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float i0 = 1.f / l0, i1 = 1.f / l1;
    const int r0 = q0 + r, r1 = r0 + 8;
    float* ob = a.o + b * a.osb + h * a.osh + 2 * t4;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      if (r0 < S)
        *reinterpret_cast<float2*>(ob + (long long)r0 * a.oss + 8 * jj) =
            make_float2(o[4 * jj] * i0, o[4 * jj + 1] * i0);
      if (r1 < S)
        *reinterpret_cast<float2*>(ob + (long long)r1 * a.oss + 8 * jj) =
            make_float2(o[4 * jj + 2] * i1, o[4 * jj + 3] * i1);
    }
    if (a.lse && t4 == 0) {   // m is base 2, of the scaled scores
      float* lp = a.lse + (long long)bh * S;
      if (r0 < S) lp[r0] = (m0 + log2f(l0)) * LN2;
      if (r1 < S) lp[r1] = (m1 + log2f(l1)) * LN2;
    }
  }
}

// tensor t's TMA map: an fp32 (B, H, S, 64) view with (batch, head, row)
// strides st in elements, as four dimensions whose strides grow; *hf: the
// head dimension comes before the rows
int rows_map(CUtensorMap* map, int* hf, const float* base, int B, int H,
             int S, long long sb, long long sh, long long ss) {
  hopper::EncodeTiled fn = hopper::encode_tiled();
  if (fn == nullptr) return hopper::ERR_NO_ENCODER;
  *hf = sh < ss;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(*hf ? H : S),
                              static_cast<cuuint64_t>(*hf ? S : H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {4ull * (*hf ? sh : ss),
                                 4ull * (*hf ? ss : sh), 4ull * sb};
  const cuuint32_t box[4] = {32, *hf ? 1u : BT, *hf ? BT : 1u, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  return hopper::map_result(
      fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(base),
         dims, strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

int launch(FwdArgs& p, const float* k, const float* v, int B,
           const long long (&ks)[3], const long long (&vs)[3], int grid,
           cudaStream_t st) {
  if (grid < 1 || grid > p.items)
    return static_cast<int>(cudaErrorInvalidValue);
  if (int rc = rows_map(&p.kmap, &p.khf, k, B, p.H, p.S, ks[0], ks[1], ks[2]))
    return rc;
  if (int rc = rows_map(&p.vmap, &p.vhf, v, B, p.H, p.S, vs[0], vs[1], vs[2]))
    return rc;
  static const int attr = [] {
    int rc = static_cast<int>(cudaFuncSetAttribute(
        flash_attn_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM));
    if (!rc)
      rc = static_cast<int>(cudaFuncSetAttribute(
          flash_attn_f32, cudaFuncAttributePreferredSharedMemoryCarveout,
          100));
    return rc;
  }();
  if (attr) return attr;
  flash_attn_f32<<<grid, THREADS, SMEM, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

template <int WK, bool LSE>
int launch_mma(const Args& a, int B, int qtiles, int smem, cudaStream_t st) {
  static int allowed = 48 * 1024;
  if (smem > allowed) {
    const int rc = static_cast<int>(cudaFuncSetAttribute(
        flash_attn_mma<WK, LSE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
    if (rc) return rc;
    allowed = smem;
  }
  flash_attn_mma<WK, LSE><<<dim3(qtiles, B * a.H), 128, smem, st>>>(a);
  return 0;
}

template <int WK>
int launch_mma(const Args& a, int B, int qtiles, int smem, cudaStream_t st) {
  return a.lse ? launch_mma<WK, true>(a, B, qtiles, smem, st)
               : launch_mma<WK, false>(a, B, qtiles, smem, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the last
// (head-dim) stride of every tensor is 1.  bf16: k and v rows 16-byte
// aligned (base pointers and the b, h, s strides), q's even; float32: k
// and v rows 16-byte aligned (TMA), q any.  mask: (B, S) uint8 or null.
// lse: (B, H, S) fp32 or null (written when given).  bf16 launch plan
// (kernels/flash_attention.plan): `wk` warps (1, 2 or 4) share each
// 16-query tile's keys, so a block of 4 warps holds 4 / wk query tiles;
// `qtiles` = ceil(S / (16 * 4 / wk)) blocks a (batch, head); `nbuf` key
// tiles resident in shared memory.  float32 launch plan
// (kernels/flash_attention.fwd_f32_plan): `grid` persistent blocks, from
// 1 to the B * H * ceil(S / 64) work items, taken in item order `order`.
extern "C" int tts_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* mask, void* o,
    void* lse, int B, int H, int S, int dtype, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss, long long vsb,
    long long vsh, long long vss, long long osb, long long osh, long long oss,
    int causal, float scale, int wk, int qtiles, int nbuf, int grid,
    int order, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* mk = static_cast<const uint8_t*>(mask);
  if (dtype == 1) {
    const Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                 static_cast<const bf16*>(v), mk, static_cast<bf16*>(o),
                 static_cast<float*>(lse), H, S, causal, nbuf, qsb, qsh,
                 qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss, scale};
    const int body = 2 * nbuf * TILE_BYTES > MERGE_BYTES
                         ? 2 * nbuf * TILE_BYTES
                         : MERGE_BYTES;
    const int smem = body + (mask ? ((S + 15) & ~15) : 0);
    const int rc = wk == 4   ? launch_mma<4>(a, B, qtiles, smem, st)
                   : wk == 2 ? launch_mma<2>(a, B, qtiles, smem, st)
                             : launch_mma<1>(a, B, qtiles, smem, st);
    if (rc) return rc;
    return static_cast<int>(cudaGetLastError());
  }
  f32::FwdArgs p{};
  p.q = static_cast<const float*>(q);
  p.mask = mk;
  p.o = static_cast<float*>(o);
  p.lse = static_cast<float*>(lse);
  p.H = H;
  p.S = S;
  p.BH = B * H;
  p.causal = causal;
  p.items = B * H * ((S + f32::BT - 1) / f32::BT);
  p.order = order;
  p.qsb = qsb;
  p.qsh = qsh;
  p.qss = qss;
  p.osb = osb;
  p.osh = osh;
  p.oss = oss;
  p.scale = scale;
  return f32::launch(p, static_cast<const float*>(k),
                     static_cast<const float*>(v), B, {ksb, ksh, kss},
                     {vsb, vsh, vss}, grid, st);
}
