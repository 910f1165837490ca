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
// fp32 (flash_attn_f32) keeps CUDA-core FMAs: TF32 would round the fp32
// parity runs' inputs.  One block of 64 threads per (16-query tile,
// batch*head); four threads share a query row, each owning 16 of its 64
// channels; K/V tiles of 64 keys are staged in shared memory and read by
// broadcast; a score is the four partial dots summed by two shuffles.
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

// --- fp32: CUDA-core FMAs ---------------------------------------------------

constexpr int LANES = 4;        // threads per query row
constexpr int DL = D / LANES;   // channels per thread
constexpr int BQ = 16;          // queries per block
constexpr int THREADS_F32 = BQ * LANES;
constexpr int CH = 16;          // keys per online-softmax rescale

__global__ void __launch_bounds__(THREADS_F32)
    flash_attn_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const uint8_t* __restrict__ mask, float* __restrict__ o,
                   float* __restrict__ lse, int H, int S, long long qsb,
                   long long qsh, long long qss, long long ksb, long long ksh,
                   long long kss, long long vsb, long long vsh, long long vss,
                   long long osb, long long osh, long long oss, int causal,
                   float scale) {
  __shared__ float Ks[KT][D + 1];
  __shared__ float Vs[KT][D + 1];
  __shared__ uint8_t Ms[KT];

  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int q0 = blockIdx.x * BQ;
  const int sub = threadIdx.x % LANES;
  const int qi = q0 + threadIdx.x / LANES;
  const bool active = qi < S;

  float qr[DL], acc[DL];
  const float* qp = q + b * qsb + h * qsh + (long long)(active ? qi : 0) * qss;
#pragma unroll
  for (int i = 0; i < DL; ++i) {
    qr[i] = qp[LANES * i + sub];
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  const int kend = causal ? min(S, q0 + BQ) : S;
  const float* kb = k + b * ksb + h * ksh;
  const float* vb = v + b * vsb + h * vsh;
  for (int k0 = 0; k0 < kend; k0 += KT) {
    __syncthreads();
    // pairs of channels, consecutive threads on consecutive pairs of a row
#pragma unroll 4
    for (int idx = threadIdx.x; idx < KT * D / 2; idx += THREADS_F32) {
      const int r = idx / (D / 2), c2 = 2 * (idx % (D / 2));
      const int j = k0 + r;
      float2 kv = make_float2(0.f, 0.f), vv = kv;
      if (j < kend) {
        kv = *reinterpret_cast<const float2*>(kb + (long long)j * kss + c2);
        vv = *reinterpret_cast<const float2*>(vb + (long long)j * vss + c2);
      }
      Ks[r][c2] = kv.x;
      Ks[r][c2 + 1] = kv.y;
      Vs[r][c2] = vv.x;
      Vs[r][c2 + 1] = vv.y;
    }
    if (threadIdx.x < KT) {
      const int j = k0 + threadIdx.x;
      Ms[threadIdx.x] = j < S ? (mask ? mask[(long long)b * S + j] : 1) : 0;
    }
    __syncthreads();
    const int nk = min(KT, kend - k0);
    for (int c = 0; c < nk; c += CH) {
      // entry c is always < nk, so every chunk has a finite score and
      // the running max never stays -inf
      float s[CH];
      float cmax = -INFINITY;
#pragma unroll
      for (int u = 0; u < CH; ++u) {
        const int jj = c + u;
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < DL; ++i)
          dot = fmaf(qr[i], Ks[jj][LANES * i + sub], dot);
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        const bool in_range = jj < nk;
        const bool ok = in_range && Ms[jj] != 0 && (!causal || k0 + jj <= qi);
        s[u] = ok ? dot * scale : (in_range ? NEG_INF : -INFINITY);
        cmax = fmaxf(cmax, s[u]);
      }
      const float mn = fmaxf(m, cmax);
      const float alpha = expf(m - mn);
      l *= alpha;
#pragma unroll
      for (int i = 0; i < DL; ++i) acc[i] *= alpha;
#pragma unroll
      for (int u = 0; u < CH; ++u) {
        const float p = expf(s[u] - mn);
        l += p;
#pragma unroll
        for (int i = 0; i < DL; ++i)
          acc[i] = fmaf(p, Vs[c + u][LANES * i + sub], acc[i]);
      }
      m = mn;
    }
  }
  if (active) {
    const float inv = 1.f / l;
    float* op = o + b * osb + h * osh + (long long)qi * oss;
#pragma unroll
    for (int i = 0; i < DL; ++i) op[LANES * i + sub] = acc[i] * inv;
    if (lse && sub == 0) lse[(long long)blockIdx.y * S + qi] = m + logf(l);
  }
}

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
// and v aligned to two elements with even strides.  mask: (B, S) uint8
// or null.  lse: (B, H, S) fp32 or null (written when given).  bf16
// launch plan (kernels/flash_attention.plan): `wk` warps
// (1, 2 or 4) share each 16-query tile's keys, so a block of 4 warps
// holds 4 / wk query tiles; `qtiles` = ceil(S / (16 * 4 / wk)) blocks a
// (batch, head); `nbuf` key tiles resident in shared memory.
extern "C" int tts_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* mask, void* o,
    void* lse, int B, int H, int S, int dtype, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss, long long vsb,
    long long vsh, long long vss, long long osb, long long osh, long long oss,
    int causal, float scale, int wk, int qtiles, int nbuf, void* stream) {
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
  } else {
    flash_attn_f32<<<dim3((S + BQ - 1) / BQ, B * H), THREADS_F32, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), mk, static_cast<float*>(o),
        static_cast<float*>(lse), H, S, qsb, qsh, qss, ksb, ksh, kss, vsb,
        vsh, vss, osb, osh, oss, causal, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
