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
// - bwd_dq_*: a query tile walks the key tiles up to the diagonal twice,
//   recomputing S and dP: first into its rows' Delta (written for the
//   next kernel, beside the rows' LSE in base 2), then into dQ;
// - bwd_dkdv_*: a key tile walks the query tiles from the diagonal down,
//   recomputing S^T and dP^T, into dK and dV.
//
// Bound on an H100: at the AR steps' shapes, (B, H, S, D) = (16, 16, 773,
// 64) and (8, 16, 389, 64), the function needs five S x S x 64 products
// over the causal half (S, dP, dV, dK, dQ; 49 and 6.2 GFLOP, 0.050 and
// 0.0063 ms at 989 TFLOP/s) and moves q, k, v, dO in and dq, dk, dv out
// (178 and 45 MB in bf16, 0.053 and 0.013 ms at 3.35 TB/s).  The kernels
// run nine products (S and dP three times: Delta's pass, dQ's, dK's and
// dV's; 0.089 and 0.011 ms) and three exp2 passes over the causal half:
// the price of a deterministic dQ without atomics or ordered adds and of
// a Delta consistent with P.  What sets the time is keeping the tensor
// cores fed between the products' dependent steps: the exp2s alone (16 an
// SM a clock) take about as long as the products.
//
// bf16 design (bwd_dq_ws, bwd_dkdv_ws): warp-specialised, persistent.  A
// block is two consumer warpgroups and a producer warpgroup (384 threads,
// one block an SM; setmaxnreg gives the consumers 232 registers a thread
// and the producer 40); the grid is one block an SM (the plan,
// kernels/flash_attention.bwd_plan), each block walking the work items b,
// b + grid, ... of a heaviest-first order.  A work item is 128 resident
// rows of one (batch, head) (query rows with Q and dO in bwd_dq_ws, key
// rows with K and V in bwd_dkdv_ws), 64 for each consumer warpgroup, which
// holds its rows as register A operands (ldmatrix), so S and dP read only
// their B tile from shared memory; the other two tensors stream past in
// 64-row tiles.  One thread of the producer warpgroup issues every copy as
// TMA (cp.async.bulk.tensor, 4-d maps over the strided (B, H, S, 64)
// views, 64 x 64 boxes in the 128-byte swizzle that wgmma reads; rows
// past S arrive as zeros): the resident tiles into one of two buffers (the
// next item's land while this one's run), the streamed tiles into a ring
// of STAGES stages, each with a full and an empty mbarrier (the empty one
// counts one arrival per consumer warpgroup once its products have read
// the stage).  In bwd_dkdv_ws each stage also brings its query rows' LSE2
// and Delta (a 512-byte bulk copy of what bwd_dq_ws wrote, padded to 64
// rows a tile).  The consumers issue no copies and meet at no block-wide
// barrier: each warpgroup waits on its stage's mbarrier, and one step
// issues the previous tile's dependent products (dQ, or dV and dK) with
// this tile's S and dP as one commit group (wgmma m64n64k16, fp32
// accumulators) before that tile's exp2/dS arithmetic; the SM's other
// warpgroup's products run beside it.  (Tried on the card and slower:
// FA3's turns between the two warpgroups by named barriers; the
// dependent products as a second group waited for after the arithmetic;
// 128-key tiles with m64n128 products in bwd_dq_ws.  A deeper ring or a
// (batch, head)-major item order changed little.)  exp2 is one MUFU
// instruction (ex2.approx.ftz: weights under 2^-126 flush to 0), and the
// causal, ragged and key-mask limits are applied without a branch a
// value, on the tiles that need them only (a branch a value was the
// largest cost on the card).  Keys as rows suit wgmma: in bwd_dkdv_ws a warpgroup owns 64 keys, S^T = K Q^T
// and dP^T = V dO^T land with P^T and dS^T in the accumulator layout of a
// register A operand (two n8 accumulator blocks, rounded to bf16, are one
// k16 slice), so dV += P^T dO and dK += dS^T Q take them from registers
// with the streamed Q and dO tiles as MN-major B.  bwd_dq_ws is the
// mirror: S = Q K^T and dP = dO V^T with K-major B, dQ += dS K with dS
// from registers and the K tile as MN-major B.  A warpgroup whose rows
// are all before the tile's (the causal diagonal) or past S only releases
// it.  P and dS are rounded to bf16 only as a product's operand; dP,
// Delta, LSE and the softmax stay fp32.  Rows past S take no weight;
// nothing is padded in device memory but the row data.
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
constexpr int THREADS = 128;          // the fp32 kernels' block
constexpr float LOG2E = 1.4426950408889634f;

// tensors by index in BwdArgs::st
enum { TQ, TK, TV, TDO, TDQ, TDK, TDV, NT };

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;       // (B*H, S), natural log
  // bf16: (B*H, ceil(S/64), 2, 64): each 64-row query tile's LSE in base 2
  // (+inf past S), then its Delta (0 past S), made by bwd_dq_ws; fp32:
  // Delta (B*H, S) in its first B*H*S floats, made by bwd_dq_f32
  float* delta;
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

// --- bf16: tensor cores, warp-specialised -----------------------------------

constexpr int BT = 64;                 // rows a tile (a warpgroup's, a step's)
constexpr int RT = 2 * BT;             // resident rows a work item
constexpr int TILE = BT * D * 2;       // one bf16 tile, 8 KB
constexpr int STAGES = 6;              // the streamed tiles' ring
constexpr int CONSUMERS = 256;         // two warpgroups
constexpr int WS_THREADS = CONSUMERS + 128;   // and the producer's
// registers a thread after the split (setmaxnreg): the block starts at
// 168 (65536 / 384, rounded down to 8); the producer warpgroup gives up
// all but 40, the consumers take 232: 168 x 384 = 40 x 128 + 232 x 256
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int ROWDATA = 2 * BT * 4;    // a query tile's LSE2 and Delta
// shared memory from a 1024-aligned base: two resident buffers, each
// [A0 rows 0-63 | A0 rows 64-127 | A1 rows 0-63 | A1 rows 64-127]; the
// ring's stages [B0 | B1]; each stage's row data (bwd_dkdv_ws); the
// mbarriers full[STAGES], empty[STAGES], rfull[2], rempty[2]
constexpr int RES_BYTES = 4 * TILE;
constexpr int OFF_RING = 2 * RES_BYTES;
constexpr int BAR_BYTES = 2 * (STAGES + 2) * 8;
// a stage: a 64-row tile of K, then of V (bwd_dq_ws), or of Q, then of
// dO (bwd_dkdv_ws: the stages' row data after the ring)
constexpr int STAGE_BYTES = 2 * TILE;
constexpr int OFF_BARS_DQ = OFF_RING + STAGES * STAGE_BYTES;
constexpr int SMEM_DQ = OFF_BARS_DQ + BAR_BYTES + 1024;
constexpr int OFF_ROWS = OFF_RING + STAGES * STAGE_BYTES;
constexpr int OFF_BARS = OFF_ROWS + STAGES * ROWDATA;
constexpr int SMEM_DKDV = OFF_BARS + BAR_BYTES + 1024;

// What both bf16 kernels take: q, k, v and dO as TMA maps over (64, S, H,
// B), or (64, H, S, B) where the head stride is the smaller (hfirst), so
// the dimensions' strides grow; boxes of 64 channels x 64 rows.
struct WsArgs {
  CUtensorMap map[4];   // by TQ, TK, TV, TDO
  BwdArgs a;
  int hfirst[4];
  int BH;
};

// rows row .. row + 63 of (batch b, head h) of tensor t into dst
__device__ __forceinline__ void tma_rows(const WsArgs& p, int t, uint32_t dst,
                                         uint32_t bar, int row, int h,
                                         int b) {
  const int c1 = p.hfirst[t] ? h : row, c2 = p.hfirst[t] ? row : h;
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&p.map[t])), "r"(bar), "r"(0),
      "r"(c1), "r"(c2), "r"(b)
      : "memory");
}

// `bytes` (a multiple of 16, 16-byte aligned) global -> shared, counted on
// the mbarrier `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

struct Bars {
  uint32_t base, full0, empty0, rfull0, rempty0;
  int sb;   // a stage's bytes
  __device__ Bars(uint32_t base_, int stage_bytes, int off_bars)
      : base(base_), full0(base_ + off_bars), empty0(full0 + 8 * STAGES),
        rfull0(empty0 + 8 * STAGES), rempty0(rfull0 + 16),
        sb(stage_bytes) {}
  // the stage of the ring's it-th use
  __device__ uint32_t stage(int it) const {
    return base + OFF_RING + (it % STAGES) * sb;
  }
  // every barrier initialised before any thread uses one
  __device__ void init() const {
    if (threadIdx.x == 0) {
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(full0 + 8 * s, 1);
        mbar_init(empty0 + 8 * s, 2);   // one arrival a consumer warpgroup
      }
      for (int r = 0; r < 2; ++r) {
        mbar_init(rfull0 + 8 * r, 1);
        mbar_init(rempty0 + 8 * r, 2);
      }
      fence_barrier_init();
    }
    __syncthreads();
  }
  // producer: the ring's it-th use of a stage, once both consumer
  // warpgroups released the use before it, `bytes` announced; its address
  __device__ uint32_t acquire(int it, int bytes) const {
    const int s = it % STAGES;
    mbar_wait(empty0 + 8 * s, ((it / STAGES) & 1) ^ 1);
    mbar_expect_tx(full0 + 8 * s, bytes);
    return stage(it);
  }
  // producer: work item n's resident buffer, once released
  __device__ uint32_t acquire_res(int n) const {
    const int r = n & 1;
    mbar_wait(rempty0 + 8 * r, ((n >> 1) & 1) ^ 1);
    mbar_expect_tx(rfull0 + 8 * r, RES_BYTES);
    return base + r * RES_BYTES;
  }
  // consumers: wait for the it-th use of a stage / item n's residents
  __device__ void wait(int it) const {
    mbar_wait(full0 + 8 * (it % STAGES), (it / STAGES) & 1);
  }
  __device__ void wait_res(int n) const {
    mbar_wait(rfull0 + 8 * (n & 1), (n >> 1) & 1);
  }
  // consumers: one thread a warpgroup releases, after its products read
  __device__ void release(int it) const {
    if ((threadIdx.x & 127) == 0) mbar_arrive(empty0 + 8 * (it % STAGES));
  }
  // (at the item's end: every warp's ldmatrix of the residents has fed a
  // product that completed, so no read of them is still in flight)
  __device__ void release_res(int n) const {
    if ((threadIdx.x & 127) == 0) mbar_arrive(rempty0 + 8 * (n & 1));
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x, flushed to 0 below 2^-126 (one MUFU instruction: such weights are
// below what any sum here keeps)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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

// a 64-row tile's descriptor (128-byte swizzle); its k16 slice kk is + 2 kk
// read K-major (32 bytes in), + 128 kk read MN-major (2048 bytes in)
__device__ __forceinline__ uint64_t desc(uint32_t tile) {
  return desc_sw128(tile, 16, 1024);
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

// keeps the compiler's reads and writes of a wgmma accumulator on their
// side of its issue and wait (registers only: the issue and the wait carry
// the memory clobbers)
template <int N>
__device__ __forceinline__ void acc_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]));
}

// acc_fence's for a register A operand
template <int N>
__device__ __forceinline__ void fence_a(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int kk = 0; kk < N; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[kk][i]));
}

// D (64 x 64, fp32) (+)= A (64 x 16, bf16, registers, wgmma_n64_rs_mn's
// layout) B (16 x 64, K-major in shared memory: wgmma_n64's B)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// this warpgroup's 64-row tile at `tile` (128-byte rows, 128-byte swizzle)
// as four k16 slices of a register A operand, by ldmatrix
__device__ __forceinline__ void load_a(uint32_t tile, uint32_t (&a)[4][4]) {
  const int t = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int r = 16 * w + ((t >> 3) & 1) * 8 + (t & 7);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = 2 * kk + (t >> 4);
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(a[kk][0]), "=r"(a[kk][1]), "=r"(a[kk][2]), "=r"(a[kk][3])
        : "r"(tile + r * 128 + ((c ^ (r & 7)) << 4)));
  }
}

// issue x = A B^T and y = C E^T (64 x 64 each; A, C from registers, B, E
// K-major tiles' descriptors)
__device__ __forceinline__ void issue_two_rs(float (&x)[32], float (&y)[32],
                                             const uint32_t (&a)[4][4],
                                             uint64_t b,
                                             const uint32_t (&c)[4][4],
                                             uint64_t e) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(x, a[kk], b + 2 * kk, kk);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(y, c[kk], e + 2 * kk, kk);
}

// issue acc += A B, A from registers, B an MN-major tile's descriptor
__device__ __forceinline__ void issue_rs(float (&x)[32],
                                         uint32_t (&xa)[4][4], uint64_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_n64_rs_mn<true>(x, xa[kk], b + 128 * kk);
}

// bit 2 j + e: whether key k + 8 j + e (j < 8, e < 2; k even) is valid
// under the (B, S) key mask row m (all set without one; keys past S are
// the caller's to drop)
__device__ __forceinline__ uint32_t key_bits(const uint8_t* m, int k, int S) {
  if (m == nullptr) return 0xFFFFu;
  uint32_t bits = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int key = k + 8 * j;
    if (key < S && m[key]) bits |= 1u << (2 * j);
    if (key + 1 < S && m[key + 1]) bits |= 2u << (2 * j);
  }
  return bits;
}

// the warpgroup's share of the register file after the split
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// bwd_dq_ws's work item w: the 128-query tile t (the last first) of
// (batch, head) bh; the key tiles it streams (twice): up to the diagonal of
// its second warpgroup
struct DqItem {
  int t, bh, nkb;
  __device__ DqItem(int w, int BH, int nq, int nt, int causal)
      : t(nq - 1 - w / BH), bh(w % BH),
        nkb(causal ? min(2 * t + 2, nt) : nt) {}
};

// One block an SM; each walks work items blockIdx.x, + gridDim.x, ...
// Step i < nkb of an item adds key tile i to its rows' Delta, step nkb + i
// key tile i to dQ; a warpgroup skips (only releases) the tiles past its
// diagonal (the last, for warpgroup 0).  In dQ's pass the step at key tile
// kt issues tile kt - 1's dQ product and tile kt's S and dP as one commit
// group.  Every issue is straight-line code in its loop (products issued
// on one path and waited for on another are serialised by ptxas).
__global__ void __launch_bounds__(WS_THREADS, 1)
    bwd_dq_ws(const __grid_constant__ WsArgs p) {
  const BwdArgs& a = p.a;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const Bars br(base, STAGE_BYTES, OFF_BARS_DQ);
  br.init();
  const int S = a.S, nt = (S + BT - 1) / BT, nq = (S + RT - 1) / RT;
  const int items = p.BH * nq, tid = threadIdx.x;

  if (tid >= CONSUMERS) {   // the producer: one thread issues every copy
    regs_dec<PRODUCER_REGS>();
    if (tid == CONSUMERS) {
      int it = 0, n = 0;
      for (int w = blockIdx.x; w < items; w += gridDim.x, ++n) {
        const DqItem m(w, p.BH, nq, nt, a.causal);
        const int b = m.bh / a.H, h = m.bh % a.H, r0 = m.t * RT;
        const uint32_t res = br.acquire_res(n);
        const uint32_t rbar = br.rfull0 + 8 * (n & 1);
        tma_rows(p, TQ, res, rbar, r0, h, b);
        tma_rows(p, TQ, res + TILE, rbar, r0 + BT, h, b);
        tma_rows(p, TDO, res + 2 * TILE, rbar, r0, h, b);
        tma_rows(p, TDO, res + 3 * TILE, rbar, r0 + BT, h, b);
        for (int i = 0; i < 2 * m.nkb; ++i, ++it) {
          const int kt = i < m.nkb ? i : i - m.nkb;
          const uint32_t st = br.acquire(it, STAGE_BYTES);
          const uint32_t bar = br.full0 + 8 * (it % STAGES);
          tma_rows(p, TK, st, bar, kt * BT, h, b);
          tma_rows(p, TV, st + TILE, bar, kt * BT, h, b);
        }
      }
    }
    return;
  }
  regs_inc<CONSUMER_REGS>();

  const int wg = tid >> 7, w = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3, lr = 16 * w + g;
  const float sl2 = a.scale * LOG2E;
  // this thread's rows q0 + lr and q0 + lr + 8 of work item wi: LSE in
  // base 2 (+inf past S: P = 0 there), loaded an item ahead
  auto lse2 = [&](int wi, float& l0, float& l1) {
    if (wi >= items) return;
    const DqItem m(wi, p.BH, nq, nt, a.causal);
    const int r0 = m.t * RT + wg * BT + lr;
    const float* lrow = a.lse + (long long)m.bh * S;
    l0 = r0 < S ? lrow[r0] * LOG2E : INFINITY;
    l1 = r0 + 8 < S ? lrow[r0 + 8] * LOG2E : INFINITY;
  };
  float nl0 = 0.f, nl1 = 0.f;
  lse2(blockIdx.x, nl0, nl1);
  int it = 0, n = 0;
  for (int wi = blockIdx.x; wi < items; wi += gridDim.x, ++n) {
    const DqItem m(wi, p.BH, nq, nt, a.causal);
    const int b = m.bh / a.H, h = m.bh % a.H;
    const int q0 = m.t * RT + wg * BT, qt = q0 / BT;
    // the key tiles this warpgroup takes: up to its diagonal, none where
    // every row is past S
    const int nkw = q0 >= S ? 0 : a.causal ? min(qt + 1, nt) : nt;
    const int r0 = q0 + lr, r1 = r0 + 8;
    const float l0 = nl0, l1 = nl1;
    lse2(wi + gridDim.x, nl0, nl1);
    const uint8_t* mrow = a.mask ? a.mask + (long long)b * S : nullptr;
    const uint32_t res = base + (n & 1) * RES_BYTES;
    auto stage = [&](int i) { return br.stage(i); };
    // S = Q K^T and dP = dO V^T of the tile in ring use i
    uint32_t qa[4][4], doa[4][4];   // Q's and dO's rows, as A operands
    auto sdp = [&](float (&s)[32], float (&dp)[32], int i) {
      issue_two_rs(s, dp, qa, desc(stage(i)), doa, desc(stage(i) + TILE));
    };
    // P = 2^(s scale log2 e - LSE2) in place: s[4j + 2hh + e] is query row
    // r0 + 8 hh, key k0 + 8 j + 2 t4 + e, with k0 = 64 kt.  A key counts
    // where its offset 8 j + e is at most the row's limit (the row itself
    // where causal, S - 1) less k0 + 2 t4, and its mask bit is set: no
    // branch a value, and none of it on a tile where every key counts
    auto probs = [&](float (&s)[32], int kt) {
      const int k0 = kt * BT, base_key = k0 + 2 * t4;
      if (!mrow && k0 + BT <= S && !(a.causal && kt == qt)) {
        // every key counts (rows past S have P = 0 by their LSE)
#pragma unroll
        for (int x = 0; x < 32; ++x)
          s[x] = exp2_ftz(fmaf(s[x], sl2, -((x & 2) ? l1 : l0)));
        return;
      }
      const int lim0 = (a.causal ? min(r0, S - 1) : S - 1) - base_key;
      const int lim1 = (a.causal ? min(r1, S - 1) : S - 1) - base_key;
      const uint32_t bits = key_bits(mrow, base_key, S);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * j + 2 * hh + e;
            const float pv = exp2_ftz(fmaf(s[x], sl2, -(hh ? l1 : l0)));
            const bool ok = 8 * j + e <= (hh ? lim1 : lim0) &&
                            ((bits >> (2 * j + e)) & 1u);
            s[x] = ok ? pv : 0.f;
          }
        }
      }
    };
    br.wait_res(n);
    load_a(res + wg * TILE, qa);
    load_a(res + (2 + wg) * TILE, doa);
    fence_a(qa);
    fence_a(doa);

    // Delta's pass: Delta += rowsum(P dP), two sums a row (the FMA
    // chains' latency halved), added in a fixed order
    float dl0 = 0.f, dl1 = 0.f, dm0 = 0.f, dm1 = 0.f;
    for (int kt = 0; kt < nkw; ++kt, ++it) {
      float s[32], dp[32];
      br.wait(it);
      wgmma_fence();
      sdp(s, dp, it);
      wgmma_commit();
      wgmma_wait<0>();
      acc_fence(s);
      acc_fence(dp);
      br.release(it);
      probs(s, kt);
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        dl0 = fmaf(s[4 * j], dp[4 * j], dl0);
        dl0 = fmaf(s[4 * j + 1], dp[4 * j + 1], dl0);
        dl1 = fmaf(s[4 * j + 2], dp[4 * j + 2], dl1);
        dl1 = fmaf(s[4 * j + 3], dp[4 * j + 3], dl1);
        dm0 = fmaf(s[4 * j + 4], dp[4 * j + 4], dm0);
        dm0 = fmaf(s[4 * j + 5], dp[4 * j + 5], dm0);
        dm1 = fmaf(s[4 * j + 6], dp[4 * j + 6], dm1);
        dm1 = fmaf(s[4 * j + 7], dp[4 * j + 7], dm1);
      }
    }
    for (int kt = nkw; kt < m.nkb; ++kt, ++it) {   // past the diagonal
      br.wait(it);
      br.release(it);
    }
    dl0 += dm0;
    dl1 += dm1;
    dl0 += __shfl_xor_sync(0xffffffffu, dl0, 1);
    dl0 += __shfl_xor_sync(0xffffffffu, dl0, 2);
    dl1 += __shfl_xor_sync(0xffffffffu, dl1, 1);
    dl1 += __shfl_xor_sync(0xffffffffu, dl1, 2);
    if (q0 < S && t4 == 0) {   // the tile's row data, for bwd_dkdv_ws
      float* rd = a.delta + ((long long)m.bh * nt + qt) * (2 * BT);
      rd[lr] = l0;
      rd[lr + 8] = l1;
      rd[BT + lr] = dl0;
      rd[BT + lr + 8] = dl1;
    }

    // dQ's pass: dS = P (dP - Delta), dQ += dS K (K as MN-major B: key
    // rows, channels contiguous); tile kt at ring use u + kt
    const int u = it;
    float dq[32];
    zero(dq);
    uint32_t da[4][4];   // dS of the tile whose dQ product is next
    auto ds = [&](float (&s)[32], const float (&dp)[32], int kt) {
      probs(s, kt);
#pragma unroll
      for (int x = 0; x < 32; ++x) s[x] *= dp[x] - ((x & 2) ? dl1 : dl0);
      to_a(s, da);
    };
    if (nkw > 0) {
      {
        float s[32], dp[32];
        br.wait(u);
        wgmma_fence();
        sdp(s, dp, u);
        wgmma_commit();
        wgmma_wait<0>();
        acc_fence(s);
        acc_fence(dp);
        ds(s, dp, 0);
      }
      for (int kt = 1; kt < nkw; ++kt) {
        float s[32], dp[32];
        br.wait(u + kt);
        acc_fence(dq);
        fence_a(da);
        wgmma_fence();
        issue_rs(dq, da, desc(br.stage(u + kt - 1)));
        sdp(s, dp, u + kt);
        wgmma_commit();
        wgmma_wait<0>();
        acc_fence(dq);
        acc_fence(s);
        acc_fence(dp);
        fence_a(da);
        br.release(u + kt - 1);
        ds(s, dp, kt);
      }
      acc_fence(dq);
      fence_a(da);
      wgmma_fence();
      issue_rs(dq, da, desc(br.stage(u + nkw - 1)));
      wgmma_commit();
      wgmma_wait<0>();
      acc_fence(dq);
      fence_a(da);
      br.release(u + nkw - 1);
    }
    for (it = u + nkw; it < u + m.nkb; ++it) {   // past the diagonal
      br.wait(it);
      br.release(it);
    }
    br.release_res(n);

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
}

// One block an SM; each walks work items blockIdx.x, + gridDim.x, ...: the
// 128-key tile t (the first first) of (batch, head) bh, the query tiles
// from the diagonal of its first warpgroup down, each with its row data; a
// warpgroup skips (only releases) the tiles before its diagonal (the
// first, for warpgroup 1).  The step at query tile j issues tile j - 1's
// dV and dK products and tile j's S^T and dP^T as one commit group.
__global__ void __launch_bounds__(WS_THREADS, 1)
    bwd_dkdv_ws(const __grid_constant__ WsArgs p) {
  const BwdArgs& a = p.a;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const float* rows0 =
      reinterpret_cast<const float*>(smem_raw + (base - raw) + OFF_ROWS);
  const Bars br(base, STAGE_BYTES, OFF_BARS);
  br.init();
  const int S = a.S, nt = (S + BT - 1) / BT, nq = (S + RT - 1) / RT;
  const int items = p.BH * nq, tid = threadIdx.x;

  if (tid >= CONSUMERS) {
    regs_dec<PRODUCER_REGS>();
    if (tid == CONSUMERS) {
      int it = 0, n = 0;
      for (int w = blockIdx.x; w < items; w += gridDim.x, ++n) {
        const int t = w / p.BH, bh = w % p.BH, b = bh / a.H, h = bh % a.H;
        const uint32_t res = br.acquire_res(n);
        const uint32_t rbar = br.rfull0 + 8 * (n & 1);
        tma_rows(p, TK, res, rbar, t * RT, h, b);
        tma_rows(p, TK, res + TILE, rbar, t * RT + BT, h, b);
        tma_rows(p, TV, res + 2 * TILE, rbar, t * RT, h, b);
        tma_rows(p, TV, res + 3 * TILE, rbar, t * RT + BT, h, b);
        for (int j = a.causal ? 2 * t : 0; j < nt; ++j, ++it) {
          const uint32_t st = br.acquire(it, STAGE_BYTES + ROWDATA);
          const uint32_t bar = br.full0 + 8 * (it % STAGES);
          tma_rows(p, TQ, st, bar, j * BT, h, b);
          tma_rows(p, TDO, st + TILE, bar, j * BT, h, b);
          bulk_load(base + OFF_ROWS + (it % STAGES) * ROWDATA,
                    a.delta + ((long long)bh * nt + j) * (2 * BT), ROWDATA,
                    bar);
        }
      }
    }
    return;
  }
  regs_inc<CONSUMER_REGS>();

  const int wg = tid >> 7, w = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const float sl2 = a.scale * LOG2E;
  int it = 0, n = 0;
  for (int wi = blockIdx.x; wi < items; wi += gridDim.x, ++n) {
    const int t = wi / p.BH, bh = wi % p.BH, b = bh / a.H, h = bh % a.H;
    const int k0 = t * RT + wg * BT, kt = k0 / BT;
    // the query tiles this warpgroup takes: from its diagonal, none where
    // every key is past S
    const int j0 = a.causal ? 2 * t : 0;
    const int jw = k0 >= S ? nt : a.causal ? kt : 0;
    // this thread's key rows kr and kr + 8: in range and valid
    const int kr = k0 + 16 * w + g;
    const uint8_t* mrow = a.mask ? a.mask + (long long)b * S : nullptr;
    const bool kin0 = kr < S && (!mrow || mrow[kr]);
    const bool kin1 = kr + 8 < S && (!mrow || mrow[kr + 8]);
    const uint32_t res = base + (n & 1) * RES_BYTES;
    auto stage = [&](int i) { return br.stage(i); };
    // S^T = K Q^T and dP^T = V dO^T of the tile in ring use i
    uint32_t ka[4][4], va[4][4];   // K's and V's rows, as A operands
    auto sdp = [&](float (&s)[32], float (&dp)[32], int i) {
      issue_two_rs(s, dp, ka, desc(stage(i)), va, desc(stage(i) + TILE));
    };
    float dk[32], dv[32];
    uint32_t pa[4][4], da[4][4];   // P^T and dS^T of the pending tile
    // dV += P^T dO, dK += dS^T Q of the tile in ring use i (dO and Q as
    // MN-major B: query rows, channels contiguous)
    auto dkdv = [&](uint32_t (&x)[4][4], uint32_t (&y)[4][4], int i) {
      issue_rs(dv, x, desc(stage(i) + TILE));
      issue_rs(dk, y, desc(stage(i)));
    };
    // P^T and dS^T of query tile j (ring use i) into po and dso: s[4 jj +
    // 2 hh + e] is key kr + 8 hh, query 64 j + 8 jj + 2 t4 + e.  A query
    // counts where its offset 8 jj + e is at least the key's (the key
    // itself where causal; past 64 where the key is past S or masked) less
    // 64 j + 2 t4: no branch a value, and none of it on a tile where every
    // query counts
    auto probs = [&](float (&s)[32], float (&dp)[32], int j, int i,
                     uint32_t (&po)[4][4], uint32_t (&dso)[4][4]) {
      const float* rd = rows0 + (i % STAGES) * (2 * BT);
      const int qb = j * BT + 2 * t4;
      if (!mrow && k0 + BT <= S && !(a.causal && j == kt)) {
        // every query counts (queries past S have P = 0 by their LSE)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float2 lse2 =
              *reinterpret_cast<const float2*>(rd + 8 * jj + 2 * t4);
          const float2 dl =
              *reinterpret_cast<const float2*>(rd + BT + 8 * jj + 2 * t4);
#pragma unroll
          for (int y = 4 * jj; y < 4 * jj + 4; ++y) {
            const float pv =
                exp2_ftz(fmaf(s[y], sl2, -((y & 1) ? lse2.y : lse2.x)));
            s[y] = pv;
            dp[y] = pv * (dp[y] - ((y & 1) ? dl.y : dl.x));
          }
        }
        to_a(s, po);
        to_a(dp, dso);
        return;
      }
      const int lo0 = kin0 ? (a.causal ? kr - qb : -BT) : 2 * BT;
      const int lo1 = kin1 ? (a.causal ? kr + 8 - qb : -BT) : 2 * BT;
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
            const int x = 4 * jj + 2 * hh + e;
            const float pv =
                exp2_ftz(fmaf(s[x], sl2, -(e ? lse2.y : lse2.x)));
            const float pr = 8 * jj + e >= (hh ? lo1 : lo0) ? pv : 0.f;
            s[x] = pr;
            dp[x] = pr * (dp[x] - (e ? dl.y : dl.x));
          }
        }
      }
      to_a(s, po);
      to_a(dp, dso);
    };
    br.wait_res(n);
    load_a(res + wg * TILE, ka);
    load_a(res + (2 + wg) * TILE, va);
    fence_a(ka);
    fence_a(va);

    zero(dk);
    zero(dv);
    const int jb = min(jw, nt);
    for (int j = j0; j < jb; ++j, ++it) {   // before the diagonal
      br.wait(it);
      br.release(it);
    }
    // tile j at ring use u + j - jb
    const int u = it;
    if (jb < nt) {
      {
        float s[32], dp[32];
        br.wait(u);
        wgmma_fence();
        sdp(s, dp, u);
        wgmma_commit();
        wgmma_wait<0>();
        acc_fence(s);
        acc_fence(dp);
        probs(s, dp, jb, u, pa, da);
      }
      for (int j = jb + 1; j < nt; ++j) {
        const int i = u + j - jb;
        float s[32], dp[32];
        br.wait(i);
        acc_fence(dk);
        acc_fence(dv);
        fence_a(pa);
        fence_a(da);
        wgmma_fence();
        dkdv(pa, da, i - 1);
        sdp(s, dp, i);
        wgmma_commit();
        wgmma_wait<0>();
        acc_fence(dk);
        acc_fence(dv);
        acc_fence(s);
        acc_fence(dp);
        fence_a(pa);
        fence_a(da);
        br.release(i - 1);
        probs(s, dp, j, i, pa, da);
      }
      const int last = u + nt - 1 - jb;
      acc_fence(dk);
      acc_fence(dv);
      fence_a(pa);
      fence_a(da);
      wgmma_fence();
      dkdv(pa, da, last);
      wgmma_commit();
      wgmma_wait<0>();
      acc_fence(dk);
      acc_fence(dv);
      fence_a(pa);
      fence_a(da);
      br.release(last);
      it = last + 1;
    }
    br.release_res(n);

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

// tensor t's TMA map: a bf16 (B, H, S, 64) view with (batch, head, row)
// strides st in elements, as four dimensions whose strides grow
int rows_map(WsArgs& p, int t, const void* base, int B, int H, int S,
             const long long (&st)[3]) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return ERR_NO_DRIVER;
  const bool hf = st[1] < st[2];
  p.hfirst[t] = hf;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(hf ? H : S),
                              static_cast<cuuint64_t>(hf ? S : H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {2ull * (hf ? st[1] : st[2]),
                                 2ull * (hf ? st[2] : st[1]), 2ull * st[0]};
  const cuuint32_t box[4] = {D, hf ? 1u : BT, hf ? BT : 1u, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  const CUresult r =
      fn(&p.map[t], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
         const_cast<void*>(base), dims, strides, box, estride,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, k, v, dout, dq, dk, dv: (B, H, S,
// 64) through (batch, head, row) strides in elements, head dim
// contiguous; bf16 rows on 16 bytes (base pointers and strides).  lse:
// (B, H, S) fp32, contiguous, the forward's natural log-sum-exp; delta: an
// fp32 scratch of B*H*ceil(S/64)*128 floats, 16-byte aligned (the row
// data the first launch writes for the second).  mask: (B, S) uint8 or
// null.  grid: bf16's persistent grid (kernels/flash_attention.bwd_plan),
// from 1 to B*H*ceil(S/128) blocks (the work items); fp32 ignores it.
// Two launches on `stream`.

extern "C" int tts_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, void* delta, const void* mask, void* dq, void* dk,
    void* dv, int B, int H, int S, int dtype, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, long long gsb,
    long long gsh, long long gss, long long dqsb,
    long long dqsh, long long dqss, long long dksb, long long dksh,
    long long dkss, long long dvsb, long long dvsh, long long dvss,
    int causal, float scale, int grid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const BwdArgs a{q, k, v, dout, static_cast<const float*>(lse),
                  static_cast<float*>(delta),
                  static_cast<const uint8_t*>(mask), dq, dk, dv, H, S,
                  causal, scale,
                  {{qsb, qsh, qss}, {ksb, ksh, kss}, {vsb, vsh, vss},
                   {gsb, gsh, gss}, {dqsb, dqsh, dqss}, {dksb, dksh, dkss},
                   {dvsb, dvsh, dvss}}};
  if (dtype == 1) {
    const int items = B * H * ((S + RT - 1) / RT);
    if (grid < 1 || grid > items)
      return static_cast<int>(cudaErrorInvalidValue);
    static const int attr = [] {
      const int rc = smem_attr(reinterpret_cast<const void*>(bwd_dq_ws),
                               SMEM_DQ);
      return rc ? rc
                : smem_attr(reinterpret_cast<const void*>(bwd_dkdv_ws),
                            SMEM_DKDV);
    }();
    if (attr) return attr;
    WsArgs p{};
    p.a = a;
    p.BH = B * H;
    const void* src[4] = {q, k, v, dout};
    for (int t = 0; t < 4; ++t)
      if (const int rc = rows_map(p, t, src[t], B, H, S, a.st[t])) return rc;
    bwd_dq_ws<<<grid, WS_THREADS, SMEM_DQ, st>>>(p);
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc) return rc;
    bwd_dkdv_ws<<<grid, WS_THREADS, SMEM_DKDV, st>>>(p);
  } else {
    const dim3 grid((S + FB - 1) / FB, B * H);
    bwd_dq_f32<<<grid, THREADS, 0, st>>>(a);
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc) return rc;
    bwd_dkdv_f32<<<grid, THREADS, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
