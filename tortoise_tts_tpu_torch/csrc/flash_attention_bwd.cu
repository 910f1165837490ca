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
// call (fp32: three, bwd_split_f32 first):
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
// a Delta consistent with P.  (fp32: below.)  What sets the time is keeping the tensor
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
// fp32 design (bwd_split_f32, bwd_dq_tf32, bwd_dkdv_tf32): the same
// split of the work on the tensor cores in 3xTF32.  Each fp32 operand x is
// split into hi = cvt.rna.tf32(x) (13 low bits cleared) and lo = x - hi
// (exact), and each product sums lo hi + hi lo + hi hi in fp32 (lo lo,
// about 2^-22 of a term, dropped): fp32 accuracy, where one TF32 product
// rounds every input to 11 significant bits.  Bound: 3x the operations at
// 495 TFLOP/s, 0.297 and 0.0377 ms at the two shapes (the nine products'
// own floor 0.535 and 0.068), over fp32 bytes 0.106 and 0.027.
// TF32 wgmma reads its shared-memory operands K-major only (no transpose
// bits), and dQ += dS K, dK += dS^T Q, dV += P^T dO reduce over the rows
// of the streamed tensor.  So a first launch, bwd_split_f32, writes every
// operand once as the products read it: q, k, v and dO split, rows as
// they come ((B*H, Sp, 64), Sp = S rounded up to 64, zeros past S), and
// k, q and dO split and transposed ((B*H, 64, Sp): channel rows), each 8
// rows reordered 0, 2, 4, 6, 1, 3, 5, 7 (an accumulator's n8 block holds
// columns 2 t4 and 2 t4 + 1 where a register A slice holds t4 and t4 + 4).
// Then the two kernels of the bf16 design's split, each a persistent grid
// of one block an SM over heaviest-first work items of 64 resident rows:
// a producer thread issues every copy by TMA (4-d maps over the split
// arrays, 128-byte swizzle) into a ring of 32-row stages and the one
// resident buffer (its next item's stages land first); two consumer
// warpgroups share the residents and take the ring's uses in turn, each
// running its tiles' products on wgmma while the other does its
// arithmetic, their sums met in a fixed order at the end.  Registers
// cannot hold the split residents (64 a tensor beside the accumulators),
// so S and dP (S^T and dP^T) read both operands from shared memory
// (m64n32k8, the residents as A); the dependent products take P, dS (P^T,
// dS^T), split, as register A operands against the transposed tiles
// (m64n64k8).  Each tile's
// dependent products go to fresh accumulators added to dQ (dK, dV) in
// fp32: the tensor cores' fp32 accumulation is not round-to-nearest, and
// a chain over every tile would drift.  exp2 is ex2.approx.f32 (no flush
// to zero); the limits are those of bf16, on the tiles that need them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int D = 64;
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
  // (+inf past S), then its Delta (0 past S), made by bwd_dq_ws; fp32: the
  // same of each 32-row tile, (B*H, 2 ceil(S/64), 2, 32), by bwd_dq_tf32
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

// --- fp32: 3xTF32 tensor cores ----------------------------------------------

constexpr int FR = 64;                 // resident rows a work item
constexpr int FT = 32;                 // rows a streamed tile
constexpr int F_BOX = FT * 32 * 4;     // a TMA box: 32 rows x 32 channels
constexpr int F_PART = FR * D * 4;     // a resident part (hi or lo), 16 KB
constexpr int F_RES = 4 * F_PART;      // [X_hi | X_lo | Y_hi | Y_lo]
constexpr int F_NAT = 2 * F_BOX;       // a streamed tile's part, 8 KB
constexpr int F_TR = D * FT * 4;       // a transposed tile's part, 8 KB
constexpr int F_THREADS = WS_THREADS;  // two consumer warpgroups, a producer
                                       // one (setmaxnreg, as bf16's)
constexpr int F_ROWDATA = 2 * FT * 4;  // a query tile's LSE2 and Delta
// bwd_dq_tf32's stage: [K_hi | K_lo | V_hi | V_lo | K^T_hi | K^T_lo]; after
// the ring, the two warpgroups' Delta partials.  The rings' stages are
// even in number: the warpgroups take the uses in turn, so a stage's
// consecutive uses are one warpgroup's, which never waits on a phase two
// ahead of the one it last released (an odd ring let one warpgroup pass
// a parity wait for a use whose stage the other had not yet freed)
constexpr int F_STAGES_DQ = 2;
constexpr int F_STAGE_DQ = 4 * F_NAT + 2 * F_TR;
constexpr int F_DELTA_DQ = F_RES + F_STAGES_DQ * F_STAGE_DQ;
constexpr int F_BARS_DQ = F_DELTA_DQ + 2 * 128 * 2 * 4;
constexpr int F_SMEM_DQ = F_BARS_DQ + 2 * (F_STAGES_DQ + 1) * 8 + 1024;
// bwd_dkdv_tf32's stage: [Q_hi | Q_lo | dO_hi | dO_lo | Q^T_hi | Q^T_lo |
// dO^T_hi | dO^T_lo], then each stage's row data after the ring
constexpr int F_STAGES_KV = 2;
constexpr int F_STAGE_KV = 4 * F_NAT + 4 * F_TR;
constexpr int F_ROWS_KV = F_RES + F_STAGES_KV * F_STAGE_KV;
constexpr int F_BARS_KV = F_ROWS_KV + F_STAGES_KV * F_ROWDATA;
constexpr int F_SMEM_KV = F_BARS_KV + 2 * (F_STAGES_KV + 1) * 8 + 1024;
// the split operands' arrays by index: natural (BH, Sp, 64) and
// transposed (BH, 64, Sp), Sp = S rounded up to 64
enum { NQH, NQL, NKH, NKL, NVH, NVL, NGH, NGL, NN };
enum { TKH, TKL, TQH, TQL, TGH, TGL, TN };

// What both fp32 kernels take: the split arrays as two TMA maps, 4-d
// (64, Sp, BH, NN) and (Sp, 64, BH, TN), boxes of 32 x 32 and 32 x 64.
struct F32Args {
  CUtensorMap nat, tr;
  BwdArgs a;
  int BH;
};

// a box of `map` at (c0, c1, c2, c3), innermost first, into `dst`
__device__ __forceinline__ void tma_4d(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int c0, int c1, int c2,
                                       int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// rows row0 .. row0 + n - 1 (n 32 or 64) of natural array `arr` of (batch,
// head) bh, both 32-channel halves: [ch 0-31 | ch 32-63], each n rows of
// 128 bytes
__device__ __forceinline__ void tma_nat(const F32Args& p, uint32_t dst,
                                        uint32_t bar, int arr, int row0,
                                        int n, int bh) {
  for (int c = 0; c < 2; ++c)
    for (int r = 0; r < n; r += FT)
      tma_4d(dst + c * n * 128 + r * 128, &p.nat, bar, 32 * c, row0 + r, bh,
             arr);
}

// D (64 x 32, fp32) += A (64 x 8) B (8 x 32), tf32, both K-major in
// shared memory (as wgmma_tf32_rs's B); D's layout is wgmma_n64's, four n8
// blocks
__device__ __forceinline__ void wgmma_tf32_ss32(float (&d)[16], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// 2^x (MUFU, no flush: weights under 2^-126 stay)
__device__ __forceinline__ float exp2_f32(float x) {
  float y;
  asm("ex2.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// issue x (64 x 32) += A B^T over 64 channels, A the resident part pair at
// `a` (64 rows: [ch 0-31 | ch 32-63] of 8 KB each, hi then lo 16 KB on),
// B the streamed pair at `b` (32 rows, 4 KB halves, lo 8 KB on): per
// 8-channel slice lo hi + hi lo + hi hi
__device__ __forceinline__ void issue_ss(float (&x)[16], uint32_t a,
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint32_t ao = a + (kk / 4) * 8192 + 32 * (kk % 4);
    const uint32_t bo = b + (kk / 4) * 4096 + 32 * (kk % 4);
    const uint64_t ah = desc(ao), al = desc(ao + F_PART);
    const uint64_t bh = desc(bo), bl = desc(bo + F_NAT);
    wgmma_tf32_ss32(x, al, bh);
    wgmma_tf32_ss32(x, ah, bl);
    wgmma_tf32_ss32(x, ah, bh);
  }
}

// issue x (64 x 64) += A B over 32 rows: A the split accumulator slices
// (hi, lo) in registers, B a transposed pair at `b` (64 channel rows of 32
// reordered rows, lo 8 KB on)
__device__ __forceinline__ void issue_rs(float (&x)[32],
                                         const uint32_t (&hi)[4][4],
                                         const uint32_t (&lo)[4][4],
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t bh = desc(b + 32 * kk), bl = desc(b + F_TR + 32 * kk);
    wgmma_tf32_rs<64>(x, lo[kk], bh);
    wgmma_tf32_rs<64>(x, hi[kk], bl);
    wgmma_tf32_rs<64>(x, hi[kk], bh);
  }
}

// an accumulator's n8 block kk, split, as the k8 slice kk of a register A
// operand: its columns 2 t4 and 2 t4 + 1 are the slice's t4 and t4 + 4 (the
// transposed arrays hold each 8 rows in the order 0, 2, 4, 6, 1, 3, 5, 7)
__device__ __forceinline__ void to_a_tf32(const float (&x)[16],
                                          uint32_t (&hi)[4][4],
                                          uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    tf32_split(x[4 * kk], hi[kk][0], lo[kk][0]);
    tf32_split(x[4 * kk + 2], hi[kk][1], lo[kk][1]);
    tf32_split(x[4 * kk + 1], hi[kk][2], lo[kk][2]);
    tf32_split(x[4 * kk + 3], hi[kk][3], lo[kk][3]);
  }
}

// a barrier of the two consumer warpgroups alone (the producer is busy
// or gone)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void fence_u(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int kk = 0; kk < N; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[kk][i]));
}

// The ring of NS stages and the one resident buffer of an fp32 kernel:
// full and empty mbarriers a stage (each ring use is one consumer
// warpgroup's), rfull and rempty (both warpgroups) for the residents.
template <int NS>
struct FBars {
  static_assert(NS % 2 == 0, "each stage one warpgroup's");
  uint32_t base, full0, empty0, rfull, rempty;
  int sb;
  __device__ FBars(uint32_t base_, int stage_bytes, int off_bars)
      : base(base_), full0(base_ + off_bars), empty0(full0 + 8 * NS),
        rfull(empty0 + 8 * NS), rempty(rfull + 8), sb(stage_bytes) {}
  __device__ uint32_t stage(int it) const {
    return base + F_RES + (it % NS) * sb;
  }
  __device__ void init() const {
    if (threadIdx.x == 0) {
      for (int s = 0; s < NS; ++s) {
        mbar_init(full0 + 8 * s, 1);
        mbar_init(empty0 + 8 * s, 1);
      }
      mbar_init(rfull, 1);
      mbar_init(rempty, 2);
      fence_barrier_init();
    }
    __syncthreads();
  }
  __device__ uint32_t acquire(int it, int bytes) const {
    const int s = it % NS;
    mbar_wait(empty0 + 8 * s, ((it / NS) & 1) ^ 1);
    mbar_expect_tx(full0 + 8 * s, bytes);
    return stage(it);
  }
  __device__ uint32_t full(int it) const { return full0 + 8 * (it % NS); }
  __device__ void acquire_res(int n) const {
    mbar_wait(rempty, (n & 1) ^ 1);
    mbar_expect_tx(rfull, F_RES);
  }
  __device__ void wait(int it) const {
    mbar_wait(full0 + 8 * (it % NS), (it / NS) & 1);
  }
  __device__ void wait_res(int n) const { mbar_wait(rfull, n & 1); }
  // a warpgroup's first thread, once every product that read the stage
  // (or, at the item's end, the residents) is done: the products are the
  // warpgroup's own, so its every thread has issued them and read what it
  // reads by hand
  __device__ void release(int it) const {
    if ((threadIdx.x & 127) == 0) mbar_arrive(empty0 + 8 * (it % NS));
  }
  __device__ void release_res() const {
    if ((threadIdx.x & 127) == 0) mbar_arrive(rempty);
  }
};

// The split operands from q, k, v and dO: natural hi and lo of each (rows
// past S zero) and transposed hi and lo of k, q and dO.  Block (x, y): 32
// rows of (batch, head) y; every element read once, in 16-byte pieces
// where a tensor's rows are on 16 bytes (else element by element), and
// written in 16-byte pieces.
__global__ void __launch_bounds__(256)
    bwd_split_f32(const BwdArgs a, float* __restrict__ nat,
                  float* __restrict__ tr, int BH, int Sp) {
  __shared__ float tile[D][FT + 1];
  const int r0 = blockIdx.x * FT, bh = blockIdx.y, b = bh / a.H,
            h = bh % a.H, tid = threadIdx.x;
  const long long plane = (long long)Sp * D;
#pragma unroll
  for (int xi = 0; xi < 4; ++xi) {   // TQ, TK, TV, TDO
    const void* src = xi == 0 ? a.q : xi == 1 ? a.k : xi == 2 ? a.v : a.dout;
    const int trof = xi == 0 ? TQH : xi == 1 ? TKH : xi == 3 ? TGH : -1;
    const float* x = rows_of<float>(src, a, xi, b, h);
    const long long rs = a.st[xi][2];
    const bool vec =
        (rs & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
    float* nh = nat + ((long long)(2 * xi) * BH + bh) * plane;
    float* nl = nh + (long long)BH * plane;
    if (trof >= 0) __syncthreads();   // the tile's last reads are done
#pragma unroll
    for (int u = 0; u < FT * D / 4 / 256; ++u) {
      const int i = tid + 256 * u, r = i / (D / 4), c = (i % (D / 4)) * 4;
      const int row = r0 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < a.S) {
        const float* e = x + row * rs + c;
        v = vec ? *reinterpret_cast<const float4*>(e)
                : make_float4(e[0], e[1], e[2], e[3]);
      }
      uint4 hi, lo;
      tf32_split4(v, hi, lo);
      *reinterpret_cast<uint4*>(nh + (long long)row * D + c) = hi;
      *reinterpret_cast<uint4*>(nl + (long long)row * D + c) = lo;
      if (trof >= 0) {
        tile[c][r] = v.x;
        tile[c + 1][r] = v.y;
        tile[c + 2][r] = v.z;
        tile[c + 3][r] = v.w;
      }
    }
    if (trof < 0) continue;
    __syncthreads();
    float* th = tr + ((long long)trof * BH + bh) * plane;
    float* tl = th + (long long)BH * plane;
#pragma unroll
    for (int u = 0; u < D * FT / 4 / 256; ++u) {
      // positions p .. p + 3 of a channel row; position q of each 8 holds
      // row 2 q (q < 4) or 2 (q - 4) + 1
      const int i = tid + 256 * u, c = i / (FT / 4), p = (i % (FT / 4)) * 4;
      float e[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int q = (p + k) & 7;
        e[k] = tile[c][(p & ~7) + (q < 4 ? 2 * q : 2 * (q - 4) + 1)];
      }
      uint4 hi, lo;
      tf32_split4(make_float4(e[0], e[1], e[2], e[3]), hi, lo);
      *reinterpret_cast<uint4*>(th + (long long)c * Sp + r0 + p) = hi;
      *reinterpret_cast<uint4*>(tl + (long long)c * Sp + r0 + p) = lo;
    }
  }
}

// bwd_dq_tf32's work item w: the 64-query tile t of (batch, head) bh, (batch,
// head)-major and the last tile first within one, so the blocks that run
// together stream the split K and V of a few (batch, head)s from L2 (in
// bf16's order they streamed 132 of them, 169 MB at (16, 16, 773), from
// device memory: 1.36 and 1.10 ms for the two kernels against 0.78 and
// 0.72 on an H100); the 32-key tiles it streams (twice): up to its
// diagonal
struct DqItemF {
  int t, bh, nkb;
  __device__ DqItemF(int w, int nq, int nt, int causal)
      : t(nq - 1 - w % nq), bh(w / nq),
        nkb(causal ? min(2 * t + 2, nt) : nt) {}
};

// bit 2 j + e: whether key k + 8 j + e (j < 4, e < 2) is valid under the
// key mask row m (all set without one)
__device__ __forceinline__ uint32_t key_bits32(const uint8_t* m, int k,
                                               int S) {
  if (m == nullptr) return 0xFFu;
  uint32_t bits = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int key = k + 8 * j;
    if (key < S && m[key]) bits |= 1u << (2 * j);
    if (key + 1 < S && m[key + 1]) bits |= 2u << (2 * j);
  }
  return bits;
}

// One block an SM (162 KB of shared memory); each walks work items
// blockIdx.x, + gridDim.x, ...  Step i < nkb of an item adds key tile i
// to its rows' Delta, step nkb + i key tile i to dQ, each tile's dS K in
// a fresh accumulator added to dQ in fp32.  S and dP read both operands
// from shared memory (the residents as A), dQ's A is dS in registers.
// The two consumer warpgroups share the residents and take the ring's
// uses in turn (warpgroup u % 2 the u-th), so one's arithmetic runs beside
// the other's products; each sums its tiles apart, and the two sums meet
// in a fixed order (Delta's through shared memory before dQ's pass, dQ's
// through the resident buffer at the item's end: warpgroup 0's plus
// warpgroup 1's).
__global__ void __launch_bounds__(F_THREADS, 1)
    bwd_dq_tf32(const __grid_constant__ F32Args p) {
  const BwdArgs& a = p.a;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  float* const res = reinterpret_cast<float*>(smem_raw + (base - raw));
  float* const parts = res + F_DELTA_DQ / 4;
  const FBars<F_STAGES_DQ> br(base, F_STAGE_DQ, F_BARS_DQ);
  br.init();
  const int S = a.S, nt = (S + FT - 1) / FT, nq = (S + FR - 1) / FR;
  const int items = p.BH * nq, tid = threadIdx.x;

  if (tid >= CONSUMERS) {   // the producer: one thread issues every copy
    regs_dec<PRODUCER_REGS>();
    if (tid == CONSUMERS) {
      int it = 0, n = 0;
      for (int w = blockIdx.x; w < items; w += gridDim.x, ++n) {
        const DqItemF m(w, nq, nt, a.causal);
        const int steps = 2 * m.nkb, pre = min(F_STAGES_DQ - 1, steps);
        for (int i = 0; i <= steps; ++i) {
          if (i == pre) {   // the residents, once the last item's are free
            br.acquire_res(n);
            tma_nat(p, base, br.rfull, NQH, m.t * FR, FR, m.bh);
            tma_nat(p, base + F_PART, br.rfull, NQL, m.t * FR, FR, m.bh);
            tma_nat(p, base + 2 * F_PART, br.rfull, NGH, m.t * FR, FR, m.bh);
            tma_nat(p, base + 3 * F_PART, br.rfull, NGL, m.t * FR, FR, m.bh);
            continue;
          }
          const int s = i < pre ? i : i - 1;
          const bool dq_pass = s >= m.nkb;
          const int kt = dq_pass ? s - m.nkb : s;
          const uint32_t st =
              br.acquire(it, dq_pass ? F_STAGE_DQ : 4 * F_NAT);
          const uint32_t bar = br.full(it);
          ++it;
          tma_nat(p, st, bar, NKH, kt * FT, FT, m.bh);
          tma_nat(p, st + F_NAT, bar, NKL, kt * FT, FT, m.bh);
          tma_nat(p, st + 2 * F_NAT, bar, NVH, kt * FT, FT, m.bh);
          tma_nat(p, st + 3 * F_NAT, bar, NVL, kt * FT, FT, m.bh);
          if (dq_pass) {
            tma_4d(st + 4 * F_NAT, &p.tr, bar, kt * FT, 0, m.bh, TKH);
            tma_4d(st + 4 * F_NAT + F_TR, &p.tr, bar, kt * FT, 0, m.bh, TKL);
          }
        }
      }
    }
    return;
  }

  regs_inc<CONSUMER_REGS>();
  // warp-uniform to the compiler (a shuffle): a branch on it is not
  // divergent, so ptxas keeps the products unserialised
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0), ct = tid & 127;
  const int w = ct >> 5, lane = ct & 31, g = lane >> 2, t4 = lane & 3;
  const float sl2 = a.scale * LOG2E;
  int it = 0, n = 0;
  for (int wi = blockIdx.x; wi < items; wi += gridDim.x, ++n) {
    const DqItemF m(wi, nq, nt, a.causal);
    const int b = m.bh / a.H, h = m.bh % a.H, q0 = m.t * FR;
    const int r0 = q0 + 16 * w + g, r1 = r0 + 8;
    const float* lrow = a.lse + (long long)m.bh * S;
    // LSE in base 2, +inf past S (P = 0 there)
    const float l0 = r0 < S ? lrow[r0] * LOG2E : INFINITY;
    const float l1 = r1 < S ? lrow[r1] * LOG2E : INFINITY;
    const uint8_t* mrow = a.mask ? a.mask + (long long)b * S : nullptr;
    // S = Q K^T and dP = dO V^T of the tile in ring use i
    auto sdp = [&](float (&s)[16], float (&dp)[16], int i) {
      const uint32_t st = br.stage(i);
      zero(s);
      zero(dp);
      acc_fence(s);
      acc_fence(dp);
      wgmma_fence();
      issue_ss(s, base, st);
      issue_ss(dp, base + 2 * F_PART, st + 2 * F_NAT);
      wgmma_commit();
      wgmma_wait<0>();
      acc_fence(s);
      acc_fence(dp);
    };
    // P = 2^(s scale log2 e - LSE2) in place: s[4j + 2hh + e] is query row
    // r0 + 8 hh, key k0 + 8 j + 2 t4 + e.  A key counts where its offset
    // 8 j + e is at most the row's limit (the row itself where causal,
    // S - 1) less k0 + 2 t4, and its mask bit is set: no branch a value,
    // and none of it on a tile where every key counts
    auto probs = [&](float (&s)[16], int kt) {
      const int k0 = kt * FT, base_key = k0 + 2 * t4;
      if (!mrow && k0 + FT <= S && !(a.causal && k0 + FT - 1 > q0)) {
#pragma unroll
        for (int x = 0; x < 16; ++x)
          s[x] = exp2_f32(fmaf(s[x], sl2, -((x & 2) ? l1 : l0)));
        return;
      }
      const int lim0 = (a.causal ? min(r0, S - 1) : S - 1) - base_key;
      const int lim1 = (a.causal ? min(r1, S - 1) : S - 1) - base_key;
      const uint32_t bits = key_bits32(mrow, base_key, S);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * j + 2 * hh + e;
            const float pv = exp2_f32(fmaf(s[x], sl2, -(hh ? l1 : l0)));
            const bool ok = 8 * j + e <= (hh ? lim1 : lim0) &&
                            ((bits >> (2 * j + e)) & 1u);
            s[x] = ok ? pv : 0.f;
          }
    };
    br.wait_res(n);

    // Delta's pass: Delta += rowsum(P dP), in a fixed order, over this
    // warpgroup's tiles
    float dl0 = 0.f, dl1 = 0.f;
    for (int kt = 0; kt < m.nkb; ++kt, ++it) {
      if ((it & 1) != wg) continue;
      float s[16], dp[16];
      br.wait(it);
      sdp(s, dp, it);
      br.release(it);
      probs(s, kt);
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        if (x & 2)
          dl1 = fmaf(s[x], dp[x], dl1);
        else
          dl0 = fmaf(s[x], dp[x], dl0);
      }
    }
    dl0 += __shfl_xor_sync(0xffffffffu, dl0, 1);
    dl0 += __shfl_xor_sync(0xffffffffu, dl0, 2);
    dl1 += __shfl_xor_sync(0xffffffffu, dl1, 1);
    dl1 += __shfl_xor_sync(0xffffffffu, dl1, 2);
    parts[2 * (128 * wg + ct)] = dl0;
    parts[2 * (128 * wg + ct) + 1] = dl1;
    consumers_sync();
    dl0 = parts[2 * ct] + parts[2 * (128 + ct)];
    dl1 = parts[2 * ct + 1] + parts[2 * (128 + ct) + 1];
    if (wg == 0 && t4 == 0) {   // the rows' data, for bwd_dkdv_tf32: a
                                // 32-row tile's LSE2, then its Delta
      const int nt2 = 2 * nq;
      float* rd0 = a.delta + ((long long)m.bh * nt2 + r0 / FT) * (2 * FT);
      float* rd1 = a.delta + ((long long)m.bh * nt2 + r1 / FT) * (2 * FT);
      rd0[r0 % FT] = l0;
      rd0[FT + r0 % FT] = dl0;
      rd1[r1 % FT] = l1;
      rd1[FT + r1 % FT] = dl1;
    }

    // dQ's pass: dS = P (dP - Delta), then dQ += dS K (K^T's rows as B)
    float dq[32];
    zero(dq);
    for (int kt = 0; kt < m.nkb; ++kt, ++it) {
      if ((it & 1) != wg) continue;
      float s[16], dp[16];
      br.wait(it);
      sdp(s, dp, it);
      probs(s, kt);
#pragma unroll
      for (int x = 0; x < 16; ++x) s[x] *= dp[x] - ((x & 2) ? dl1 : dl0);
      uint32_t dh[4][4], dlo[4][4];
      to_a_tf32(s, dh, dlo);
      float part[32];
      zero(part);
      acc_fence(part);
      fence_u(dh);
      fence_u(dlo);
      wgmma_fence();
      issue_rs(part, dh, dlo, br.stage(it) + 4 * F_NAT);
      wgmma_commit();
      wgmma_wait<0>();
      acc_fence(part);
      fence_u(dh);
      fence_u(dlo);
      br.release(it);
#pragma unroll
      for (int x = 0; x < 32; ++x) dq[x] += part[x];
    }
    // warpgroup 1's dQ to warpgroup 0 over the residents, once every
    // product of the item is done
    consumers_sync();
    if (wg == 1) {
#pragma unroll
      for (int x = 0; x < 32; ++x) res[128 * x + ct] = dq[x];
    }
    consumers_sync();
    if (wg == 0) {
#pragma unroll
      for (int x = 0; x < 32; ++x) dq[x] += res[128 * x + ct];
    }
    fence_proxy_async();   // the residents' next copy comes after
    br.release_res();
    if (wg == 1) continue;

    float* out = rows_of<float>(a.dq, a, TDQ, b, h);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = hh ? r1 : r0;
      if (row >= S) continue;
      float* orow = out + row * a.st[TDQ][2] + 2 * t4;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float2*>(orow + 8 * j) =
            make_float2(dq[4 * j + 2 * hh] * a.scale,
                        dq[4 * j + 2 * hh + 1] * a.scale);
    }
  }
}

// One block an SM (194 KB); each walks work items blockIdx.x, + gridDim.x,
// ...: the 64-key tile t of (batch, head) bh, (batch, head)-major and the
// first tile first within one (DqItemF's reason), the
// 32-query tiles from its diagonal down, each with its row data.  S^T and
// dP^T read both operands from shared memory (K and V resident as A);
// dV += P^T dO and dK += dS^T Q take P^T and dS^T from registers, each
// tile's in fresh accumulators added in fp32.  The two consumer
// warpgroups take the ring's uses in turn, as in bwd_dq_tf32, and their
// dK and dV meet at the item's end over the resident buffer.
__global__ void __launch_bounds__(F_THREADS, 1)
    bwd_dkdv_tf32(const __grid_constant__ F32Args p) {
  const BwdArgs& a = p.a;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const float* rows0 =
      reinterpret_cast<const float*>(smem_raw + (base - raw) + F_ROWS_KV);
  float* const res = reinterpret_cast<float*>(smem_raw + (base - raw));
  const FBars<F_STAGES_KV> br(base, F_STAGE_KV, F_BARS_KV);
  br.init();
  const int S = a.S, nt = (S + FT - 1) / FT, nq = (S + FR - 1) / FR;
  const int items = p.BH * nq, tid = threadIdx.x;

  if (tid >= CONSUMERS) {
    regs_dec<PRODUCER_REGS>();
    if (tid == CONSUMERS) {
      int it = 0, n = 0;
      for (int w = blockIdx.x; w < items; w += gridDim.x, ++n) {
        const int t = w % nq, bh = w / nq;   // as DqItemF's order
        const int j0 = a.causal ? 2 * t : 0, steps = nt - j0;
        const int pre = min(F_STAGES_KV - 1, steps);
        for (int i = 0; i <= steps; ++i) {
          if (i == pre) {
            br.acquire_res(n);
            tma_nat(p, base, br.rfull, NKH, t * FR, FR, bh);
            tma_nat(p, base + F_PART, br.rfull, NKL, t * FR, FR, bh);
            tma_nat(p, base + 2 * F_PART, br.rfull, NVH, t * FR, FR, bh);
            tma_nat(p, base + 3 * F_PART, br.rfull, NVL, t * FR, FR, bh);
            continue;
          }
          const int j = j0 + (i < pre ? i : i - 1);
          const uint32_t st = br.acquire(it, F_STAGE_KV + F_ROWDATA);
          const uint32_t bar = br.full(it);
          tma_nat(p, st, bar, NQH, j * FT, FT, bh);
          tma_nat(p, st + F_NAT, bar, NQL, j * FT, FT, bh);
          tma_nat(p, st + 2 * F_NAT, bar, NGH, j * FT, FT, bh);
          tma_nat(p, st + 3 * F_NAT, bar, NGL, j * FT, FT, bh);
          const uint32_t t0 = st + 4 * F_NAT;
          tma_4d(t0, &p.tr, bar, j * FT, 0, bh, TQH);
          tma_4d(t0 + F_TR, &p.tr, bar, j * FT, 0, bh, TQL);
          tma_4d(t0 + 2 * F_TR, &p.tr, bar, j * FT, 0, bh, TGH);
          tma_4d(t0 + 3 * F_TR, &p.tr, bar, j * FT, 0, bh, TGL);
          bulk_load(base + F_ROWS_KV + (it % F_STAGES_KV) * F_ROWDATA,
                    a.delta + ((long long)bh * 2 * nq + j) * (2 * FT),
                    F_ROWDATA, bar);
          ++it;
        }
      }
    }
    return;
  }

  regs_inc<CONSUMER_REGS>();
  // warp-uniform to the compiler (a shuffle): a branch on it is not
  // divergent, so ptxas keeps the products unserialised
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0), ct = tid & 127;
  const int w = ct >> 5, lane = ct & 31, g = lane >> 2, t4 = lane & 3;
  const float sl2 = a.scale * LOG2E;
  int it = 0, n = 0;
  for (int wi = blockIdx.x; wi < items; wi += gridDim.x, ++n) {
    const int t = wi % nq, bh = wi / nq, b = bh / a.H, h = bh % a.H;
    const int k0 = t * FR, j0 = a.causal ? 2 * t : 0;
    // this thread's key rows kr and kr + 8: in range and valid
    const int kr = k0 + 16 * w + g;
    const uint8_t* mrow = a.mask ? a.mask + (long long)b * S : nullptr;
    const bool kin0 = kr < S && (!mrow || mrow[kr]);
    const bool kin1 = kr + 8 < S && (!mrow || mrow[kr + 8]);
    const bool edge = mrow || k0 + FR > S;
    br.wait_res(n);
    float dk[32], dv[32];
    zero(dk);
    zero(dv);
    for (int j = j0; j < nt; ++j, ++it) {
      if ((it & 1) != wg) continue;
      const uint32_t st = br.stage(it);
      float s[16], dp[16];
      br.wait(it);
      zero(s);
      zero(dp);
      acc_fence(s);
      acc_fence(dp);
      wgmma_fence();
      issue_ss(s, base, st);                            // S^T = K Q^T
      issue_ss(dp, base + 2 * F_PART, st + 2 * F_NAT);  // dP^T = V dO^T
      wgmma_commit();
      wgmma_wait<0>();
      acc_fence(s);
      acc_fence(dp);
      // P^T and dS^T: s[4 jj + 2 hh + e] is key kr + 8 hh, query 32 j +
      // 8 jj + 2 t4 + e.  A query counts where its offset 8 jj + e is at
      // least the key's (the key itself where causal; past 32 where the
      // key is past S or masked) less 32 j + 2 t4: no branch a value, and
      // none of it on a tile where every query counts
      const float* rd = rows0 + (it % F_STAGES_KV) * (2 * FT);
      const int qb = j * FT + 2 * t4;
      const bool lim = edge || (a.causal && j * FT < k0 + FR - 1);
      const int lo0 = kin0 ? (a.causal ? kr - qb : -FT) : 2 * FT;
      const int lo1 = kin1 ? (a.causal ? kr + 8 - qb : -FT) : 2 * FT;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float2 lse2 =
            *reinterpret_cast<const float2*>(rd + 8 * jj + 2 * t4);
        const float2 dl =
            *reinterpret_cast<const float2*>(rd + FT + 8 * jj + 2 * t4);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * jj + 2 * hh + e;
            float pv = exp2_f32(fmaf(s[x], sl2, -(e ? lse2.y : lse2.x)));
            if (lim) pv = 8 * jj + e >= (hh ? lo1 : lo0) ? pv : 0.f;
            s[x] = pv;
            dp[x] = pv * (dp[x] - (e ? dl.y : dl.x));
          }
      }
      uint32_t ph[4][4], pl[4][4], dh[4][4], dlo[4][4];
      to_a_tf32(s, ph, pl);
      to_a_tf32(dp, dh, dlo);
      float pv_[32], pk_[32];
      zero(pv_);
      zero(pk_);
      acc_fence(pv_);
      acc_fence(pk_);
      fence_u(ph);
      fence_u(pl);
      fence_u(dh);
      fence_u(dlo);
      wgmma_fence();
      issue_rs(pv_, ph, pl, st + 4 * F_NAT + 2 * F_TR);   // P^T dO
      issue_rs(pk_, dh, dlo, st + 4 * F_NAT);             // dS^T Q
      wgmma_commit();
      wgmma_wait<0>();
      acc_fence(pv_);
      acc_fence(pk_);
      fence_u(ph);
      fence_u(pl);
      fence_u(dh);
      fence_u(dlo);
      br.release(it);
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        dv[x] += pv_[x];
        dk[x] += pk_[x];
      }
    }
    // warpgroup 1's dK and dV to warpgroup 0 over the residents, once
    // every product of the item is done
    consumers_sync();
    if (wg == 1) {
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        res[128 * x + ct] = dk[x];
        res[128 * (32 + x) + ct] = dv[x];
      }
    }
    consumers_sync();
    if (wg == 0) {
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        dk[x] += res[128 * x + ct];
        dv[x] += res[128 * (32 + x) + ct];
      }
    }
    fence_proxy_async();   // the residents' next copy comes after
    br.release_res();
    if (wg == 1) continue;

    float* dkb = rows_of<float>(a.dk, a, TDK, b, h);
    float* dvb = rows_of<float>(a.dv, a, TDV, b, h);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = kr + 8 * hh;
      if (row >= S) continue;
      float* krow = dkb + row * a.st[TDK][2] + 2 * t4;
      float* vrow = dvb + row * a.st[TDV][2] + 2 * t4;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<float2*>(krow + 8 * j) =
            make_float2(dk[4 * j + 2 * hh] * a.scale,
                        dk[4 * j + 2 * hh + 1] * a.scale);
        *reinterpret_cast<float2*>(vrow + 8 * j) =
            make_float2(dv[4 * j + 2 * hh], dv[4 * j + 2 * hh + 1]);
      }
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
  if (fn == nullptr) return ERR_NO_ENCODER;
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
  return map_result(r);
}

// an fp32 4-d TMA map over `base` with the 128-byte swizzle: dims
// innermost first, strides in bytes of dims 1-3, a box of (box0, box1, 1,
// 1) elements (box0: 32, one 128-byte row)
int split_map(CUtensorMap* map, const float* base,
              const cuuint64_t (&dims)[4], const cuuint64_t (&strides)[3],
              cuuint32_t box0, cuuint32_t box1) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return ERR_NO_ENCODER;
  const cuuint32_t box[4] = {box0, box1, 1, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(base),
         dims, strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return map_result(r);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, k, v, dout, dq, dk, dv: (B, H, S,
// 64) through (batch, head, row) strides in elements, head dim
// contiguous; bf16 rows on 16 bytes (base pointers and strides).  lse:
// (B, H, S) fp32, contiguous, the forward's natural log-sum-exp; delta: an
// fp32 scratch of B*H*ceil(S/64)*128 floats, 16-byte aligned (the row
// data the first launch writes for the second).  split (fp32 only): an
// fp32 scratch of 14*B*H*Sp*64 floats, Sp = S rounded up to 64, 16-byte
// aligned (the split operands).  mask: (B, S) uint8 or null.  grid: the
// persistent grid (kernels/flash_attention.bwd_plan), from 1 to the work
// items, B*H*ceil(S/128) in bf16 and B*H*ceil(S/64) in fp32.  Two
// launches on `stream` in bf16, three in fp32.

extern "C" int tts_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, void* delta, void* split, const void* mask, void* dq,
    void* dk, void* dv, int B, int H, int S, int dtype, long long qsb,
    long long qsh, long long qss, long long ksb, long long ksh,
    long long kss, long long vsb, long long vsh, long long vss,
    long long gsb, long long gsh, long long gss, long long dqsb,
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
    return static_cast<int>(cudaGetLastError());
  }
  const int BH = B * H, Sp = (S + FR - 1) / FR * FR;
  const int items = BH * ((S + FR - 1) / FR);
  if (grid < 1 || grid > items || split == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  static const int attr = [] {
    const int rc = smem_attr(reinterpret_cast<const void*>(bwd_dq_tf32),
                             F_SMEM_DQ);
    return rc ? rc
              : smem_attr(reinterpret_cast<const void*>(bwd_dkdv_tf32),
                          F_SMEM_KV);
  }();
  if (attr) return attr;
  F32Args p{};
  p.a = a;
  p.BH = BH;
  float* nat = static_cast<float*>(split);
  float* tr = nat + (long long)NN * BH * Sp * D;
  const cuuint64_t plane = 4ull * Sp * D;
  if (const int rc = split_map(&p.nat, nat, {D, (cuuint64_t)Sp,
                                             (cuuint64_t)BH, NN},
                               {4ull * D, plane, plane * BH}, 32, FT))
    return rc;
  if (const int rc = split_map(&p.tr, tr, {(cuuint64_t)Sp, D,
                                           (cuuint64_t)BH, TN},
                               {4ull * Sp, plane, plane * BH}, FT, D))
    return rc;
  bwd_split_f32<<<dim3(Sp / FT, BH), 256, 0, st>>>(a, nat, tr, BH, Sp);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  bwd_dq_tf32<<<grid, F_THREADS, F_SMEM_DQ, st>>>(p);
  rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  bwd_dkdv_tf32<<<grid, F_THREADS, F_SMEM_KV, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
