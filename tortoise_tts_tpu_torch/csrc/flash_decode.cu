// K3: flash decoding for the UnifiedVoice decode step, one launch a call.
//
// Replaces the TPU kernel tortoise_tts_tpu/ops/pallas_decode_attn.py
// flash_decode_stacked (_fd_kernel): one query per (row, head) attends to
// the cache slots j <= pos whose key-validity mask is set,
//     o = softmax(q k^T / sqrt(Dh)) v,
// with an fp32 softmax and the output in the query's type.  Head dim 64.
//
// Bound on an H100: bytes.  Each step reads K and V up to pos once:
// 2 * H * (pos+1) * Dh * 2 B per layer at bf16, about 1.1 MB per layer
// at B=1, pos = 267 (0.33 us at 3.35 TB/s), 2.5 MB at pos ~ 600, 13 MB
// for 16 candidates.  At B = 1 a call is far below a microsecond of
// bytes, so what counts is the latency chain: one launch, one memory round
// trip, one merge; at 8 and 16 rows, keeping every SM's copies flowing
// while its warps compute.
//
// Design (fd_cluster): one kernel, grid (split, rows*heads), a block of 8
// warps.  The `split` blocks of a (row, head) form a thread-block cluster
// and take consecutive `chunk`-slot runs of the slot range; with split > 1
// each block writes its partial (max, sum, 64 accumulators) into the
// cluster's first block through distributed shared memory, and after one
// cluster barrier that block merges them and writes o.  The wrapper's
// plan (kernels/flash_decode.plan) splits only where rows*heads leave SMs
// idle (16 row-heads at B=1: split 8), and the grid depends on the
// cache's S, not on pos: a block whose run lies wholly past pos loads
// nothing and only meets the cluster's barrier.  pos is an argument or
// read from an int32 in device memory (a pointer, null when the argument
// is used; clamped to [0, S-1]), so the launch does not change from one
// decode step to the next.
//
// Inside a block each warp takes the steps w, w + 8, ... of 8 slots of the
// block's run.  A step's K and V rows (the cache is (rows, H, S, 64)
// contiguous, so a step is two runs of 8 rows) are bulk copies
// (cp.async.bulk, the TMA engine) into the warp's ring of `nbuf` (at most
// 2) buffers, counted on the buffer's mbarrier: the lanes issue the first
// steps, one each, and each step done issues the one `nbuf` ahead, so the
// copies stream while the warps compute (issuing a warp's every step at
// once queued them in the copy engine and held the warps there; and q and
// the mask bytes are loaded before any copy, so they do not queue behind
// them).  A step: 4 lanes a slot compute 8 scores at once (16 channels a
// lane, read as whole 16-byte chunks in an order that keeps a quarter
// warp on 8 distinct chunks, two shuffles), the warp's max over the 8 by
// three shuffles, an online rescale, then the 8 slots' V rows with a lane
// on 2 channels.  The warps then merge in shared memory, and the blocks of
// the cluster in the first block.  No global scratch, no counters.
// Masked slots take no weight, which is what the plain version's finite
// -1e9 gives for a row with a valid key (the slot at pos always is).
// fp32 keeps fp32 arithmetic.  GEMV-shaped work (2 flops a byte): no
// tensor cores.
//
// Shared-prefix form (tts_flash_decode_shared), for the candidate fan-out
// of the JAX package's _mha_shared (tortoise_tts_tpu/models/
// unified_voice.py): rows b = g*C + c of G groups share one prefill,
// whose K/V are held once per group, (G, H, Sp, 64) with a (G, Sp) key
// mask, beside a per-row decode region (B, H, Sd, 64) valid up to pos.
// The same kernel walks the joint slot range [prefix | region]: slots
// j < Sp read the row's group prefix, the rest its region.  The group's
// other rows read the same prefix again, from L2 (at C = 16 the prefix is
// 2% of the bytes a call).
#include "hopper.cuh"

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int DH = 64;
constexpr int WARPS = 8;
constexpr int STEP = 8;   // slots a warp step
constexpr int SPLIT_MAX = 8;   // blocks a cluster
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
// the bf16 in the low (hi = 0) or high half of x, as a float (exact)
__device__ __forceinline__ float bf16_at(uint32_t x, int hi) {
  return __uint_as_float(hi ? x & 0xffff0000u : x << 16);
}
// dot += the 16 bytes of w (8 bf16 or 4 fp32 channels) . q[0 ..]
__device__ __forceinline__ float dot_chunk(const uint4& w, const float* q,
                                          float dot, float) {
  dot = fmaf(q[0], __uint_as_float(w.x), dot);
  dot = fmaf(q[1], __uint_as_float(w.y), dot);
  dot = fmaf(q[2], __uint_as_float(w.z), dot);
  return fmaf(q[3], __uint_as_float(w.w), dot);
}
__device__ __forceinline__ float dot_chunk(const uint4& w, const float* q,
                                          float dot, __nv_bfloat16) {
  float odd = 0.f;
  dot = fmaf(q[0], bf16_at(w.x, 0), dot);
  odd = fmaf(q[1], bf16_at(w.x, 1), odd);
  dot = fmaf(q[2], bf16_at(w.y, 0), dot);
  odd = fmaf(q[3], bf16_at(w.y, 1), odd);
  dot = fmaf(q[4], bf16_at(w.z, 0), dot);
  odd = fmaf(q[5], bf16_at(w.z, 1), odd);
  dot = fmaf(q[6], bf16_at(w.w, 0), dot);
  odd = fmaf(q[7], bf16_at(w.w, 1), odd);
  return dot + odd;
}
// the 16 bytes of w as 8 bf16 or 4 fp32 channels, into f[0 ..]
__device__ __forceinline__ void unpack(const uint4& w, float* f, float) {
  f[0] = __uint_as_float(w.x);
  f[1] = __uint_as_float(w.y);
  f[2] = __uint_as_float(w.z);
  f[3] = __uint_as_float(w.w);
}
__device__ __forceinline__ void unpack(const uint4& w, float* f,
                                       __nv_bfloat16) {
  f[0] = bf16_at(w.x, 0);
  f[1] = bf16_at(w.x, 1);
  f[2] = bf16_at(w.y, 0);
  f[3] = bf16_at(w.y, 1);
  f[4] = bf16_at(w.z, 0);
  f[5] = bf16_at(w.z, 1);
  f[6] = bf16_at(w.w, 0);
  f[7] = bf16_at(w.w, 1);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
struct Args {
  const T* q;
  long long qsb, qsh;
  const T* kp;             // prefix (G, H, Sp, 64), or null with Sp = 0
  const T* vp;
  const uint8_t* pmask;    // (G, Sp)
  const T* k;              // region / cache (B, H, S, 64)
  const T* v;
  const uint8_t* mask;     // (B, S) or null
  const int* pos_ptr;      // pos in device memory, or null: take `pos`
  T* o;                    // (B, H, 64)
  int Sp, C, S, H, pos, chunk, nbuf;
  float scale;
};

// a bulk copy of `bytes` (a multiple of 16) global -> shared, counted on
// the mbarrier `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(hopper::smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Dynamic shared memory: each warp's ring of nbuf steps (8 K rows, then 8
// V rows, 64 * sizeof(T) bytes each), the ring's mbarriers, then the
// block run's mask bytes.
template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
    fd_cluster(const __grid_constant__ Args<T> a) {
  namespace cg = cooperative_groups;
  constexpr int ROW = DH * (int)sizeof(T);   // bytes a cache row
  constexpr int STEP_BYTES = 2 * STEP * ROW;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float wm[WARPS], wl[WARPS], wacc[WARPS][DH];
  // the cluster's records, in its first block: (64 accumulators, max, sum)
  __shared__ float recs[SPLIT_MAX][DH + 2];

  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, sub = lane & 3;
  const int pos = min(max(a.pos_ptr ? *a.pos_ptr : a.pos, 0), a.S - 1);
  const int j0 = blockIdx.x * a.chunk;
  const int j1 = min(j0 + a.chunk, a.Sp + pos + 1);   // [prefix | region]
  const int nsteps = j1 > j0 ? (j1 - j0 + STEP - 1) / STEP : 0;
  const int mine = nsteps > warp ? (nsteps - warp + WARPS - 1) / WARPS : 0;
  unsigned char* ring = smem + warp * a.nbuf * STEP_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + WARPS * a.nbuf *
                                               STEP_BYTES) + warp * a.nbuf;
  uint8_t* mk = reinterpret_cast<uint8_t*>(bars - warp * a.nbuf +
                                           WARPS * a.nbuf);
  const long long prow = (long long)(b / a.C) * a.H + h;   // prefix row-head
  const long long rrow = (long long)bh;                    // region row-head

  // slots [j, j + n) of one segment: K (kv = 0) or V rows, contiguous
  auto rows_of = [&](int j, int kv) -> const T* {
    if (j < a.Sp) return (kv ? a.vp : a.kp) + (prow * a.Sp + j) * DH;
    return (kv ? a.v : a.k) + (rrow * a.S + (j - a.Sp)) * DH;
  };
  // this warp's i-th step into ring buffer i % nbuf, by two to four bulk
  // copies (K and V, each split where the step crosses from the prefix
  // into the region) on the buffer's mbarrier
  auto load_step = [&](int i) {
    if (i >= mine) return;
    const int js = j0 + (warp + WARPS * i) * STEP;
    const int nv = min(STEP, j1 - js);
    unsigned char* buf = ring + (i % a.nbuf) * STEP_BYTES;
    const uint32_t bar = hopper::smem_u32(bars + i % a.nbuf);
    hopper::mbar_expect_tx(bar, 2 * nv * ROW);
    const int n0 = js < a.Sp ? min(nv, a.Sp - js) : nv;   // first segment
#pragma unroll
    for (int kv = 0; kv < 2; ++kv) {
      unsigned char* dst = buf + kv * STEP * ROW;
      bulk_load(dst, rows_of(js, kv), n0 * ROW, bar);
      if (n0 < nv)
        bulk_load(dst + n0 * ROW, rows_of(js + n0, kv), (nv - n0) * ROW,
                  bar);
    }
  };
  // q and the run's mask bytes (MB a thread; a run past MB * blockDim
  // slots takes more rounds) are loaded before the bulk copies are issued,
  // so these few bytes do not queue behind the run's
  constexpr int CL = (int)sizeof(T);   // 16-byte chunks of q a lane
  constexpr int MB = 4;   // mask bytes a thread a round, packed in a word
  // q's chunks in the order this lane reads K's (see the step below)
  const int par = grp & 1;
  uint4 qw[CL];
  {
    const uint4* qp = reinterpret_cast<const uint4*>(
        a.q + b * a.qsb + h * a.qsh + 16 * sub);
#pragma unroll
    for (int c = 0; c < CL; ++c) qw[c] = qp[c ^ par];
  }
  const int nthr = blockDim.x, run = j1 - j0;   // run < 0: past pos
  auto mask_round = [&](int t0) -> uint32_t {
    uint32_t mv = 0;
#pragma unroll
    for (int u = 0; u < MB; ++u) {
      const int j = j0 + t0 + u * nthr;
      uint32_t ok = 1;
      if (j >= j1) continue;
      if (j < a.Sp) {
        if (a.pmask) ok = a.pmask[(b / a.C) * (long long)a.Sp + j];
      } else if (a.mask) {
        ok = a.mask[(long long)b * a.S + (j - a.Sp)];
      }
      mv |= ok << (8 * u);
    }
    return mv;
  };
  auto mask_store = [&](int t0, uint32_t mv) {
#pragma unroll
    for (int u = 0; u < MB; ++u)
      if (t0 + u * nthr < run) mk[t0 + u * nthr] = (mv >> (8 * u)) & 0xffu;
  };
  uint32_t mv = mask_round(threadIdx.x);

  if (lane == 0) {
    for (int i = 0; i < a.nbuf; ++i) hopper::mbar_init(
        hopper::smem_u32(bars + i), 1);
    hopper::fence_barrier_init();
  }
  __syncwarp();
  if (lane < a.nbuf) load_step(lane);   // the ring's steps, a lane each

  // this lane's 16 query channels, 16 sub .. 16 sub + 15, chunk c ^ par
  // in place c
  float qf[16];
#pragma unroll
  for (int c = 0; c < CL; ++c) unpack(qw[c], qf + c * (16 / CL), T());
  mask_store(threadIdx.x, mv);
  for (int t0 = threadIdx.x + MB * nthr; t0 < run; t0 += MB * nthr)
    mask_store(t0, mask_round(t0));
  __syncthreads();   // the mask bytes and the ring's mbarriers

  const float sl2 = a.scale * LOG2E;
  float m = -INFINITY, l = 0.f, acc0 = 0.f, acc1 = 0.f;
  for (int i = 0; i < mine; ++i) {
    hopper::mbar_wait(hopper::smem_u32(bars + i % a.nbuf), (i / a.nbuf) & 1);
    const unsigned char* buf = ring + (i % a.nbuf) * STEP_BYTES;
    const int js = j0 + (warp + WARPS * i) * STEP;
    const int nv = min(STEP, j1 - js);   // slots of this step, warp-uniform
    // score of slot grp: this lane's 16 channels are the CL 16-byte chunks
    // sub * CL .. of K row grp, each read whole; odd slots take them in
    // the other order, so a quarter warp's 8 lanes hit 8 distinct chunks
    float dot = 0.f;
    {
      const unsigned char* kr = buf + grp * ROW;
#pragma unroll
      for (int c = 0; c < CL; ++c) {
        const uint4 w = *reinterpret_cast<const uint4*>(
            kr + ((sub * CL + (c ^ par)) << 4));
        dot = dot_chunk(w, qf + c * (16 / CL), dot, T());
      }
    }
    dot += __shfl_xor_sync(0xffffffffu, dot, 1);
    dot += __shfl_xor_sync(0xffffffffu, dot, 2);
    const bool ok = grp < nv && mk[js - j0 + min(grp, nv - 1)] != 0;
    const float s = ok ? dot * sl2 : -INFINITY;
    float mx = fmaxf(s, __shfl_xor_sync(0xffffffffu, s, 4));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
    const float mn = fmaxf(m, mx);
    const float mu = mn == -INFINITY ? 0.f : mn;   // all masked so far
    const float alpha = exp2f(m - mu);
    const float p = exp2f(s - mu);
    l *= alpha;
    acc0 *= alpha;
    acc1 *= alpha;
    // channels 2 lane, 2 lane + 1 of the step's V rows
    const unsigned char* vr = buf + STEP * ROW + 2 * lane * (int)sizeof(T);
#pragma unroll
    for (int u = 0; u < STEP; ++u) {
      const float pu = __shfl_sync(0xffffffffu, p, 4 * u);
      if (u < nv) {   // rows past the run were not loaded
        const float2 vv = load2(reinterpret_cast<const T*>(vr + u * ROW));
        l += pu;
        acc0 = fmaf(pu, vv.x, acc0);
        acc1 = fmaf(pu, vv.y, acc1);
      }
    }
    m = mn;
    if (i + a.nbuf < mine) {   // the buffer is reused: reads before copies
      __syncwarp();
      if (lane == 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        load_step(i + a.nbuf);
      }
    }
  }

  // the block's warps, then the cluster's blocks
  if (lane == 0) {
    wm[warp] = m;
    wl[warp] = l;
  }
  wacc[warp][2 * lane] = acc0;
  wacc[warp][2 * lane + 1] = acc1;
  __syncthreads();
  float bm = -INFINITY, bl = 0.f, ba = 0.f;
  if (threadIdx.x < DH) {
    const int d = threadIdx.x;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) bm = fmaxf(bm, wm[w]);
    if (bm != -INFINITY) {
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const float c = exp2f(wm[w] - bm);   // 0 for an empty warp
        bl += wl[w] * c;
        ba += wacc[w][d] * c;
      }
    }
  }
  T* op = a.o + (long long)bh * DH;
  if (gridDim.x == 1) {
    if (threadIdx.x < DH) store(op + threadIdx.x, ba / bl);
    return;
  }
  // every block writes its record into the first block's shared memory
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank(), n = cluster.num_blocks();
  if (threadIdx.x < DH) {
    float* rec = cluster.map_shared_rank(&recs[rank][0], 0);
    rec[threadIdx.x] = ba;
    if (threadIdx.x == 0) {
      rec[DH] = bm;
      rec[DH + 1] = bl;
    }
  }
  cluster.sync();
  if (rank != 0 || threadIdx.x >= DH) return;
  const int d = threadIdx.x;
  float mx = -INFINITY;
#pragma unroll
  for (unsigned r = 0; r < SPLIT_MAX; ++r)
    if (r < n) mx = fmaxf(mx, recs[r][DH]);
  float ls = 0.f, acc = 0.f;
#pragma unroll
  for (unsigned r = 0; r < SPLIT_MAX; ++r) {
    if (r >= n || recs[r][DH] == -INFINITY) continue;   // a run past pos
    const float c = exp2f(recs[r][DH] - mx);
    ls += recs[r][DH + 1] * c;
    acc += recs[r][d] * c;
  }
  store(op + d, acc / ls);
}

template <typename T>
int launch(const Args<T>& a, int B, int split, cudaStream_t st) {
  const int smem = WARPS * a.nbuf * (2 * STEP * DH * (int)sizeof(T) + 8) +
                   ((a.chunk + 15) & ~15);
  static int allowed = 48 * 1024;
  if (smem > allowed) {
    const int rc = static_cast<int>(cudaFuncSetAttribute(
        fd_cluster<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
    if (rc) return rc;
    allowed = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, B * a.H);
  cfg.blockDim = dim3(WARPS * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int rc = static_cast<int>(cudaLaunchKernelEx(&cfg, fd_cluster<T>, a));
  return rc ? rc : static_cast<int>(cudaGetLastError());
}

template <typename T>
int run(const void* q, long long qsb, long long qsh, const void* kp,
        const void* vp, const void* pmask, int Sp, int C, const void* k,
        const void* v, const void* mask, int B, int H, int S, int pos,
        const int* pos_ptr, int split, int chunk, int nbuf, float scale,
        void* o, void* stream) {
  const Args<T> a{static_cast<const T*>(q), qsb, qsh,
                  static_cast<const T*>(kp), static_cast<const T*>(vp),
                  static_cast<const uint8_t*>(pmask),
                  static_cast<const T*>(k), static_cast<const T*>(v),
                  static_cast<const uint8_t*>(mask), pos_ptr,
                  static_cast<T*>(o), Sp, C, S, H, pos, chunk, nbuf, scale};
  return launch<T>(a, B, split, static_cast<cudaStream_t>(stream));
}

int run_type(int dtype, const void* q, long long qsb, long long qsh,
             const void* kp, const void* vp, const void* pmask, int Sp, int C,
             const void* k, const void* v, const void* mask, int B, int H,
             int S, int pos, const void* pos_ptr, int split, int chunk,
             int nbuf, float scale, void* o, void* stream) {
  const int* pp = static_cast<const int*>(pos_ptr);
  if (dtype == 1)
    return run<__nv_bfloat16>(q, qsb, qsh, kp, vp, pmask, Sp, C, k, v, mask,
                              B, H, S, pos, pp, split, chunk, nbuf, scale, o,
                              stream);
  return run<float>(q, qsb, qsh, kp, vp, pmask, Sp, C, k, v, mask, B, H, S,
                    pos, pp, split, chunk, nbuf, scale, o, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q: (B, H, 64) with strides qsb, qsh
// (elements), unit channel stride and 16-byte aligned rows; k, v: one
// layer of the cache,
// (B, H, S, 64) contiguous, 16-byte aligned; mask: (B, S) uint8; pos: the
// decode slot, 0 <= pos < S, read from pos_ptr (an int32 in device
// memory) where that is not null.  Launch plan (kernels/flash_decode.
// plan): `split` blocks a cluster per (row, head) (1 to 8), `chunk` slots
// a block, `nbuf` ring steps a warp.  o: (B, H, 64) contiguous.
extern "C" int tts_flash_decode(const void* q, long long qsb, long long qsh,
                                const void* k, const void* v,
                                const void* mask, int B, int H, int S,
                                int pos, const void* pos_ptr, int split,
                                int chunk, int nbuf, float scale, void* o,
                                int dtype, void* stream) {
  return run_type(dtype, q, qsb, qsh, nullptr, nullptr, nullptr, 0, 1, k, v,
                  mask, B, H, S, pos, pos_ptr, split, chunk, nbuf, scale, o,
                  stream);
}

// The shared-prefix form.  B = G*C rows, row b in group b / C.  kp, vp:
// one layer of the prefix, (G, H, Sp, 64) contiguous; pmask: (G, Sp)
// uint8; k, v: one layer of the region, (B, H, Sd, 64) contiguous, valid
// up to 0 <= pos < Sd; the plan is over Sp + Sd slots; the rest as above.
extern "C" int tts_flash_decode_shared(
    const void* q, long long qsb, long long qsh, const void* kp,
    const void* vp, const void* pmask, int Sp, int C, const void* k,
    const void* v, int B, int H, int Sd, int pos, const void* pos_ptr,
    int split, int chunk, int nbuf, float scale, void* o, int dtype,
    void* stream) {
  return run_type(dtype, q, qsb, qsh, kp, vp, pmask, Sp, C, k, v, nullptr, B,
                  H, Sd, pos, pos_ptr, split, chunk, nbuf, scale, o, stream);
}
