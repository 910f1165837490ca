// K3: split-KV flash decoding for the UnifiedVoice decode step.
//
// Replaces the TPU kernel tortoise_tts_tpu/ops/pallas_decode_attn.py
// flash_decode_stacked (_fd_kernel): one query per (row, head) attends to
// the cache slots j <= pos whose key-validity mask is set,
//     o = softmax(q k^T / sqrt(Dh)) v,
// with an fp32 online softmax and the output in the query's type.  Head
// dim 64.
//
// Bound on an H100: bytes.  Each step reads K and V up to pos once:
// 2 * H * (pos+1) * Dh * 2 B per layer at bf16, about 2.5 MB per layer
// at B=1, pos ~ 600 (74 MB per token over 30 layers, 22 us at 3.35 TB/s).
//
// Design: the grid is (S-split, row*head).  A block of 4 warps takes a
// split of consecutive slots (32 on the main path); each warp walks a
// quarter of them, one slot per step, with its 32 lanes on the 64
// channels (a 4-byte bf16x2 load each, so a warp reads one 128-byte K or
// V row).  Scores reduce by shuffles.  Each warp
// keeps its own running max, sum and accumulators; the block merges its
// warps and writes (max, sum, 64 accumulators) in fp32.  A second kernel,
// one block per (row, head), merges the splits and writes o.  Blocks
// start only for slots <= pos, so nothing past the decode position is
// read, and the ragged end is masked here: the cache needs no padding.
// Masked slots take no weight, which is what the plain version's finite
// -1e9 gives for a row with a valid key (the slot at pos always is).
//
// Shared-prefix form (tts_flash_decode_shared), for the candidate fan-out
// of the JAX package's _mha_shared (tortoise_tts_tpu/models/
// unified_voice.py): rows b = g*C + c of G groups share one prefill,
// whose K/V are held once per group, (G, H, Sp, 64) with a (G, Sp) key
// mask, beside a per-row decode region (B, H, Sd, 64) valid up to pos.
// The same split kernel takes both: the first ceil(Sp/split) blocks of a
// row walk its group's prefix, the rest its region up to pos, and the
// same merge kernel takes the joint softmax over [prefix | region].
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int DH = 64;
constexpr int WARPS = 4;
constexpr int REC = DH + 2;  // partial record: acc[64], max, sum

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One segment of cache slots: a (rows, H, S, 64) K/V pair and an optional
// (rows, S) mask, read for row `row`.
template <typename T>
struct Segment {
  const T* k;
  const T* v;
  const uint8_t* mask;  // null: every slot valid
  int S;
};

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
    fd_split(const T* __restrict__ q, long long qsb, long long qsh,
             Segment<T> pre, int C, int npre, Segment<T> reg, int H, int pos,
             int split, float scale, float* __restrict__ part) {
  __shared__ float sm_m[WARPS], sm_l[WARPS];
  __shared__ float sm_a[WARPS][DH];

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float2 qv = load2(q + b * qsb + h * qsh + 2 * lane);
  // blocks below npre walk the group's prefix, the rest the row's region
  const bool in_pre = (int)blockIdx.x < npre;
  const Segment<T> sg = in_pre ? pre : reg;
  const int row = in_pre ? b / C : b;
  const int blk = in_pre ? blockIdx.x : blockIdx.x - npre;
  const int end = in_pre ? sg.S : pos + 1;
  const long long rh = (long long)row * H + h;
  const T* kb = sg.k + rh * sg.S * DH + 2 * lane;
  const T* vb = sg.v + rh * sg.S * DH + 2 * lane;
  const uint8_t* mk = sg.mask ? sg.mask + (long long)row * sg.S : nullptr;

  float m = -INFINITY, l = 0.f, a0 = 0.f, a1 = 0.f;
  const int per_warp = split / WARPS;
  const int j0 = blk * split + warp * per_warp;
  const int j1 = min(j0 + per_warp, end);
  for (int j = j0; j < j1; ++j) {
    if (mk && mk[j] == 0) continue;  // uniform across the warp
    const float2 kv = load2(kb + (long long)j * DH);
    const float s = warp_sum(qv.x * kv.x + qv.y * kv.y) * scale;
    const float2 vv = load2(vb + (long long)j * DH);
    const float mn = fmaxf(m, s);
    const float alpha = expf(m - mn);  // 0 while m is -inf
    const float p = expf(s - mn);
    l = l * alpha + p;
    a0 = a0 * alpha + p * vv.x;
    a1 = a1 * alpha + p * vv.y;
    m = mn;
  }
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
  sm_a[warp][2 * lane] = a0;
  sm_a[warp][2 * lane + 1] = a1;
  __syncthreads();

  if (threadIdx.x < DH) {
    const int d = threadIdx.x;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm_m[w]);
    float ls = 0.f, acc = 0.f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const float c = expf(sm_m[w] - mx);
        ls += sm_l[w] * c;
        acc += sm_a[w][d] * c;
      }
    }
    float* rec = part + ((long long)bh * gridDim.x + blockIdx.x) * REC;
    rec[d] = acc;
    if (d == 0) {
      rec[DH] = mx;
      rec[DH + 1] = ls;
    }
  }
}

template <typename T>
__global__ void fd_merge(const float* __restrict__ part, int nsplit,
                         T* __restrict__ o) {
  const int bh = blockIdx.x, d = threadIdx.x;
  const float* rec = part + (long long)bh * nsplit * REC;
  float mx = -INFINITY;
  for (int i = 0; i < nsplit; ++i) mx = fmaxf(mx, rec[i * REC + DH]);
  float ls = 0.f, acc = 0.f;
  for (int i = 0; i < nsplit; ++i) {
    const float mi = rec[i * REC + DH];
    if (mi == -INFINITY) continue;
    const float c = expf(mi - mx);
    ls += rec[i * REC + DH + 1] * c;
    acc += rec[i * REC + d] * c;
  }
  store(o + (long long)bh * DH + d, acc / ls);
}

template <typename T>
int run(const T* q, long long qsb, long long qsh, Segment<T> pre, int C,
        Segment<T> reg, int B, int H, int pos, int split, float scale,
        float* part, T* o, cudaStream_t st) {
  const int npre = (pre.S + split - 1) / split;
  const int ns = npre + (pos + split) / split;  // + ceil((pos + 1) / split)
  fd_split<T><<<dim3(ns, B * H), WARPS * 32, 0, st>>>(
      q, qsb, qsh, pre, C, npre, reg, H, pos, split, scale, part);
  fd_merge<T><<<B * H, DH, 0, st>>>(part, ns, o);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, long long qsb, long long qsh, const void* kp,
             const void* vp, const void* pmask, int Sp, int C, const void* k,
             const void* v, const void* mask, int B, int H, int S, int pos,
             int split, float scale, void* part, void* o, void* stream) {
  const Segment<T> pre{static_cast<const T*>(kp), static_cast<const T*>(vp),
                       static_cast<const uint8_t*>(pmask), Sp};
  const Segment<T> reg{static_cast<const T*>(k), static_cast<const T*>(v),
                       static_cast<const uint8_t*>(mask), S};
  return run<T>(static_cast<const T*>(q), qsb, qsh, pre, C, reg, B, H, pos,
                split, scale, static_cast<float*>(part), static_cast<T*>(o),
                static_cast<cudaStream_t>(stream));
}

int dispatch_type(int dtype, const void* q, long long qsb, long long qsh,
                  const void* kp, const void* vp, const void* pmask, int Sp,
                  int C, const void* k, const void* v, const void* mask,
                  int B, int H, int S, int pos, int split, float scale,
                  void* part, void* o, void* stream) {
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, qsb, qsh, kp, vp, pmask, Sp, C, k, v,
                                   mask, B, H, S, pos, split, scale, part, o,
                                   stream);
  return dispatch<float>(q, qsb, qsh, kp, vp, pmask, Sp, C, k, v, mask, B,
                         H, S, pos, split, scale, part, o, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q: (B, H, 64) with strides qsb, qsh
// (elements) and unit channel stride; k, v: one layer of the cache,
// (B, H, S, 64) contiguous; mask: (B, S) uint8; 0 <= pos < S; split:
// cache slots per block, a multiple of 4; part: fp32 scratch of
// (B*H, ceil((pos+1)/split), 66); o: (B, H, 64) contiguous.
extern "C" int tts_flash_decode(const void* q, long long qsb, long long qsh,
                                const void* k, const void* v,
                                const void* mask, int B, int H, int S,
                                int pos, int split, float scale, void* part,
                                void* o, int dtype, void* stream) {
  return dispatch_type(dtype, q, qsb, qsh, nullptr, nullptr, nullptr, 0, 1,
                       k, v, mask, B, H, S, pos, split, scale, part, o,
                       stream);
}

// The shared-prefix form.  B = G*C rows, row b in group b / C.  kp, vp:
// one layer of the prefix, (G, H, Sp, 64) contiguous; pmask: (G, Sp)
// uint8; k, v: one layer of the region, (B, H, Sd, 64) contiguous, valid
// up to 0 <= pos < Sd; part: fp32 scratch of (B*H, ceil(Sp/split) +
// ceil((pos+1)/split), 66); the rest as above.
extern "C" int tts_flash_decode_shared(
    const void* q, long long qsb, long long qsh, const void* kp,
    const void* vp, const void* pmask, int Sp, int C, const void* k,
    const void* v, int B, int H, int Sd, int pos, int split, float scale,
    void* part, void* o, int dtype, void* stream) {
  return dispatch_type(dtype, q, qsb, qsh, kp, vp, pmask, Sp, C, k, v,
                       nullptr, B, H, Sd, pos, split, scale, part, o, stream);
}
