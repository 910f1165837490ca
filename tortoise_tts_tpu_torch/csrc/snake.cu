// K7: BigVGAN's anti-aliased Snake activation in one pass:
//     2x upsample (12-tap kaiser FIR) -> snake -> 2x downsample.
//
// Replaces the TPU kernel tortoise_tts_tpu/ops/pallas_snake.py
// snake_resample2 (_snake_kernel_mxu / _snake_kernel).  Per row r of the
// (B*C, T) input, with f the 12 taps of kaiser_sinc_filter(0.25, 0.3, 12)
// and x read with its index clamped to [0, T) (the reference's edge pad):
//     E[u] = 2 (f1 x[u+2] + f3 x[u+1] + f5 x[u] + f7 x[u-1] + f9 x[u-2]
//               + f11 x[u-3])                      (even upsampled samples)
//     O[u] = 2 (f0 x[u+3] + f2 x[u+2] + f4 x[u+1] + f6 x[u] + f8 x[u-1]
//               + f10 x[u-2])                      (odd upsampled samples)
//     s(v) = v + inv_beta[c] sin^2(alpha[c] v),   v[2u] = s(E[u]),
//                                                 v[2u+1] = s(O[u])
//     y[t] = sum_i f[i] v[clamp(2t + i - 5, 0, 2T - 1)]
// The clamp in the last sum is the reference's edge pad of the interleaved
// stream v: v[j] = v[0] = s(E[0]) for j < 0 and v[2T-1] = s(O[T-1]) for
// j >= 2T.
//
// Bound on an H100: one read and one write of (B, C, T), 4 bytes a sample
// in bf16, against about 60 fp32 operations and two sines a sample, so
// bytes bound it: 3.3 us for 768 x 3624.  What holds a kernel back is
// instruction issue: 12 FMAs up, 12 down, two snakes, and whatever
// indexing, staging and clamping it adds.  This design issues 47 warp
// instructions a sample in bf16 inside a row (tools/snake_profile.py counts
// them in the SASS), 42 of them the arithmetic.
//
// Design: each thread owns a run of V consecutive outputs of one row (bf16:
// 16, or 8 in calls below 2^22 samples, which would leave the last wave of
// blocks half empty; fp32: 4), whole 16-byte loads and stores, and keeps
// everything in registers:
// - its x window x[t0-4 .. t0+V+3], from its run's loads and two 4-sample
//   loads on either side (neighbouring lanes loaded them: L1 hits);
// - its V pairs (E, O) after snake, each cosine taken once;
// - the down taps' halo: the neighbouring runs' 3 pairs on each side come
//   from the neighbouring lanes by shuffle, across a warp's edge through
//   shared memory (the kernel's one barrier), and across the block's edge
//   from 6 lanes of warp 0 that compute those 6 pairs again.
// The grid runs over (row, run) flat, 128 runs a block, so a row's end
// wastes at most one run's lanes; rows and channels come from the flat
// index by multiply-shift division (the wrapper's plan).  Only a row's
// first run and the runs whose window passes its end (or a row off 16
// bytes) take the clamped scalar loads and the edge fix-ups.
// The taps are constants, so each FMA takes its tap as an immediate.  The
// bf16 snake is v + ib/2 - ib/2 cos(2 alpha v), its constant ib/2 added
// once an output; 2 alpha v is reduced by 2 pi (sin^2 has period pi) in two
// Cody-Waite constants and __cosf takes [-pi, pi]: the reduced argument is
// off by at most about 2.4e-7 + |k| 4e-15, and __cosf there by at most
// 2^-21.19, so the snake term is within about 1e-6 ib of the exact sine of
// the fp32 product.  fp32, the parity path, keeps v + ib sinf(alpha v)^2.
// FIR taps and snake run in fp32 for every storage type, and each output
// is rounded once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;   // runs a block
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

// tools/snake_profile.py compiles the source once more with
// SNAKE_SASS_INTERIOR defined, to count in the SASS the instructions of a
// run inside a row: the row-end branches are then never taken (that build
// is wrong at a row's ends and is never launched)
#ifdef SNAKE_SASS_INTERIOR
#define ROW_END(cond) false
#else
#define ROW_END(cond) (cond)
#endif

// kaiser_sinc_filter(0.25, 0.3, 12) in fp32, symmetric: F(i) = F(11 - i)
// (tests/test_torch_bigvgan.py holds these against the port's filter).  As
// constants each FMA takes its tap as an immediate operand.
__host__ __device__ constexpr float F(int i) {
  return i > 5    ? F(11 - i)
         : i == 0 ? 0x1.09f0d2p-9f
         : i == 1 ? 0x1.33ac88p-7f
         : i == 2 ? -0x1.a2810ep-6f
         : i == 3 ? -0x1.d85448p-5f
         : i == 4 ? 0x1.075114p-3f
                  : 0x1.c5d8cap-2f;
}

__host__ __device__ constexpr float tap_sum() {
  float s = 0.f;
  for (int i = 0; i < 12; ++i) s += F(i);
  return s;
}

// n / d = (umulhi(n, m) + n) >> l for 0 <= n < 2^31 (Granlund and
// Montgomery's multiply-shift; kernels/snake.py computes m and l)
struct FastDiv {
  unsigned d, m;
  int l;
  __device__ __forceinline__ unsigned div(unsigned n) const {
    return (__umulhi(n, m) + n) >> l;
  }
};

struct Plan {
  int T;
  unsigned runs;        // rows * per_row
  FastDiv per_row;      // runs a row: ceil(T / V)
  FastDiv channels;     // C: row r is channel r % C
};

// storage types: the 4 samples of a run's halo on each side and its
// 16-byte chunks, loaded and unpacked to fp32; scalar access for a row's
// ends
template <typename T>
struct Io;

template <>
struct Io<float> {
  static constexpr int CHUNK = 4;   // samples a 16-byte vector
  __device__ static float get(const float* p) { return *p; }
  __device__ static void put(float* p, float v) { *p = v; }
  __device__ static void load4(const float* p, float* o) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
  __device__ static void load_chunk(const float* p, float* o) { load4(p, o); }
  __device__ static void store_chunk(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Io<__nv_bfloat16> {
  static constexpr int CHUNK = 8;
  __device__ static float get(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ static void put(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);
  }
  __device__ static void unpack(unsigned w, float* o) {
    o[0] = __uint_as_float(w << 16);
    o[1] = __uint_as_float(w & 0xffff0000u);
  }
  __device__ static void load4(const __nv_bfloat16* p, float* o) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    unpack(v.x, o); unpack(v.y, o + 2);
  }
  __device__ static void load_chunk(const __nv_bfloat16* p, float* o) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    unpack(v.x, o); unpack(v.y, o + 2); unpack(v.z, o + 4);
    unpack(v.w, o + 6);
  }
  __device__ static unsigned pack(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&h);
  }
  __device__ static void store_chunk(__nv_bfloat16* p, const float* v) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack(v[0], v[1]), pack(v[2], v[3]), pack(v[4], v[5]),
                   pack(v[6], v[7]));
  }
};

// v + ib sin^2(a v), the snake of one upsampled sample, as w(v) + bias.
// FAST: sin^2 y = (1 - cos 2y) / 2, so w(v) = v - (ib / 2) cos(2 a v) and
// bias = (ib / 2) tap_sum(), added once an output (the down taps' sum).
// cos 2y has period pi in y: z = 2y is reduced to z - 2 pi k, k = rint(z /
// 2 pi) (the 1.5 * 2^23 shift rounds to nearest), in two Cody-Waite
// constants (fp32(2 pi) and fp32(2 pi - fp32(2 pi)); each FMA rounds once),
// and __cosf takes [-pi, pi].  Otherwise w(v) = v + ib sinf(a v)^2, bias 0.
template <bool FAST>
struct Snake {
  float a, ib, bias;
  __device__ Snake(float alpha, float inv_beta) {
    if constexpr (FAST) {
      a = 2.f * alpha;
      ib = 0.5f * inv_beta;
      bias = ib * tap_sum();
    } else {
      a = alpha;
      ib = inv_beta;
      bias = 0.f;
    }
  }
  __device__ __forceinline__ float operator()(float v) const {
    const float y = a * v;
    if constexpr (FAST) {
      const float k = fmaf(y, 0.159154937f, 12582912.f) - 12582912.f;
      float r = fmaf(-k, 6.28318548f, y);
      r = fmaf(-k, -1.74845553e-7f, r);
      return fmaf(-ib, __cosf(r), v);
    } else {
      const float s = sinf(y);
      return fmaf(ib, s * s, v);
    }
  }
};

// (E, O) after snake at u from xw[s] = x[u - 3 + s], s = 0..6
template <bool FAST>
__device__ __forceinline__ void pair(const float* xw, const Snake<FAST>& sn,
                                     float& e, float& o) {
  float E = 2.f * F(11) * xw[0];
  E = fmaf(2.f * F(9), xw[1], E);
  E = fmaf(2.f * F(7), xw[2], E);
  E = fmaf(2.f * F(5), xw[3], E);
  E = fmaf(2.f * F(3), xw[4], E);
  E = fmaf(2.f * F(1), xw[5], E);
  float O = 2.f * F(10) * xw[1];
  O = fmaf(2.f * F(8), xw[2], O);
  O = fmaf(2.f * F(6), xw[3], O);
  O = fmaf(2.f * F(4), xw[4], O);
  O = fmaf(2.f * F(2), xw[5], O);
  O = fmaf(2.f * F(0), xw[6], O);
  e = sn(E);
  o = sn(O);
}

// the run of flat index g (past the last run: the last, whose lanes
// compute and shuffle but store nothing): its row's offset, first output
// t0 and channel parameters
template <int V>
struct Run {
  long long base;
  int t0;
  float a, ib;
  bool valid;
  __device__ Run(unsigned g, const Plan& p, const float* alpha,
                 const float* inv_beta) {
    valid = g < p.runs;
    g = min(g, p.runs - 1);
    const unsigned row = p.per_row.div(g);
    const unsigned ch = row - p.channels.d * p.channels.div(row);
    base = static_cast<long long>(row) * p.T;
    t0 = static_cast<int>(g - row * p.per_row.d) * V;
    a = alpha[ch];
    ib = inv_beta[ch];
  }
};

template <typename T, int V, bool FAST>
__global__ void __launch_bounds__(THREADS)
    snake_resample2(const T* __restrict__ x, const float* __restrict__ alpha,
                    const float* __restrict__ inv_beta, T* __restrict__ y,
                    const Plan p) {
  constexpr int CHUNK = Io<T>::CHUNK;
  static_assert(V % CHUNK == 0 && V >= 4, "a run is whole 16-byte chunks");
  // warp w's lane 31 leaves its last 3 pairs in hi[w + 1] (O, E, O, E, O)
  // and lane 0 its first 3 in lo[w] (E, O, E, O, E), as a 16-byte store
  // and a 4-byte one; hi[0] and lo[WARPS] are the block's outer halo,
  // computed again by warp 0
  __shared__ __align__(16) float hi[WARPS + 1][8], lo[WARPS + 1][8];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int T_len = p.T;
  const unsigned g0 = blockIdx.x * THREADS;
  const Run<V> r(g0 + threadIdx.x, p, alpha, inv_beta);
  const Snake<FAST> sn(r.a, r.ib);
  const int t0 = r.t0;
  const T* xt = x + r.base + t0;

  // xs[j] = x[t0 - 4 + j]: clamped scalar loads in a row's first run, the
  // runs whose window passes its end, and a row off 16 bytes
  float xs[V + 8];
  if (ROW_END(t0 < 4 || t0 + V + 4 > T_len ||
              (reinterpret_cast<uintptr_t>(xt) & 15) != 0)) {
#pragma unroll
    for (int j = 0; j < V + 8; ++j)
      xs[j] = Io<T>::get(x + r.base + min(max(t0 - 4 + j, 0), T_len - 1));
  } else {
    Io<T>::load4(xt - 4, xs);
#pragma unroll
    for (int c = 0; c < V; c += CHUNK) Io<T>::load_chunk(xt + c, xs + 4 + c);
    Io<T>::load4(xt + V, xs + V + 4);
  }
  float e[V], o[V];
#pragma unroll
  for (int q = 0; q < V; ++q)
    pair<FAST>(xs + q + 1, sn, e[q], o[q]);
  if (ROW_END(t0 + V > T_len)) {
    // ragged last run: pairs past T - 1 are v[2T - 1] = O[T - 1]
    const int n = T_len - t0;
    float edge = o[0];
#pragma unroll
    for (int q = 1; q < V; ++q)
      if (q == n - 1) edge = o[q];
#pragma unroll
    for (int q = 1; q < V; ++q)
      if (q >= n) e[q] = o[q] = edge;
  }

  // down taps' halo: L = (O, E, O, E, O) at t0-3 .. t0-1,
  // R = (E, O, E, O, E) at t0+V .. t0+V+2
  float L[5] = {o[V - 3], e[V - 2], o[V - 2], e[V - 1], o[V - 1]};
  float R[5] = {e[0], o[0], e[1], o[1], e[2]};
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    L[k] = __shfl_up_sync(FULL, L[k], 1);
    R[k] = __shfl_down_sync(FULL, R[k], 1);
  }
  if (lane == 31) {
    *reinterpret_cast<float4*>(hi[warp + 1]) =
        make_float4(o[V - 3], e[V - 2], o[V - 2], e[V - 1]);
    hi[warp + 1][4] = o[V - 1];
  }
  if (lane == 0) {
    *reinterpret_cast<float4*>(lo[warp]) = make_float4(e[0], o[0], e[1], o[1]);
    lo[warp][4] = e[2];
  }
#ifndef SNAKE_SASS_INTERIOR
  if (warp == 0 && lane < 6) {
    // the pairs at t0-3 .. t0-1 of the block's first run (lanes 0-2) and
    // at t0+V .. t0+V+2 of its last (lanes 3-5); a pair past T - 1 is
    // O[T - 1] twice (a row's first run replaces its L below)
    const bool left = lane < 3;
    const Run<V> b(left ? g0 : min(g0 + THREADS, p.runs) - 1, p, alpha,
                   inv_beta);
    const int j = left ? lane : lane - 3;
    const int u = left ? b.t0 - 3 + j : b.t0 + V + j;
    const int uc = min(max(u, 0), T_len - 1);
    float xw[7];
#pragma unroll
    for (int s = 0; s < 7; ++s)
      xw[s] = Io<T>::get(x + b.base + min(max(uc - 3 + s, 0), T_len - 1));
    float pe, po;
    pair<FAST>(xw, Snake<FAST>(b.a, b.ib), pe, po);
    if (u >= T_len) pe = po;
    float* dst = left ? hi[0] : lo[WARPS];
    const int ie = left ? 2 * j - 1 : 2 * j;
    if (ie >= 0) dst[ie] = pe;
    if (ie + 1 < 5) dst[ie + 1] = po;
  }
#endif
  __syncthreads();
  if (lane == 0) {
    const float4 h = *reinterpret_cast<const float4*>(hi[warp]);
    L[0] = h.x; L[1] = h.y; L[2] = h.z; L[3] = h.w; L[4] = hi[warp][4];
  }
  if (lane == 31) {
    const float4 l = *reinterpret_cast<const float4*>(lo[warp + 1]);
    R[0] = l.x; R[1] = l.y; R[2] = l.z; R[3] = l.w; R[4] = lo[warp + 1][4];
  }
  // a row's ends: v[j < 0] = E[0], v[j >= 2T] = O[T - 1]
  if (ROW_END(t0 == 0)) {
#pragma unroll
    for (int k = 0; k < 5; ++k) L[k] = e[0];
  }
  if (ROW_END(t0 + V >= T_len)) {
#pragma unroll
    for (int k = 0; k < 5; ++k) R[k] = o[V - 1];
  }

  // vw[j] = w(v[2 t0 - 5 + j]); y[t0 + k] = bias + sum_i f[i] vw[2k + i]
  float vw[2 * V + 10];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    vw[k] = L[k];
    vw[2 * V + 5 + k] = R[k];
  }
#pragma unroll
  for (int q = 0; q < V; ++q) {
    vw[5 + 2 * q] = e[q];
    vw[6 + 2 * q] = o[q];
  }
  float out[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    float acc = fmaf(F(0), vw[2 * k], sn.bias);
#pragma unroll
    for (int i = 1; i < 12; ++i) acc = fmaf(F(i), vw[2 * k + i], acc);
    out[k] = acc;
  }
  if (!r.valid) return;
  T* yt = y + r.base + t0;
  if (ROW_END(t0 + V > T_len ||
              (reinterpret_cast<uintptr_t>(yt) & 15) != 0)) {
#pragma unroll
    for (int k = 0; k < V; ++k)
      if (t0 + k < T_len) Io<T>::put(yt + k, out[k]);
  } else {
#pragma unroll
    for (int c = 0; c < V; c += CHUNK) Io<T>::store_chunk(yt + c, out + c);
  }
}

bool fastdiv_ok(const FastDiv& f, unsigned n_max) {
  // spot checks of the wrapper's multiply-shift constants
  const unsigned ns[4] = {0u, f.d - 1, f.d, n_max};
  for (unsigned n : ns) {
    const unsigned q = static_cast<unsigned>(
        ((static_cast<unsigned long long>(n) * f.m >> 32) + n) >> f.l);
    if (n <= n_max && q != n / f.d) return false;
  }
  return true;
}

template <typename T, int V, bool FAST>
int launch(const void* x, const float* alpha, const float* inv_beta, void* y,
           const Plan& p, int tiles, cudaStream_t st) {
  snake_resample2<T, V, FAST><<<tiles, THREADS, 0, st>>>(
      static_cast<const T*>(x), alpha, inv_beta, static_cast<T*>(y), p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: (rows, T) contiguous, row r is channel r % C; alpha, inv_beta: (C)
// fp32 on the device (alpha already exp'd for logscale, inv_beta =
// 1 / (beta + 1e-9)).  The plan (kernels/snake.py): V outputs a run (4 in
// fp32; 8 or 16 in bf16), per_row = ceil(T / V) runs a row, tiles of 256
// runs, and the multiply-shift constants (m, l) that divide by per_row and
// by C.  dtype: 0 = float32, 1 = bfloat16.
extern "C" int tts_snake_resample2(const void* x, const float* alpha,
                                   const float* inv_beta, void* y, int rows,
                                   int C, int T, int V, int per_row,
                                   unsigned per_row_m, int per_row_l,
                                   unsigned c_m, int c_l, int tiles,
                                   int dtype, void* stream) {
  const long long runs = static_cast<long long>(rows) * per_row;
  const bool v_ok = dtype == 1 ? V == 8 || V == 16 : dtype == 0 && V == 4;
  if (!v_ok || rows < 1 || C < 1 || T < 1 || per_row != (T + V - 1) / V ||
      runs >= (1ll << 31) || tiles != (runs + THREADS - 1) / THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p{T, static_cast<unsigned>(runs),
               FastDiv{static_cast<unsigned>(per_row), per_row_m, per_row_l},
               FastDiv{static_cast<unsigned>(C), c_m, c_l}};
  if (!fastdiv_ok(p.per_row, p.runs - 1) ||
      !fastdiv_ok(p.channels, static_cast<unsigned>(rows - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float, 4, false>(x, alpha, inv_beta, y, p,
                                                 tiles, st);
  if (V == 8) return launch<__nv_bfloat16, 8, true>(x, alpha, inv_beta, y, p,
                                                    tiles, st);
  return launch<__nv_bfloat16, 16, true>(x, alpha, inv_beta, y, p, tiles,
                                         st);
}
