// Hopper (sm_90a) building blocks for the hand-written kernels: mbarriers,
// TMA tile loads, wgmma matrix descriptors and instructions, and the host
// side of the tensor maps that TMA reads.
//
// The tensor maps are encoded on the host for every call (the pointers
// change) by cuTensorMapEncodeTiled, which the CUDA driver exports; it is
// looked up once with dlsym in the libcuda that the process has loaded
// already, so no build needs -lcuda.
#pragma once

#include <cuda.h>   // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace hopper {

// error codes of the host helpers, above every cudaError_t value
// (kernels/_build.describe reads them)
constexpr int ERR_NO_ENCODER = 10001;    // cuTensorMapEncodeTiled not found
constexpr int ERR_TENSOR_MAP = 20000;   // plus the CUresult of a refused map

// 0, or ERR_TENSOR_MAP plus libcuda's code for a refused tensor map
inline int map_result(CUresult r) {
  return r == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP + static_cast<int>(r);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// arrive and announce `bytes` of TMA traffic for the current phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed (a fresh barrier
// counts the phase before its first as complete: parity 1 passes at once)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
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

// 2^x by the MUFU unit (ex2.approx.ftz: results under 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// --- TMA -------------------------------------------------------------------

// a 3-d box of `map` at (c0, c1, c2), innermost first, into shared memory
// at `dst`; completion is counted on `bar`.  Elements outside the tensor
// (negative coordinates included) arrive as zeros.  With the 128-byte
// swizzle the innermost coordinate must be a multiple of 16 bytes (an H100
// raises an illegal instruction otherwise); the outer ones may be any.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// --- wgmma -----------------------------------------------------------------

// Shared-memory matrix descriptor for a tile stored with the 128-byte
// swizzle (as TMA writes it with CU_TENSOR_MAP_SWIZZLE_128B); the tile base
// is 1024-byte aligned.  For a K-major tile of 64-element (128-byte) rows:
// lbo is unused (16), sbo = 1024, the bytes between groups of 8 rows; the
// k-th 16-deep slice starts 32 k bytes in.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// D (64 x N, fp32, this warpgroup's registers) += A (64 x 16) * B (16 x N),
// bf16 operands in shared memory, both K-major (B stored as N rows of K).
// Thread t of the warpgroup holds, for j < N/8, d[4j + 2h + e] at row
// 16 (t / 32) + (t % 32) / 4 + 8h, column 8j + 2 (t % 4) + e.  TB = 1
// takes B MN-major instead (the transpose bit): 16 rows of K, each N
// contiguous elements in 64-element atoms (TMA boxes 64 wide) with the
// 128-byte swizzle, descriptor desc_sw128(addr, lbo, 1024) (lbo the bytes
// between the atoms, unused at N = 64), the k-th slice 2048 k bytes in.
template <int TB = 0>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}

// wgmma_n64's m64n128 form (TB as there).  TA = 1 takes A MN-major
// instead (its transpose bit): 16 rows of K, each 64 M-contiguous elements
// (a TMA box 64 wide) with the 128-byte swizzle, descriptor desc_sw128(addr,
// 16, 1024), the k-th slice 2048 k bytes in.
template <int TB = 0, int TA = 0>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %68, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TB), "n"(TA));
}

// wgmma_n128 with both operands MN-major (both transpose bits set): A as 16
// rows of K, each 64 M-contiguous elements; B as two atoms of 16 rows of K,
// each 64 N-contiguous elements (two TMA boxes 64 elements wide); both
// with the 128-byte swizzle, descriptor desc_sw128(addr, lbo, 1024) (sbo
// the bytes between groups of 8 K rows, lbo the bytes between B's two
// atoms, unused for A), the k-th slice 2048 k bytes in.  D's layout is
// wgmma_n128's.
__device__ __forceinline__ void wgmma_n128_tt(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int N, int TB = 0>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t da,
                                           uint64_t db) {
  if constexpr (N == 64)
    wgmma_n64<TB>(d, da, db);
  else
    wgmma_n128<TB>(d, da, db);
}

// D (64 x 64, fp32) = A (64 x 16, bf16, registers) * B (16 x 64, bf16,
// shared memory) (+ D where ACC; without, D is written only).  Thread t of
// the warpgroup holds A's rows r = 16 (t / 32) + (t % 32) / 4 and r + 8:
// a[0] = (r, k 2 (t % 4) + {0, 1}), a[1] the same at r + 8, a[2] and a[3]
// at k + 8, each a bf16 pair, low half first: two n8 blocks of a D-layout
// accumulator, rounded, are one A slice.  D's layout is wgmma_n64's.
// B is MN-major (the transpose bit set): 16 rows of K, each 64
// N-contiguous elements, with the 128-byte swizzle, descriptor
// desc_sw128(addr, lbo, 1024) (sbo the bytes between groups of 8 K rows;
// lbo, the stride between 64-element N atoms, is unused at N = 64), the
// k-th slice 2048 k bytes in.
#define TTS_WGMMA_N64_RS(OUT, ACC)                                           \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"              \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                    \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                              \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                            \
      "%24, %25, %26, %27, %28, %29, %30, %31"                              \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                      \
      : OUT(d[0]), OUT(d[1]), OUT(d[2]), OUT(d[3]), OUT(d[4]), OUT(d[5]),    \
        OUT(d[6]), OUT(d[7]), OUT(d[8]), OUT(d[9]), OUT(d[10]), OUT(d[11]),  \
        OUT(d[12]), OUT(d[13]), OUT(d[14]), OUT(d[15]), OUT(d[16]),          \
        OUT(d[17]), OUT(d[18]), OUT(d[19]), OUT(d[20]), OUT(d[21]),          \
        OUT(d[22]), OUT(d[23]), OUT(d[24]), OUT(d[25]), OUT(d[26]),          \
        OUT(d[27]), OUT(d[28]), OUT(d[29]), OUT(d[30]), OUT(d[31])           \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(ACC))

template <bool ACC>
__device__ __forceinline__ void wgmma_n64_rs_mn(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  if constexpr (ACC)
    TTS_WGMMA_N64_RS("+f", 1);
  else
    TTS_WGMMA_N64_RS("=f", 0);
}
#undef TTS_WGMMA_N64_RS

// D (64 x 72, fp32) += A (64 x 16, bf16, registers, as wgmma_n64_rs_mn's)
// B (16 x 72, bf16, K-major in shared memory, as wgmma_n64's B, rows 64-71
// at 8192 bytes past its base): D's layout is wgmma_n64's with a ninth n8
// block, d[32..35].
__device__ __forceinline__ void wgmma_n72_rs(float (&d)[36],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35"
      "}, {%36, %37, %38, %39}, %40, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x N, fp32) += A (64 x 8, tf32, registers) * B (8 x N, tf32, shared
// memory, K-major, as wgmma_n64's B: N rows of 32 fp32 channels with the
// 128-byte swizzle, the k-th 8-deep slice 32 k bytes in).  TF32 takes
// both operands K-major only (no transpose bits).  Thread t of the
// warpgroup holds A's rows r = 16 (t / 32) + (t % 32) / 4 and r + 8:
// a[0] = (r, k), a[1] = (r + 8, k), a[2] = (r, k + 4), a[3] = (r + 8, k +
// 4) with k = t % 4, each an fp32 bit pattern whose low 13 bits the
// tensor cores ignore.  D's layout is wgmma_n64's.  N: 64, 104 or 128.
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2],
                                              const uint32_t (&a)[4],
                                              uint64_t db);

template <>
__device__ __forceinline__ void wgmma_tf32_rs<64>(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<104>(float (&d)[52],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %57, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51"
      "}, {%52, %53, %54, %55}, %56, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<128>(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// Orders the compiler's reads and writes of wgmma accumulators against the
// asynchronous instructions: after wgmma_wait, before reading them; before
// the issue, after writing them.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// keeps a register A operand live (and unmoved) until after the wait for
// the product that reads it
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// generic-proxy writes to shared memory made visible to the async proxy
// (wgmma, TMA) before the barrier that publishes them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// v rounded to TF32 as cvt.rna rounds it (to nearest, ties away from
// zero), the 13 low bits cleared: the hi part of a 3xTF32 split; v minus
// it (the lo part) is exact in fp32
__device__ __forceinline__ float tf32_hi(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return __uint_as_float(r & 0xFFFFE000u);
}

// x's 3xTF32 split: hi = tf32_hi(x) and lo = x - hi, as bit patterns
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
  const float h = tf32_hi(x);
  hi = __float_as_uint(h);
  lo = __float_as_uint(__fsub_rn(x, h));
}

// tf32_split of four values, a 16-byte piece each
__device__ __forceinline__ void tf32_split4(float4 x, uint4& hi, uint4& lo) {
  tf32_split(x.x, hi.x, lo.x);
  tf32_split(x.y, hi.y, lo.y);
  tf32_split(x.z, hi.z, lo.z);
  tf32_split(x.w, hi.w, lo.w);
}

// --- tensor maps (host) ----------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The encoder, with the current device's primary context made current on
// the calling thread: libcuda refuses a map on a thread with no current
// context.  Such a thread is one whose CUDA runtime calls so far needed
// none, as PyTorch's autograd device thread is when a backward is its
// first CUDA work (device 0 is already the current device, so PyTorch
// skips cudaSetDevice, and its allocations come from the caching
// allocator's free blocks).  cudaSetDevice binds the primary context.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_LAZY | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_LAZY);
    return lib ? reinterpret_cast<EncodeTiled>(
                     dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess) cudaSetDevice(dev);
  return fn;
}

// A 3-d bf16 (or `dtype`) tensor map with the 128-byte swizzle: dims
// innermost first, strides in bytes of dims 1 and 2 (multiples of 16), a
// box of (box0, box1, 1) elements with box0 elements <= 128 bytes.
// Returns 0 or an ERR_* code.
inline int tensor_map_3d(
    CUtensorMap* map, const void* base, uint64_t d0, uint64_t d1,
    uint64_t d2, uint64_t stride1, uint64_t stride2, uint32_t box0,
    uint32_t box1,
    CUtensorMapDataType dtype = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {stride1, stride2};
  const cuuint32_t box[3] = {box0, box1, 1};
  const cuuint32_t estride[3] = {1, 1, 1};
  const CUresult r =
      fn(map, dtype, 3, const_cast<void*>(base),
         dims, strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return map_result(r);
}

}  // namespace hopper
