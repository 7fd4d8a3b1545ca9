// The Hopper skeleton of the port's bucketed scans, shared by
// bucket_scan_sm90.cu (the serving scan, bf16 and int8f packs) and
// probe_kernel_ab.cu (the A/B probe that splits its time), so that the
// probe times the loop that serves.
//
// A CTA is three warpgroups: warpgroup 0 produces (one thread issues every
// TMA copy; the warpgroup gives its registers away with setmaxnreg), 1 and
// 2 consume, each multiplying its NQ query rows (R = 2 NQ a CTA) by every
// staged [KC][64] vb tile with wgmma. The database is the wgmma M side: a
// thread's accumulator rows are bucket columns, its columns query rows.
// This header holds the PTX wrappers (mbarriers, TMA and bulk copies, the
// 128-byte-swizzle matrix descriptor, wgmma with A from shared memory or
// from registers), the exact int8 -> bf16 widening, and the skeleton:
//   Smem       the shared-memory layout;
//   Walk       the order of the staged tiles: blocks, slices, K chunks;
//   produce()  the producer thread's loop over the ring;
//   consume()  a consumer warpgroup's loop, which hands each slice's
//              products and norms to the kernel's epilogue.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

constexpr int MT = 64;           // bucket columns per CTA (wgmma M)
constexpr int THREADS = 384;     // producer warpgroup + 2 consumers
constexpr int ROW_BYTES = 128;   // one swizzled query-tile row: 64 bf16

// ---- PTX wrappers ----------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"((uint64_t)map), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"((uint64_t)map), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// A shared-memory matrix descriptor with 128-byte swizzling: start
// address, leading and stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  uint64_t d = (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}

template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t a,
                                           uint64_t b, int scale_d);

// D[64 x N] (+)= A[64 x 16] * B[16 x N], bf16 in, f32 out; A MN-major
// (trans-a = 1), B K-major (trans-b = 0), both from shared memory.
template <>
__device__ __forceinline__ void wgmma_bf16<16>(float (&d)[8], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16<32>(float (&d)[16], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float (&d)[64], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// Keep the compiler from moving register traffic across a wgmma.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[N / 2],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int scale_d);

// D[64 x N] (+)= A[64 x 16] * B[16 x N], bf16 in, f32 out; A from
// registers (a: the m16n8k16 A fragment of rows 16 warp + g and + 8), B
// K-major (trans-b = 0) from shared memory.
template <>
__device__ __forceinline__ void wgmma_bf16_rs<16>(float (&d)[8],
                                                 const uint32_t (&a)[4],
                                                 uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16_rs<32>(float (&d)[16],
                                                 const uint32_t (&a)[4],
                                                 uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16_rs<64>(float (&d)[32],
                                                 const uint32_t (&a)[4],
                                                 uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16_rs<128>(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <int S>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[S][4]) {
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[s][i])::"memory");
}

__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map,
                                            int c0, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"((uint64_t)map), "r"(smem_addr(bar)), "r"(c0)
      : "memory");
}

// Four 8x8 matrices of 16-bit elements, transposed: lanes 8j..8j+7 give
// the addresses of matrix j's 16-byte rows, and lane (g = lane / 4,
// tq = lane % 4) receives r[j] = its elements at (row 2 tq, column g)
// (low half) and (row 2 tq + 1, column g).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// The same for two matrices (lanes 0..15 give the addresses), into r[0]
// and r[1].
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// The int8 values in bytes 0 and 2 of w -> a bf16 pair (byte 0 in the
// low half), exactly. With s a byte's sign bit and l its low seven bits,
// x = l - 128 s = (128 + l) - 128 (1 + s); 128 + l is the bf16 0x4300 | l
// and -128 (1 + s) the bf16 0xc300 | s << 7 (bit 7 is the exponent's
// lowest bit), so two masks and one bf16x2 multiply-add, exact because x
// is a bf16, widen two values.
__device__ __forceinline__ uint32_t s8x2_to_bf16x2(uint32_t w) {
  const uint32_t l = (w & 0x007f007fu) | 0x43004300u;
  const uint32_t s = (w & 0x00800080u) | 0xc300c300u;
  uint32_t x;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(x)
      : "r"(l), "r"(0x3f803f80u), "r"(s));  // l * 1.0 + s
  return x;
}

// ---- the skeleton ----------------------------------------------------

// Shared memory a CTA claims for `rows` query rows, a ring of `stages`
// tiles of `tile_bytes`, and `qn_rows` f32 query norms (the probe's; 0 for
// the scan): 1024 bytes of alignment slack, the query tile in 64-column
// boxes of 128-byte rows, the ring, the query norms, each stage's 64 f32
// norms, and the ring's full/empty barriers plus the query tile's. The
// Python plan (ops/bucket_scan.py, _smem_bytes) computes the same sum.
inline size_t smem_bytes(int rows, int d_pad, int tile_bytes, int stages,
                         int qn_rows) {
  const size_t nkq = (d_pad + 63) / 64;
  return 1024 + nkq * rows * ROW_BYTES + (size_t)stages * tile_bytes +
         (size_t)qn_rows * 4 + (size_t)stages * MT * 4 +
         (2 * (size_t)stages + 1) * 8;
}

struct Smem {
  unsigned char* qs;  // [nkq][rows][128 B], 128-byte swizzled
  unsigned char* bs;  // [stages][tile_bytes], 1024-byte aligned tiles
  float* qns;         // [qn_rows]
  float* vns;         // [stages][64]
  uint64_t* full;     // [stages]: the tile (and norms) landed
  uint64_t* empty;    // [stages]: the 8 consumer warps released it
  uint64_t* qbar;     // the query tile (and query norms) landed
};

__device__ __forceinline__ Smem carve(unsigned char* raw, int d_pad, int rows,
                                      int tile_bytes, int stages,
                                      int qn_rows) {
  Smem s;
  s.qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  s.bs = s.qs + (d_pad + 63) / 64 * rows * ROW_BYTES;
  s.qns = reinterpret_cast<float*>(s.bs + stages * tile_bytes);
  s.vns = s.qns + qn_rows;
  s.full = reinterpret_cast<uint64_t*>(s.vns + stages * MT);
  s.empty = s.full + stages;
  s.qbar = s.empty + stages;
  return s;
}

// One thread, before the CTA's __syncthreads.
__device__ __forceinline__ void init_barriers(const Smem& s, int stages) {
  for (int i = 0; i < stages; ++i) {
    mbar_init(&s.full[i], 1);
    mbar_init(&s.empty[i], 8);  // one arrival per consumer warp
  }
  mbar_init(s.qbar, 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// A CTA's query rows: up to R rows inside ONE group of q_tile rows
// (grid.x = groups * cpg, cpg = ceil(q_tile / R)); the tail of a group is
// computed on whatever rows follow and never written.
struct Rows {
  int group, row0, rows;
};

__device__ __forceinline__ Rows cta_rows(int R, int q_pad, int q_tile,
                                         int cpg) {
  Rows r;
  r.group = blockIdx.x / cpg;
  r.row0 = r.group * q_tile + (blockIdx.x % cpg) * R;
  r.rows = min(min(R, r.group * q_tile + q_tile - r.row0), q_pad - r.row0);
  return r;
}

// The staged tiles of a CTA in walk order: tile s is contraction chunk
// s % nk of slice (s / nk) % w of the p-th listed block, p = s / (nk w),
// which is map[p] (p itself for the full scan). Every block, slice and K
// step is walked in this order whatever the block map, so probes = nb
// equals the full scan and runtime probes equal static probes bit for bit.
struct Walk {
  const int* map;
  int w, nk, total;
  __device__ __forceinline__ int block(int p) const {
    return map ? map[p] : p;
  }
};

__device__ __forceinline__ Walk walk(const int* map, int count, int block,
                                     int m, int d_pad, int kc) {
  Walk k;
  k.map = map;
  k.w = block / m;
  k.nk = d_pad / kc;
  k.total = count * k.w * k.nk;
  return k;
}

// The producer thread: the query tile (and, with tm_qn, the probe's R
// query norms) once, then every tile of the walk through the ring: a
// [KC][64] box of ESIZE-byte elements from vb [nb, d_pad, block], and at a
// slice's last chunk the slice's 64 norms on the same barrier.
template <int R, int KC, int ESIZE>
__device__ __forceinline__ void produce(const Smem& sm,
                                        const CUtensorMap* tm_vb,
                                        const CUtensorMap* tm_q,
                                        const CUtensorMap* tm_qn,
                                        const float* vn, const Walk& wk,
                                        int d_pad, int row0, int c0,
                                        int block, int m, int stages) {
  constexpr int TILE = KC * MT * ESIZE;
  const int nkq = (d_pad + 63) / 64;
  mbar_expect_tx(sm.qbar, nkq * R * ROW_BYTES + (tm_qn ? R * 4 : 0));
  for (int kq = 0; kq < nkq; ++kq)
    tma_load_2d(sm.qs + kq * R * ROW_BYTES, tm_q, kq * 64, row0, sm.qbar);
  if (tm_qn) tma_load_1d(sm.qns, tm_qn, row0, sm.qbar);
  for (int s = 0; s < wk.total; ++s) {
    const int st = s % stages;
    mbar_wait(&sm.empty[st], ((s / stages) & 1) ^ 1);
    const int kci = s % wk.nk, pj = s / wk.nk;
    const int p = pj / wk.w, j = pj - p * wk.w;
    const int b = wk.block(p);
    const bool last = kci == wk.nk - 1;
    mbar_expect_tx(&sm.full[st], TILE + (last ? MT * 4 : 0));
    tma_load_3d(sm.bs + st * TILE, tm_vb, j * m + c0, kci * KC, b,
                &sm.full[st]);
    if (last)
      bulk_load(sm.vns + st * MT, vn + (size_t)b * block + j * m + c0,
                MT * 4, &sm.full[st]);
  }
}

// The bucket column (of the CTA's 64) that accumulator row g + 8h of warp
// `warp` stands for. A bf16 tile is the A operand as it lies (rows of the
// descriptor): 16 warp + g + 8h. An int8 tile is widened by the threads
// into register A fragments, whose rows the kernel assigns: 16 warp + 2g +
// h, so that one 16-bit element of the tile holds the bytes of both of a
// thread's rows at one k. The norm read and every store follow this map.
template <int ESIZE>
__device__ __forceinline__ int tile_col(int warp, int g, int h) {
  return ESIZE == 2 ? 16 * warp + g + 8 * h : 16 * warp + 2 * g + h;
}

// The wgmma A fragments of one staged int8 [KC][64] tile, widened to bf16.
// Read as 16-bit elements, a 64-byte tile row holds 32 column pairs, and
// the 16-byte chunk `warp` of 8 consecutive rows is an 8x8 matrix whose
// transposed load (ldmatrix .trans) gives lane (g, tq) the pair (16 warp +
// 2g, + 1) at k = 2 tq and 2 tq + 1: bytes (row g, k), (row g + 8, k),
// (row g, k + 1), (row g + 8, k + 1) of the m16n8k16 A layout, under
// tile_col. One x4 load covers two k16 steps: lane l addresses row k = l of
// them. The rows come through TMA's 64-byte swizzle (16-byte chunk c of row
// k at chunk c ^ ((k >> 1) & 3)), so a matrix's 8 rows fall on 32 distinct
// banks. a[s]: k16 step s, rows g and g + 8 at k = 16 s + 2 tq + {0, 1}
// (a[s][0], a[s][1]) and + {8, 9} (a[s][2], a[s][3]).
template <int KC>
__device__ __forceinline__ void int8_fragments(const unsigned char* tile,
                                               int warp, int lane,
                                               uint32_t (&a)[KC / 16][4]) {
  const uint32_t base = smem_addr(tile) + lane * 64 +
                        ((warp ^ ((lane >> 1) & 3)) << 4);
#pragma unroll
  for (int s = 0; s < KC / 16; s += 2) {
    uint32_t r[4];
    if constexpr (KC == 16)
      ldmatrix_x2_trans(r, base);
    else
      ldmatrix_x4_trans(r, base + s * 16 * 64);
#pragma unroll
    for (int i = 0; i < (KC == 16 ? 2 : 4); ++i) {
      // even bytes are row g's, odd bytes row g + 8's
      a[s + i / 2][2 * (i % 2)] = s8x2_to_bf16x2(r[i]);
      a[s + i / 2][2 * (i % 2) + 1] = s8x2_to_bf16x2(r[i] >> 8);
    }
  }
}

// Consumer warpgroup c (0 or 1; query rows [c NQ, c NQ + NQ) of the CTA).
// For each staged tile of the walk: wait for it, multiply it into prod
// (64 bucket columns x NQ query rows, f32; K in 16-deep steps, the sum
// restarting at a slice's first chunk), release the stage, and at a
// slice's last chunk call epi(prod, v0, v1, p, j) with the norms of this
// thread's two bucket columns (rows g and g + 8 of prod, tile_col) and the
// slice's place in the walk (listed block p, slice j).
//   ESIZE 2: A is the bf16 tile through the transposed (MN-major) A
//     descriptor; the stage is released once the products have landed.
//   ESIZE 1: each thread widens its A fragments from the int8 tile into
//     registers, reads the norms and releases the stage before issuing
//     the wgmmas (A in registers, B the same query descriptor).
//   DOT false (the probe's nodot and dmaonly modes, bf16): no products;
//     the tiles still stream, and prod is left unset.
template <int NQ, int KC, int ESIZE, bool DOT, class Epi>
__device__ __forceinline__ void consume(const Smem& sm, const Walk& wk,
                                        int c, int stages, Epi&& epi) {
  static_assert(ESIZE == 2 || DOT, "int8 tiles are always multiplied");
  constexpr int R = 2 * NQ, TILE = KC * MT * ESIZE;
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32, g = lane / 4;
  const int col0 = tile_col<ESIZE>(warp, g, 0);
  const int col1 = tile_col<ESIZE>(warp, g, 1);
  // B: this warpgroup's NQ query rows of the 64-column box holding k,
  // advanced 2 bytes per column inside the swizzled row
  auto db = [&](int k) {
    return sw128_desc(sm.qs + ((k / 64) * R + c * NQ) * ROW_BYTES +
                          (k % 64) * 2,
                      16, 1024);
  };
  float prod[NQ / 2];

  mbar_wait(sm.qbar, 0);
  for (int s = 0; s < wk.total; ++s) {
    const int st = s % stages;
    const int kci = s % wk.nk, pj = s / wk.nk;
    const bool last = kci == wk.nk - 1;
    mbar_wait(&sm.full[st], (s / stages) & 1);
    const unsigned char* tile = sm.bs + st * TILE;
    uint32_t a[KC / 16][4];
    if constexpr (ESIZE == 2 && DOT) {
      fence_regs(prod);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        // A: 16 rows of the [KC][64] tile; 8-row groups 1024 B apart
        // (both offsets set: only one 64-column pattern is read)
        const uint64_t da = sw128_desc(tile + kk * ROW_BYTES, 1024, 1024);
        wgmma_bf16<NQ>(prod, da, db(kci * KC + kk), kci > 0 || kk > 0);
      }
      wgmma_commit_and_wait();
      fence_regs(prod);
    } else if constexpr (ESIZE == 1) {
      int8_fragments<KC>(tile, warp, lane, a);
    }
    float v0 = 0.f, v1 = 0.f;
    if (last) {
      v0 = sm.vns[st * MT + col0];
      v1 = sm.vns[st * MT + col1];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[st]);  // the stage may refill
    if constexpr (ESIZE == 1) {
      // registers written for A are fenced before the wgmmas that read
      // them, and kept until those have completed
      fence_regs(a);
      fence_regs(prod);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16)
        wgmma_bf16_rs<NQ>(prod, a[kk / 16], db(kci * KC + kk),
                          kci > 0 || kk > 0);
      wgmma_commit_and_wait();
      fence_regs(prod);
      fence_regs(a);
    }
    if (last) {
      const int p = pj / wk.w;
      epi(prod, v0, v1, p, pj - p * wk.w);
    }
  }
}

// ---- host side -------------------------------------------------------

inline PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (!fn) {
    cudaDriverEntryPointQueryResult q;
    void* p = nullptr;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// vb [nb, d_pad, block] of ESIZE-byte elements in [kc][64] boxes, the
// bucket columns innermost: 128-byte swizzle for bf16 (the layout the A
// descriptor reads), 64-byte for int8 (conflict-free fragment loads).
inline CUresult encode_vb(CUtensorMap* map, const void* vb, int nb, int d_pad,
                          int block, int kc, int esize) {
  const cuuint64_t dim[3] = {(cuuint64_t)block, (cuuint64_t)d_pad,
                             (cuuint64_t)nb};
  const cuuint64_t stride[2] = {(cuuint64_t)block * esize,
                                (cuuint64_t)d_pad * block * esize};
  const cuuint32_t box[3] = {(cuuint32_t)MT, (cuuint32_t)kc, 1};
  const cuuint32_t ones[3] = {1, 1, 1};
  return encode_fn()(
      map,
      esize == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
      3, const_cast<void*>(vb), dim, stride, box, ones,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      esize == 2 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// q [q_pad, d_pad] bf16 in [rows][64] boxes, 128-byte swizzle (the K-major
// B descriptor's layout); rows past q_pad and columns past d_pad read 0.
inline CUresult encode_q(CUtensorMap* map, const void* q, int q_pad,
                         int d_pad, int rows) {
  const cuuint64_t dim[2] = {(cuuint64_t)d_pad, (cuuint64_t)q_pad};
  const cuuint64_t stride[1] = {(cuuint64_t)d_pad * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)rows};
  const cuuint32_t ones[2] = {1, 1};
  return encode_fn()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                     const_cast<void*>(q), dim, stride, box, ones,
                     CU_TENSOR_MAP_INTERLEAVE_NONE,
                     CU_TENSOR_MAP_SWIZZLE_128B,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace sm90
