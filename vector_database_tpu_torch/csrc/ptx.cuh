// PTX building blocks of the exact int8 scan (bucket_scan_i8.cu): warp-level
// s8 tensor-core products (mma.sync), shared-memory fragment loads
// (ldmatrix), asynchronous global-to-shared copies (cp.async) and a 4x4
// byte transpose. The TMA + wgmma kernels take theirs from sm90.cuh.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace vdb {

// D = A * B + D, s8 x s8 -> s32 (exact), one m16n8k32 tile per warp.
__device__ __forceinline__ void mma_16832_s8(int c[4], const uint32_t a[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// In place: byte j of word i becomes byte i of word j (4x4 transpose).
__device__ __forceinline__ void transpose_bytes(uint32_t& w0, uint32_t& w1,
                                                uint32_t& w2, uint32_t& w3) {
  const uint32_t t0 = __byte_perm(w0, w1, 0x5140);  // w0.b0 w1.b0 w0.b1 w1.b1
  const uint32_t t1 = __byte_perm(w0, w1, 0x7362);  // w0.b2 w1.b2 w0.b3 w1.b3
  const uint32_t t2 = __byte_perm(w2, w3, 0x5140);
  const uint32_t t3 = __byte_perm(w2, w3, 0x7362);
  w0 = __byte_perm(t0, t2, 0x5410);  // w0.b0 w1.b0 w2.b0 w3.b0
  w1 = __byte_perm(t0, t2, 0x7632);
  w2 = __byte_perm(t1, t3, 0x5410);
  w3 = __byte_perm(t1, t3, 0x7632);
}

}  // namespace vdb
