// Exact integer bucketed k-NN scan over a pure-int8 pack, on the Hopper
// skeleton of sm90.cuh (its s8 route).
//
// Replaces the TPU kernel _kernel_i8 (vector_database_tpu/ops/pallas_knn.py
// :344, called at :983).
//
// What it computes, for every query row r and bucket c in [0, m), in int32:
//   scores[r, c] = min over blocks b and slices j < w = block/m of
//                  vn2[b, j*m + c] + qi[r, :] . vb[b, j*m + c, :]
//   ids[r, c]    = the first block, in walk order, that reached it
// vb holds -v*sq in int8, K-major ([nb, block, d_pad]: each block's rows
// as they lie), qi holds q*sq in int8 and vn2 = rint(|v|^2 sq^2 / 2), so a
// score is sq^2/2 times |v|^2 - 2 q.v up to the input quantization, and
// every product and sum is exact. Each slice folds straight into the
// running minimum, strictly, in walk order (block by block, slice by
// slice): x = prod + vn2; better = x < acc; acc = better ? x : acc;
// id = better ? b : id. The first (b, j) in walk order that reaches the
// global minimum belongs to the first block whose own minimum equals it,
// so this gives the reference's min over slices, then strict compare per
// block, bit for bit: a tie keeps the earlier block, as on the TPU.
//
// What bounds it on an H100, at the main shape (10M x 96 padded to d_pad
// 128, q = 4096, 1221 blocks of 8192 rows, m = 4096):
//  1. Products: 2 * 4096 * 10,002,432 * 128 = 10.49 T int8 operations a
//     full batch, 5.3 ms at the int8 peak of 1,979 T/s, which only wgmma
//     reaches. The blocks are 1.28 GB (0.4 ms of HBM), so bytes do not
//     bound it.
//  2. Staging: the bytes that cross from L2 into shared memory are
//     (q_pad / R) x the blocks; at R = 256 query rows a CTA that is
//     16 x 1.28 GB = 20.5 GB, under the products' time.
//  3. The epilogue: four integer operations per (query, row, slice) (add
//     the norm, compare, two selects), ~1.6e11 lane operations a batch;
//     three of them (compare, min, select) run on the integer pipe's 64
//     lanes a clock an SM. That is longer than the products, so it decides
//     the kernel's time, the more so where the two consumer warpgroups
//     fold at the same time instead of in turns (PERF.md, section 6).
// What the design does about it:
//  * The pure-int8 pack is K-major, so both operands of s8 wgmma
//    (m64nNk32, K-major only: s8 takes no transpose flags) come from shared
//    memory through descriptors: the database tile is A (64 bucket rows x
//    128 bytes of k, a [64][128] TMA box with 128-byte swizzle), the int8
//    query tile is B (R rows of 128-byte swizzled rows). No fragment work
//    and no byte transposes are left in the loop.
//  * The skeleton's ring, walk and warpgroups: a producer thread keeps an
//    8-deep TMA ring full; two consumer warpgroups of 128 query rows each
//    (R = 256) multiply every staged tile, unsynchronised with each other,
//    so one's epilogue overlaps the other's products on the tensor cores.
//  * Registers: a warpgroup's 64 x 128 tile is 64 products, 64 minima and
//    64 block ids a thread, 192 of the consumers' 232 (no per-slice minima:
//    the strict fold above needs none).
//  * Any m that divides block: grid.y is ceil(m / 64); a tail CTA stores
//    only its columns below m.

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int KC = 128;  // bytes of k a staged tile holds: one swizzled row

// NQ: query rows per consumer warpgroup (the wgmma N); R = 2 * NQ.
template <int NQ>
__global__ void __launch_bounds__(THREADS, 1)
bucket_scan_i8_kernel(const __grid_constant__ CUtensorMap tm_vb,
                      const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_vn,
                      int* __restrict__ out_s, int* __restrict__ out_b,
                      int nb, int d_pad, int block, int m, int q_pad, int cpg,
                      int stages) {
  constexpr int R = 2 * NQ;
  constexpr int NACC = NQ / 2;  // int32 products a thread
  extern __shared__ unsigned char smem_raw[];
  const Smem sm = carve(smem_raw, d_pad, R, KC * MT, stages, 0, 1);
  const Rows rw = cta_rows(R, q_pad, q_pad, cpg);
  const int c0 = blockIdx.y * MT;
  const Walk wk = walk(nullptr, nb, block, m, d_pad, KC);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) init_barriers(sm, stages);
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0)
      produce<R, KC, OPS_S8>(sm, &tm_vb, &tm_q, &tm_vn, nullptr, wk, d_pad,
                             rw.row0, c0, m, stages);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1;
    int acc[NACC], ids[NACC];
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      acc[i] = 0x7fffffff;
      ids[i] = 0;
    }

    consume<NQ, KC, OPS_S8, true>(
        sm, wk, c, stages,
        [&](const int (&prod)[NACC], int v0, int v1, int b, int) {
          // score = vn2 + qi.(-v sq); strict: a tie keeps the earlier block
#pragma unroll
          for (int i = 0; i < NACC; ++i) {
            const int x = prod[i] + ((i & 2) ? v1 : v0);
            const bool better = x < acc[i];
            acc[i] = better ? x : acc[i];
            ids[i] = better ? b : ids[i];
          }
        });

    // acc[4i + e]: bucket column c0 + tile_col(warp, g, e >= 2), query row
    // c * NQ + 8i + 2 tq (+1 for odd e); a tail CTA's columns >= m stay
    const int t = threadIdx.x % 128;
    const int warp = t / 32, g = (t % 32) / 4, tq = t % 4;
    const int cols[2] = {c0 + tile_col<OPS_S8>(warp, g, 0),
                         c0 + tile_col<OPS_S8>(warp, g, 1)};
#pragma unroll
    for (int i = 0; i < NACC / 4; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = c * NQ + 8 * i + 2 * tq + (e & 1);
        if (r < rw.rows && cols[e >> 1] < m) {
          const size_t o = (size_t)(rw.row0 + r) * m + cols[e >> 1];
          out_s[o] = acc[4 * i + e];
          out_b[o] = ids[4 * i + e];
        }
      }
    }
  }
}

// ---- host side ---------------------------------------------------------

struct Args {
  CUtensorMap tm_vb, tm_q, tm_vn;
  int* out_s;
  int* out_b;
  int nb, d_pad, block, m, q_pad, stages;
  size_t smem;
  cudaStream_t stream;
};

template <int NQ>
int launch(const Args& a) {
  cudaError_t err = cudaFuncSetAttribute(
      bucket_scan_i8_kernel<NQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)a.smem);
  if (err != cudaSuccess) return (int)err;
  const int cpg = (a.q_pad + 2 * NQ - 1) / (2 * NQ);
  dim3 grid(cpg, (a.m + MT - 1) / MT);
  bucket_scan_i8_kernel<NQ><<<grid, THREADS, a.smem, a.stream>>>(
      a.tm_vb, a.tm_q, a.tm_vn, a.out_s, a.out_b, a.nb, a.d_pad, a.block,
      a.m, a.q_pad, cpg, a.stages);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory of a plan (nq query rows per consumer warpgroup, a ring
// of `stages` [64][128 B] tiles, int8 queries): the wrapper's plan
// function computes the same sum.
size_t bucket_scan_i8_smem_bytes(int nq, int d_pad, int stages) {
  return smem_bytes(2 * nq, d_pad, KC * MT, stages, 0, 1);
}

// vb [nb, block, d_pad] int8 (K-major) with rows ld_vb bytes apart, int32
// vn [nb, 1, block] with rows ld_vn apart (each row stride a multiple of
// 16 bytes), int8 q [q_pad, d_pad] (d_pad % 16 == 0); out_s and out_b
// [q_pad, m] int32. nq in {16, 32, 64, 128}; block % m == 0. Returns a
// CUDA error code (CUDA_ERROR_* + 10000 for cuTensorMapEncodeTiled), 0
// on success.
int bucket_scan_i8_launch(const void* vn, const void* vb, const void* q,
                          void* out_s, void* out_b, int nb, int d_pad,
                          int block, int ld_vb, int ld_vn, int m, int q_pad,
                          int nq, int stages, void* stream) {
  if (!encode_fn()) return (int)cudaErrorNotSupported;
  Args a;
  CUresult res =
      encode_vb_kmajor(&a.tm_vb, vb, nb, d_pad, block, ld_vb, KC);
  if (res != CUDA_SUCCESS) return 10000 + (int)res;
  res = encode_q(&a.tm_q, q, q_pad, d_pad, 2 * nq, 1);
  if (res != CUDA_SUCCESS) return 10000 + (int)res;
  res = encode_vn(&a.tm_vn, vn, nb, block, ld_vn);
  if (res != CUDA_SUCCESS) return 10000 + (int)res;
  a.out_s = static_cast<int*>(out_s);
  a.out_b = static_cast<int*>(out_b);
  a.nb = nb, a.d_pad = d_pad, a.block = block, a.m = m, a.q_pad = q_pad;
  a.stages = stages;
  a.smem = bucket_scan_i8_smem_bytes(nq, d_pad, stages);
  a.stream = static_cast<cudaStream_t>(stream);
  switch (nq) {
    case 128: return launch<128>(a);
    case 64: return launch<64>(a);
    case 32: return launch<32>(a);
    case 16: return launch<16>(a);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
