// A/B probe of the bucketed scan: four variants that split its time
// between streaming the blocks, the tensor-core products and the epilogue.
//
// Replaces the TPU probe kernel make(mode).kern of
// benchmarks/probe_kernel_ab.py (:26, called at :97). MODE, a compile-time
// constant, selects what each [q_tile, m] slice of a block does:
//   FULL    the older scan's epilogue per slice j of block b:
//           acc = min(acc, (bits(vn - 2 q.v + qn) & keep) | (b*w + j))
//   NOEPI   the products and an int32 min of their bits, no epilogue
//   NODOT   the FULL epilogue on q.v := vn * 1.0001, no products, as
//           XLA compiles it: 2 * 1.0001 folds and vn - vn * 2.0002 rounds
//           once (a fused multiply-add)
//   DMAONLY the blocks stream; once per block acc = min(acc, bits(vn))
//           over the first slice's norm row
// (acc is an int32 running min; vb, q bf16, vn, qn f32; keep clears the
// low `bits` bits.) The f32 epilogue uses the round-to-nearest intrinsics,
// so each step rounds as written and the compiler contracts nothing.
//
// What bounds it: the serving scan's bounds (bucket_scan_sm90.cu), since
// it runs the serving scan's skeleton unchanged (sm90.cuh: a TMA ring of
// [KC][64] bf16 tiles, the database as the MN-major A operand of wgmma,
// two consumer warpgroups of up to 128 query rows, the same walk over
// blocks, slices and K chunks). At the probe's default shape (10M rows,
// 1024 queries, d_pad 128) its products are 2.6 TFLOP, 2.65 ms at the bf16
// peak. In NODOT and DMAONLY the ring still streams every tile; the
// consumers wait, read the norms, release the stage and issue no wgmma. A
// thread's accumulator covers NQ / 4 query rows, whose qn come from an [R]
// f32 tile that TMA loads with the query tile. What it does about its
// bounds: nothing beyond the serving scan's design; it is a measurement of
// that design, not a serving path.

#include "sm90.cuh"

namespace {

using namespace sm90;

enum Mode { FULL = 0, NOEPI = 1, NODOT = 2, DMAONLY = 3 };

template <int MODE, int NQ, int KC>
__global__ void __launch_bounds__(THREADS, 1)
probe_kernel(const __grid_constant__ CUtensorMap tm_vb,
             const __grid_constant__ CUtensorMap tm_q,
             const __grid_constant__ CUtensorMap tm_vn,
             const __grid_constant__ CUtensorMap tm_qn,
             int* __restrict__ out, int nb,
             int d_pad, int block, int m, int bits, int q_pad, int cpg,
             int stages) {
  constexpr bool DOT = MODE == FULL || MODE == NOEPI;
  constexpr int R = 2 * NQ;
  constexpr int NACC = NQ / 2;
  extern __shared__ unsigned char smem_raw[];
  const Smem sm = carve(smem_raw, d_pad, R, KC * MT * 2, stages, R);
  const Rows rw = cta_rows(R, q_pad, q_pad, cpg);
  const int c0 = blockIdx.y * MT;
  const Walk wk = walk(nullptr, nb, block, m, d_pad, KC);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) init_barriers(sm, stages);
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0)
      produce<R, KC, OPS_BF16>(sm, &tm_vb, &tm_q, &tm_vn, &tm_qn, wk, d_pad,
                               rw.row0, c0, m, stages);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1;
    const int t = threadIdx.x % 128;
    const int warp = t / 32, g = (t % 32) / 4, tq = t % 4;
    const int keep = (int)~((1u << bits) - 1u);
    int acc[NACC];
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0x7fffffff;
    // the query norms of acc[4i + e]: row c * NQ + 8i + 2 tq (+1, odd e)
    const float* qrow = sm.qns + c * NQ + 2 * tq;

    consume<NQ, KC, OPS_BF16, DOT>(
        sm, wk, c, stages,
        [&](const float (&prod)[NACC], float v0, float v1, int b, int j) {
          const int id = b * wk.w + j;
#pragma unroll
          for (int i = 0; i < NACC / 4; ++i) {
            const float2 qn = *reinterpret_cast<const float2*>(qrow + 8 * i);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int x = 4 * i + e;
              const float v = (e & 2) ? v1 : v0;
              const float qr = (e & 1) ? qn.y : qn.x;
              if constexpr (MODE == FULL) {
                const float d2 =
                    __fadd_rn(__fsub_rn(v, __fmul_rn(2.f, prod[x])), qr);
                acc[x] = min(acc[x], (__float_as_int(d2) & keep) | id);
              } else if constexpr (MODE == NOEPI) {
                acc[x] = min(acc[x], __float_as_int(prod[x]));
              } else if constexpr (MODE == NODOT) {
                const float d2 =
                    __fadd_rn(__fmaf_rn(v, -(2.f * 1.0001f), v), qr);
                acc[x] = min(acc[x], (__float_as_int(d2) & keep) | id);
              } else if (j == 0) {
                acc[x] = min(acc[x], __float_as_int(v));
              }
            }
          }
        });

    // a tail CTA's columns >= m stay unwritten
    const int cols[2] = {c0 + tile_col<OPS_BF16>(warp, g, 0),
                         c0 + tile_col<OPS_BF16>(warp, g, 1)};
#pragma unroll
    for (int i = 0; i < NACC / 4; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = c * NQ + 8 * i + 2 * tq + (e & 1);
        if (r < rw.rows && cols[e >> 1] < m)
          out[(size_t)(rw.row0 + r) * m + cols[e >> 1]] = acc[4 * i + e];
      }
    }
  }
}

struct Args {
  CUtensorMap tm_vb, tm_q, tm_vn, tm_qn;
  int* out;
  int nb, d_pad, block, m, bits, q_pad, stages;
  size_t smem;
  cudaStream_t stream;
};

template <int MODE, int NQ, int KC>
int launch(const Args& a) {
  cudaError_t err = cudaFuncSetAttribute(
      probe_kernel<MODE, NQ, KC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)a.smem);
  if (err != cudaSuccess) return (int)err;
  const int cpg = (a.q_pad + 2 * NQ - 1) / (2 * NQ);
  dim3 grid(cpg, (a.m + MT - 1) / MT);
  probe_kernel<MODE, NQ, KC><<<grid, THREADS, a.smem, a.stream>>>(
      a.tm_vb, a.tm_q, a.tm_vn, a.tm_qn, a.out, a.nb, a.d_pad, a.block, a.m,
      a.bits, a.q_pad, cpg, a.stages);
  return (int)cudaGetLastError();
}

template <int MODE, int NQ>
int launch_kc(const Args& a, int kc) {
  switch (kc) {
    case 256: return launch<MODE, NQ, 256>(a);
    case 128: return launch<MODE, NQ, 128>(a);
    case 64: return launch<MODE, NQ, 64>(a);
    case 32: return launch<MODE, NQ, 32>(a);
    case 16: return launch<MODE, NQ, 16>(a);
  }
  return (int)cudaErrorInvalidValue;
}

template <int MODE>
int launch_nq(const Args& a, int nq, int kc) {
  switch (nq) {
    case 128: return launch_kc<MODE, 128>(a, kc);
    case 64: return launch_kc<MODE, 64>(a, kc);
    case 32: return launch_kc<MODE, 32>(a, kc);
    case 16: return launch_kc<MODE, 16>(a, kc);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Shared memory of a plan: the serving scan's for bf16 tiles, plus the
// [2 nq] f32 query norms.
size_t probe_kernel_ab_smem_bytes(int nq, int d_pad, int kc, int stages) {
  return smem_bytes(2 * nq, d_pad, kc * MT * 2, stages, 2 * nq);
}

// mode: 0 full, 1 noepi, 2 nodot, 3 dmaonly. bf16 vb [nb, d_pad, block],
// f32 vn [nb, 1, block], both contiguous with block % 8 == 0 (rows on
// 16-byte boundaries), bf16 q [q_pad, d_pad], f32 qn [q_pad]; out [q_pad,
// m] int32. nq in {16, 32, 64, 128}; kc in {16, ..., 256} divides d_pad;
// block % m == 0. Returns a CUDA error code
// (CUDA_ERROR_* + 10000 for the tensor-map encoder; cudaErrorInvalidValue
// for an unknown mode), 0 on success.
int probe_kernel_ab_launch(int mode, const void* vn, const void* vb,
                           const void* q, const void* qn, void* out, int nb,
                           int d_pad, int block, int m, int bits, int q_pad,
                           int nq, int kc, int stages, void* stream) {
  if (!encode_fn()) return (int)cudaErrorNotSupported;
  Args a;
  CUresult res = encode_vb(&a.tm_vb, vb, nb, d_pad, block, block, kc, 2);
  if (res != CUDA_SUCCESS) return 10000 + (int)res;
  res = encode_q(&a.tm_q, q, q_pad, d_pad, 2 * nq);
  if (res != CUDA_SUCCESS) return 10000 + (int)res;
  res = encode_vn(&a.tm_vn, vn, nb, block, block);
  if (res != CUDA_SUCCESS) return 10000 + (int)res;
  // qn as a 1-D tensor in boxes of R: rows past q_pad read 0
  const cuuint64_t qdim[1] = {(cuuint64_t)q_pad};
  const cuuint64_t no_stride[1] = {0};
  const cuuint32_t qbox[1] = {(cuuint32_t)(2 * nq)};
  const cuuint32_t one[1] = {1};
  res = encode_fn()(&a.tm_qn, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1,
                    const_cast<void*>(qn), qdim, no_stride, qbox, one,
                    CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                    CU_TENSOR_MAP_L2_PROMOTION_NONE,
                    CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return 10000 + (int)res;
  a.out = static_cast<int*>(out);
  a.nb = nb, a.d_pad = d_pad, a.block = block, a.m = m, a.bits = bits;
  a.q_pad = q_pad, a.stages = stages;
  a.smem = probe_kernel_ab_smem_bytes(nq, d_pad, kc, stages);
  a.stream = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case FULL: return launch_nq<FULL>(a, nq, kc);
    case NOEPI: return launch_nq<NOEPI>(a, nq, kc);
    case NODOT: return launch_nq<NODOT>(a, nq, kc);
    case DMAONLY: return launch_nq<DMAONLY>(a, nq, kc);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
