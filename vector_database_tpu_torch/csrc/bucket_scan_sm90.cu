// Bucketed k-NN scan over a packed database on Hopper: the serving hot
// path, for bf16 packs and int8f packs (int8 storage, bf16 scoring).
//
// Replaces the three float-scoring TPU kernels of
// vector_database_tpu/ops/pallas_knn.py, both their bf16 and their
// int8-storage branches:
//   _kernel            (pallas_knn.py:130)  full scan
//   _kernel_pruned     (pallas_knn.py:203)  static block map
//   _kernel_pruned_rt  (pallas_knn.py:274)  block map + runtime probe count
// A null block map selects the full scan; a map plus a runtime `nprobe`
// serves both pruned kernels (the static one is the rt one with
// nprobe == map width).
//
// What it computes, for every query row r and bucket c in [0, m):
//   acc[r, c] = min over blocks b of
//               enc(min over slices j < w = block/m of
//                   vn[b, j*m + c] + q[r, :] . vb[b, :, j*m + c], b)
//   enc(x, b) = bits(x) with its low `bits` bits replaced by b
// A bf16 pack holds -2v in bf16, an int8f pack -v*sq in int8 with its
// queries pre-scaled by 2/sq; vn holds |v|^2 in f32, so the score is
// |v|^2 - 2 q.v. Products are bf16 x bf16 (int8 widened exactly, |x| <=
// 127) with f32 accumulation, in the same K order for both packs.
//
// What bounds it on an H100, and what the design does about it. At the
// main shape (10M x 96 padded to d_pad 128, q = 4096, 1221 blocks of 8192
// rows, m = 4096) four facts set the work:
//  1. Products: 2 * 4096 * 10,002,432 * 128 = 10.49 TFLOP a full batch,
//     10.6 ms at the bf16 peak of 989 TFLOP/s, for both packs. Only
//     wgmma, issued by a whole warpgroup, reaches that rate (mma.sync does
//     not), so every product here is a wgmma.
//  2. Staging: the bytes that cross from L2 into shared memory are
//     (q_pad / R) x the pack's blocks, R the query rows that share one
//     staged tile. At R = 64 (the first port) that was 164 GB for bf16,
//     ~34 ms at the ~4.8 TB/s the A/B probe saw; at R = 256 it is 41 GB
//     (bf16) or 20.5 GB (int8), under the products' time. So a CTA holds
//     R = 256 query rows (two consumer warpgroups of 128) against each
//     64-column vb tile (sm90.cuh: the ring, the walk, both warpgroups).
//  3. Registers: each output element needs its product and its running
//     minimum. enc(., b) is monotone non-decreasing for a fixed b, so
//     min_j enc(s_j, b) == enc(min_j s_j, b) bit for bit (signed zeros
//     aside; a score here is never -0 because vn >= +0), and each slice
//     folds into the minimum directly: no per-slice minima. A warpgroup's
//     64 x 128 tile costs 64 + 64 registers a thread.
//  4. Epilogue ALU: ~3 operations per (query, row, slice) (add vn, mask-or
//     the id, min): ~1.2e11 lane-ops, 4-7 ms. The two consumer
//     warpgroups run unsynchronised with each other, so one's epilogue
//     overlaps the other's products on the shared tensor cores. (On the
//     card, forcing strict turns between them with named barriers, or
//     double-buffering the products inside a warpgroup so its next
//     wgmmas run under its own epilogue, were both slower.)
// The database is the wgmma M side and the queries its N side, so a
// thread's accumulator rows are bucket columns and one slice's vn costs
// it 2 floats; the query tile is the K-major B operand. With the
// contraction loop unrolled (KC is a template parameter) ptxas keeps the
// wgmmas back to back.
//   bf16 tiles are [KC][64] with the 64 bucket columns contiguous: the
//   MN-major ("transposed") A operand of a bf16 wgmma, from 128-byte-
//   swizzled TMA boxes. A m64n128k16 then reads 6 KB of shared memory per
//   64 tensor-core cycles (96 B/clk, under the SM's 128) where queries as
//   M with N = 64 would read 4 KB per 32 (128 B/clk). The bf16 kernel
//   reaches about half of the products' bound on the card (PERF.md of the
//   repository).
//   int8 tiles are [KC][64] bytes through TMA's 64-byte swizzle, and each
//   consumer thread builds its own A fragments in registers (A from
//   registers, sm90.cuh: int8_fragments): one transposed ldmatrix per two
//   k16 steps, then two masks and one bf16x2 add per two values widen
//   them exactly. It releases the stage before its wgmmas run: no
//   widening pass through shared memory, no second buffer, no extra
//   barrier. A k16 step then moves 11 KB of shared memory for a CTA (TMA
//   1 KB, fragment loads 2 x 1 KB, B 2 x 4 KB) where the bf16 tile's moves
//   14 KB. (The fallback, the producer warpgroup widening each stage into
//   a bf16 ring, would move ~16 KB a step.) KC is at most 128 for int8: a
//   stage's fragments are then 32 registers a thread, next to 64 products
//   and 64 minima. What bounds the int8 route on the card is the fragment
//   work itself: with it removed the kernel runs at the bf16 kernel's
//   time, and with it (~116 instructions a stage on every consumer
//   thread, which both warpgroups repeat) about a quarter slower,
//   whether or not the next stage's fragments are built under the
//   current stage's wgmmas; so the cost is issue slots shared with the
//   other warpgroup's epilogue, not latency (PERF.md of the repository).
// Every instantiation is meant to compile to 168 registers a thread (the
// cap for 384 threads; setmaxnreg then moves the producer to 40 and the
// consumers to 232) with no spills.
//
// Block map contract: a CTA covers up to R rows inside ONE group of
// q_tile rows (grid.x = groups * ceil(q_tile / R)); the tail of a group is
// computed on whatever rows follow and never written. It walks
// bmap[group, :nprobe].

#include "sm90.cuh"

namespace {

using namespace sm90;

// NQ: query rows per consumer warpgroup (the wgmma N); R = 2 * NQ. KC:
// contraction rows per staged tile, so a stage's wgmmas unroll fully.
// ESIZE: bytes of a vb element, 2 (bf16) or 1 (int8).
template <int NQ, int KC, int ESIZE>
__global__ void __launch_bounds__(THREADS, 1)
bucket_scan_sm90_kernel(const __grid_constant__ CUtensorMap tm_vb,
                        const __grid_constant__ CUtensorMap tm_q,
                        const float* __restrict__ vn,
                        const int* __restrict__ bmap,
                        float* __restrict__ out, int nb, int d_pad,
                        int block, int m, int bits, int q_pad, int q_tile,
                        int cpg, int pmax, int nprobe, int stages) {
  constexpr int R = 2 * NQ;
  constexpr int NACC = NQ / 2;  // f32 accumulator registers a thread
  extern __shared__ unsigned char smem_raw[];
  const Smem sm = carve(smem_raw, d_pad, R, KC * MT * ESIZE, stages, 0);
  const Rows rw = cta_rows(R, q_pad, q_tile, cpg);
  const int c0 = blockIdx.y * MT;
  const Walk wk = walk(bmap ? bmap + (size_t)rw.group * pmax : nullptr,
                       bmap ? nprobe : nb, block, m, d_pad, KC);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) init_barriers(sm, stages);
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0)
      produce<R, KC, ESIZE>(sm, &tm_vb, &tm_q, nullptr, vn, wk, d_pad,
                            rw.row0, c0, block, m, stages);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1;
    const unsigned keep = ~((1u << bits) - 1u);
    float acc[NACC];
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 3.0e38f;

    consume<NQ, KC, ESIZE, true>(
        sm, wk, c, stages,
        [&](const float (&prod)[NACC], float v0, float v1, int p, int) {
          // score = |v|^2 + q.(-2v); the block id rides the low bits
          const unsigned b = wk.block(p);
#pragma unroll
          for (int i = 0; i < NACC; ++i) {
            const float x = prod[i] + ((i & 2) ? v1 : v0);
            acc[i] = fminf(
                acc[i], __uint_as_float((__float_as_uint(x) & keep) | b));
          }
        });

    // acc[4i + e]: bucket column c0 + tile_col(warp, g, e >= 2), query row
    // c * NQ + 8i + 2 tq (+1 for odd e)
    const int t = threadIdx.x % 128;
    const int warp = t / 32, g = (t % 32) / 4, tq = t % 4;
#pragma unroll
    for (int i = 0; i < NACC / 4; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = c * NQ + 8 * i + 2 * tq + (e & 1);
        if (r < rw.rows)
          out[(size_t)(rw.row0 + r) * m + c0 +
              tile_col<ESIZE>(warp, g, e >> 1)] = acc[4 * i + e];
      }
    }
  }
}

// ---- host side ---------------------------------------------------------

struct Args {
  CUtensorMap tm_vb, tm_q;
  const float* vn;
  const int* bmap;
  float* out;
  int nb, d_pad, block, m, bits, q_pad, q_tile, pmax, nprobe, stages;
  size_t smem;
  cudaStream_t stream;
};

template <int NQ, int KC, int ESIZE>
int launch(const Args& a) {
  cudaError_t err = cudaFuncSetAttribute(
      bucket_scan_sm90_kernel<NQ, KC, ESIZE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.smem);
  if (err != cudaSuccess) return (int)err;
  const int cpg = (a.q_tile + 2 * NQ - 1) / (2 * NQ);
  dim3 grid((a.q_pad / a.q_tile) * cpg, a.m / MT);
  bucket_scan_sm90_kernel<NQ, KC, ESIZE>
      <<<grid, THREADS, a.smem, a.stream>>>(
          a.tm_vb, a.tm_q, a.vn, a.bmap, a.out, a.nb, a.d_pad, a.block,
          a.m, a.bits, a.q_pad, a.q_tile, cpg, a.pmax, a.nprobe, a.stages);
  return (int)cudaGetLastError();
}

template <int NQ, int ESIZE>
int launch_kc(const Args& a, int kc) {
  switch (kc) {
    case 256:
      if constexpr (ESIZE == 2) return launch<NQ, 256, ESIZE>(a);
      break;
    case 128: return launch<NQ, 128, ESIZE>(a);
    case 64: return launch<NQ, 64, ESIZE>(a);
    case 32: return launch<NQ, 32, ESIZE>(a);
    case 16: return launch<NQ, 16, ESIZE>(a);
  }
  return (int)cudaErrorInvalidValue;
}

template <int ESIZE>
int launch_nq(const Args& a, int nq, int kc) {
  switch (nq) {
    case 128: return launch_kc<128, ESIZE>(a, kc);
    case 64: return launch_kc<64, ESIZE>(a, kc);
    case 32: return launch_kc<32, ESIZE>(a, kc);
    case 16: return launch_kc<16, ESIZE>(a, kc);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Shared memory of a plan (nq query rows per consumer warpgroup, kc-row
// contraction chunks of esize-byte elements, a ring of `stages`): the
// wrapper's plan function computes the same sum.
size_t bucket_scan_sm90_smem_bytes(int nq, int d_pad, int kc, int stages,
                                   int esize) {
  return smem_bytes(2 * nq, d_pad, kc * MT * esize, stages, 0);
}

// vb [nb, d_pad, block] bf16 (esize 2) or int8 (esize 1), f32 vn [nb, 1,
// block], bf16 q [q_pad, d_pad], optional int32 bmap [q_pad / q_tile,
// pmax]; out [q_pad, m] f32. nq in {16, 32, 64, 128}; kc in {16, 32, 64,
// 128, 256} (at most 128 for int8) divides d_pad; m % 64 == 0, block % m
// == 0; q_tile divides q_pad (q_tile = q_pad for the full scan). Returns a
// CUDA error code (CUDA_ERROR_* + 10000 for the driver's tensor-map
// encoder), 0 on success.
int bucket_scan_sm90_launch(const void* vn, const void* vb, const void* q,
                            const void* bmap, void* out, int nb, int d_pad,
                            int block, int m, int bits, int q_pad,
                            int q_tile, int pmax, int nprobe, int nq, int kc,
                            int stages, int esize, void* stream) {
  if (!encode_fn()) return (int)cudaErrorNotSupported;
  if (esize != 1 && esize != 2) return (int)cudaErrorInvalidValue;
  Args a;
  CUresult res = encode_vb(&a.tm_vb, vb, nb, d_pad, block, kc, esize);
  if (res != CUDA_SUCCESS) return 10000 + (int)res;
  res = encode_q(&a.tm_q, q, q_pad, d_pad, 2 * nq);
  if (res != CUDA_SUCCESS) return 10000 + (int)res;
  a.vn = static_cast<const float*>(vn);
  a.bmap = static_cast<const int*>(bmap);
  a.out = static_cast<float*>(out);
  a.nb = nb, a.d_pad = d_pad, a.block = block, a.m = m, a.bits = bits;
  a.q_pad = q_pad, a.q_tile = q_tile, a.pmax = pmax, a.nprobe = nprobe;
  a.stages = stages;
  a.smem = bucket_scan_sm90_smem_bytes(nq, d_pad, kc, stages, esize);
  a.stream = static_cast<cudaStream_t>(stream);
  return esize == 2 ? launch_nq<2>(a, nq, kc) : launch_nq<1>(a, nq, kc);
}

}  // extern "C"
