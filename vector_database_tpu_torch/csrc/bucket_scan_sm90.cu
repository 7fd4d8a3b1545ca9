// Bucketed k-NN scan over a bf16 packed database, redesigned for Hopper:
// the serving hot path.
//
// Replaces the three float-scoring TPU kernels of
// vector_database_tpu/ops/pallas_knn.py on bf16 packs:
//   _kernel            (pallas_knn.py:130)  full scan
//   _kernel_pruned     (pallas_knn.py:203)  static block map
//   _kernel_pruned_rt  (pallas_knn.py:274)  block map + runtime probe count
// A null block map selects the full scan; a map plus a runtime `nprobe`
// serves both pruned kernels (the static one is the rt one with
// nprobe == map width). The int8f packs keep their own kernel in
// bucket_scan.cu.
//
// What it computes, for every query row r and bucket c in [0, m):
//   acc[r, c] = min over blocks b of
//               enc(min over slices j < w = block/m of
//                   vn[b, j*m + c] + q[r, :] . vb[b, :, j*m + c], b)
//   enc(x, b) = bits(x) with its low `bits` bits replaced by b
// vb holds -2v in bf16 ([nb, d_pad, block]), vn holds |v|^2 in f32, so the
// score is |v|^2 - 2 q.v. Products are bf16 x bf16 with f32 accumulation.
//
// What bounds it on an H100, and what the design does about it. At the
// main shape (10M x 96 padded to d_pad 128, q = 4096, 1221 blocks of 8192
// rows, m = 4096) four facts set the work:
//  1. Products: 2 * 4096 * 10,002,432 * 128 = 10.49 TFLOP a full batch,
//     10.6 ms at the bf16 peak of 989 TFLOP/s. Only wgmma, issued by a
//     whole warpgroup, reaches that rate (mma.sync does not), so every
//     product here is a wgmma.
//  2. Staging: the bytes that cross from L2 into shared memory are
//     (q_pad / R) x 2.56 GB, R the query rows that share one staged vb
//     tile. At R = 64 (the first port) that was 164 GB, ~34 ms at the
//     ~4.8 TB/s the A/B probe saw; at R = 256 it is 41 GB, ~8.5 ms, under
//     the products' time. So a CTA holds R = 256 query rows (two consumer
//     warpgroups of 128) against each 64-column vb tile.
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
// The database is the wgmma M side and the queries its N side: vb tiles
// are [KC][64] with the 64 bucket columns contiguous (the MN-major,
// "transposed" A operand of a bf16 wgmma, from 128-byte-swizzled TMA
// boxes), the query tile is K-major B. That way a thread's accumulator
// rows are bucket columns and one slice's vn costs it 2 floats, and a
// m64n128k16 reads 6 KB of shared memory per 64 tensor-core cycles (96
// B/clk, under the SM's 128) where queries as M with N = 64 would read 4
// KB per 32 (128 B/clk). With the contraction loop unrolled (KC is a
// template parameter) ptxas keeps the wgmmas back to back. The kernel
// compiles to 168 registers a thread (the cap for 384 threads; setmaxnreg
// then moves the producer to 40 and the consumers to 232), no spills.
// It reaches about half of the products' bound on the card (PERF.md of
// the repository); both warpgroups read their operands from shared
// memory at 96 B/clk next to the TMA writes, which is the suspect for the
// rest, not yet measured apart.
//
// Structure: warpgroup 0 is the producer (one thread issues every TMA
// copy; the warpgroup gives its registers away with setmaxnreg), 1 and 2
// are consumers. The query tile [R, d_pad] is loaded once per CTA by TMA.
// vb tiles stream through a ring of >= 4 stages with full/empty
// mbarriers; each slice's 64 norm values ride the barrier of its last
// contraction chunk (cp.async.bulk). A consumer waits for a stage, issues
// its wgmmas (K in 16-deep steps, chunks of KC <= 256 rows), waits for
// them, releases the stage, then folds the products into its minima.
// Every block, slice and K step is walked in the same order whatever the
// block map, so probes = nb equals the full scan and runtime probes equal
// static probes bit for bit.
//
// Block map contract: a CTA covers up to R rows inside ONE group of
// q_tile rows (grid.x = groups * ceil(q_tile / R)); the tail of a group is
// computed on whatever rows follow and never written. It walks
// bmap[group, :nprobe].

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MT = 64;           // bucket columns per CTA (wgmma M)
constexpr int THREADS = 384;     // producer warpgroup + 2 consumers
constexpr int ROW_BYTES = 128;   // one swizzled smem row: 64 bf16

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

// ---- the kernel ------------------------------------------------------

// NQ: query rows per consumer warpgroup (the wgmma N); R = 2 * NQ. KC:
// contraction rows per staged tile, so a stage's wgmmas unroll fully.
template <int NQ, int KC>
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
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int nkq = (d_pad + 63) / 64;  // 64-column boxes of the query tile
  unsigned char* qs = smem;                          // [nkq][R][128 B]
  unsigned char* bs = qs + nkq * R * ROW_BYTES;      // [stages][KC][128 B]
  float* vns = reinterpret_cast<float*>(bs + stages * KC * ROW_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(vns + stages * MT);
  uint64_t* empty = full + stages;
  uint64_t* qbar = empty + stages;

  const int group = blockIdx.x / cpg;
  const int row0 = group * q_tile + (blockIdx.x % cpg) * R;
  const int rows = min(min(R, group * q_tile + q_tile - row0), q_pad - row0);
  const int c0 = blockIdx.y * MT;
  const int w = block / m;
  const int nk = d_pad / KC;  // contraction chunks per slice
  const int* map = bmap ? bmap + (size_t)group * pmax : nullptr;
  const int count = bmap ? nprobe : nb;
  const int total = count * w * nk;  // staged tiles, in walk order
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(qbar, nkq * R * ROW_BYTES);
      for (int kq = 0; kq < nkq; ++kq)
        tma_load_2d(qs + kq * R * ROW_BYTES, &tm_q, kq * 64, row0, qbar);
      for (int s = 0; s < total; ++s) {
        const int st = s % stages;
        mbar_wait(&empty[st], ((s / stages) & 1) ^ 1);
        const int kci = s % nk, pj = s / nk;
        const int p = pj / w, j = pj - p * w;
        const int b = map ? map[p] : p;
        const bool last = kci == nk - 1;
        mbar_expect_tx(&full[st], KC * ROW_BYTES + (last ? MT * 4 : 0));
        tma_load_3d(bs + st * KC * ROW_BYTES, &tm_vb, j * m + c0, kci * KC,
                    b, &full[st]);
        if (last)
          bulk_load(vns + st * MT, vn + (size_t)b * block + j * m + c0,
                    MT * 4, &full[st]);
      }
    }
  } else {
    // ---- consumers: warpgroup c owns query rows [c * NQ, c * NQ + NQ) ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1;
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    const int g = lane / 4, tq = lane % 4;
    const unsigned keep = ~((1u << bits) - 1u);
    float acc[NACC], prod[NACC];
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 3.0e38f;

    mbar_wait(qbar, 0);
    for (int s = 0; s < total; ++s) {
      const int st = s % stages;
      const int kci = s % nk, pj = s / nk;
      mbar_wait(&full[st], (s / stages) & 1);
      const unsigned char* btile = bs + st * KC * ROW_BYTES;
      fence_regs(prod);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        const int k = kci * KC + kk;  // contraction index of this step
        // A: 16 rows of the [KC][64] vb tile; 8-row groups 1024 B apart
        // (both offsets set: only one 64-column pattern is read)
        const uint64_t da = sw128_desc(btile + kk * ROW_BYTES, 1024, 1024);
        // B: this warpgroup's NQ query rows of the 64-column box holding
        // k, advanced 2 bytes per column inside the swizzled row
        const uint64_t db = sw128_desc(
            qs + ((k / 64) * R + c * NQ) * ROW_BYTES + (k % 64) * 2, 16,
            1024);
        wgmma_bf16<NQ>(prod, da, db, kci > 0 || kk > 0);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_regs(prod);
      float v0 = 0.f, v1 = 0.f;
      const bool last = kci == nk - 1;
      if (last) {
        v0 = vns[st * MT + warp * 16 + g];
        v1 = vns[st * MT + warp * 16 + g + 8];
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);  // the stage may refill
      if (last) {
        // score = |v|^2 + q.(-2v); the block id rides the low bits
        const int p = pj / w;
        const unsigned b = map ? map[p] : p;
#pragma unroll
        for (int i = 0; i < NACC; ++i) {
          const float x = prod[i] + ((i & 2) ? v1 : v0);
          acc[i] = fminf(acc[i],
                         __uint_as_float((__float_as_uint(x) & keep) | b));
        }
      }
    }

    // acc[4i + e]: bucket column c0 + 16 warp + g (+8 for e >= 2), query
    // row c * NQ + 8i + 2 tq (+1 for odd e)
    const int col = c0 + warp * 16 + g;
#pragma unroll
    for (int i = 0; i < NACC / 4; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = c * NQ + 8 * i + 2 * tq + (e & 1);
        if (r < rows)
          out[(size_t)(row0 + r) * m + col + ((e & 2) ? 8 : 0)] =
              acc[4 * i + e];
      }
    }
  }
}

// ---- host side ---------------------------------------------------------

PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
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

size_t smem_bytes(int nq, int d_pad, int kc, int stages) {
  const size_t r = 2 * (size_t)nq, nkq = (d_pad + 63) / 64;
  return 1024 + nkq * r * ROW_BYTES + (size_t)stages * kc * ROW_BYTES +
         (size_t)stages * MT * 4 + (2 * (size_t)stages + 1) * 8;
}

struct Args {
  CUtensorMap tm_vb, tm_q;
  const float* vn;
  const int* bmap;
  float* out;
  int nb, d_pad, block, m, bits, q_pad, q_tile, pmax, nprobe, stages;
  size_t smem;
  cudaStream_t stream;
};

template <int NQ, int KC>
int launch(const Args& a) {
  cudaError_t err = cudaFuncSetAttribute(
      bucket_scan_sm90_kernel<NQ, KC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.smem);
  if (err != cudaSuccess) return (int)err;
  const int cpg = (a.q_tile + 2 * NQ - 1) / (2 * NQ);
  dim3 grid((a.q_pad / a.q_tile) * cpg, a.m / MT);
  bucket_scan_sm90_kernel<NQ, KC><<<grid, THREADS, a.smem, a.stream>>>(
      a.tm_vb, a.tm_q, a.vn, a.bmap, a.out, a.nb, a.d_pad, a.block, a.m,
      a.bits, a.q_pad, a.q_tile, cpg, a.pmax, a.nprobe, a.stages);
  return (int)cudaGetLastError();
}

template <int NQ>
int launch_kc(const Args& a, int kc) {
  switch (kc) {
    case 256: return launch<NQ, 256>(a);
    case 128: return launch<NQ, 128>(a);
    case 64: return launch<NQ, 64>(a);
    case 32: return launch<NQ, 32>(a);
    case 16: return launch<NQ, 16>(a);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Shared memory of a plan (nq query rows per consumer warpgroup, kc-row
// contraction chunks, a ring of `stages`): the wrapper's plan function
// computes the same sum.
size_t bucket_scan_sm90_smem_bytes(int nq, int d_pad, int kc, int stages) {
  return smem_bytes(nq, d_pad, kc, stages);
}

// bf16 vb [nb, d_pad, block], f32 vn [nb, 1, block], bf16 q [q_pad,
// d_pad], optional int32 bmap [q_pad / q_tile, pmax]; out [q_pad, m] f32.
// nq in {16, 32, 64, 128}; kc in {16, 32, 64, 128, 256} divides d_pad;
// m % 64 == 0, block % m == 0; q_tile divides q_pad (q_tile = q_pad for
// the full scan). Returns a CUDA error code (CUDA_ERROR_* + 10000 for the
// driver's tensor-map encoder), 0 on success.
int bucket_scan_sm90_launch(const void* vn, const void* vb, const void* q,
                            const void* bmap, void* out, int nb, int d_pad,
                            int block, int m, int bits, int q_pad,
                            int q_tile, int pmax, int nprobe, int nq, int kc,
                            int stages, void* stream) {
  auto encode = encode_fn();
  if (!encode) return (int)cudaErrorNotSupported;
  Args a;
  const cuuint64_t vdim[3] = {(cuuint64_t)block, (cuuint64_t)d_pad,
                              (cuuint64_t)nb};
  const cuuint64_t vstride[2] = {(cuuint64_t)block * 2,
                                 (cuuint64_t)d_pad * block * 2};
  const cuuint32_t vbox[3] = {(cuuint32_t)MT, (cuuint32_t)kc, 1};
  const cuuint32_t ones[3] = {1, 1, 1};
  CUresult res = encode(
      &a.tm_vb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(vb),
      vdim, vstride, vbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return 10000 + (int)res;
  const cuuint64_t qdim[2] = {(cuuint64_t)d_pad, (cuuint64_t)q_pad};
  const cuuint64_t qstride[1] = {(cuuint64_t)d_pad * 2};
  const cuuint32_t qbox[2] = {64, (cuuint32_t)(2 * nq)};
  res = encode(&a.tm_q, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
               const_cast<void*>(q), qdim, qstride, qbox, ones,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return 10000 + (int)res;
  a.vn = static_cast<const float*>(vn);
  a.bmap = static_cast<const int*>(bmap);
  a.out = static_cast<float*>(out);
  a.nb = nb, a.d_pad = d_pad, a.block = block, a.m = m, a.bits = bits;
  a.q_pad = q_pad, a.q_tile = q_tile, a.pmax = pmax, a.nprobe = nprobe;
  a.stages = stages;
  a.smem = smem_bytes(nq, d_pad, kc, stages);
  a.stream = static_cast<cudaStream_t>(stream);
  switch (nq) {
    case 128: return launch_kc<128>(a, kc);
    case 64: return launch_kc<64>(a, kc);
    case 32: return launch_kc<32>(a, kc);
    case 16: return launch_kc<16>(a, kc);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
