// Exact integer bucketed k-NN scan over a pure-int8 pack.
//
// Replaces the TPU kernel _kernel_i8 (vector_database_tpu/ops/pallas_knn.py
// :344, called at :983).
//
// What it computes, for every query row r and bucket c in [0, m), in int32:
//   S(b, r, c)   = min over slices j < w = block/m of
//                  vn2[b, j*m + c] + qi[r, :] . vb[b, :, j*m + c]
//   scores[r, c] = min over blocks b of S(b, r, c)
//   ids[r, c]    = the first block, in walk order, that reached it
// vb holds -v*sq in int8 ([nb, d_pad, block]), qi holds q*sq in int8 and
// vn2 = rint(|v|^2 sq^2 / 2), so S is sq^2/2 times |v|^2 - 2 q.v up to the
// input quantization, and every product and sum is exact. Blocks are walked
// in order and the id changes only where a block's minimum is strictly
// below the accumulator, so a tie keeps the earlier block, as on the TPU.
//
// What bounds it on an H100: at 10M x 96 (d_pad 128), q=4096 the scan is
// 10.7 T int8 operations against 1.28 GB of blocks, ~8000 per byte streamed
// from HBM, so HBM is not the bound; the int8 tensor cores run at twice
// the bf16 rate. Measured at that size it still takes longer than the bf16
// scan of bucket_scan.cu: the L2 re-reads per query-tile row remain (at
// half the bytes), and the B-fragment transposes below, repeated by each
// warp row, take instruction slots beside the MMAs (the first suspect; not
// measured apart). What the design does about that:
//   * the same CTA split as bucket_scan.cu: grid (q_pad / qt, m / MT) with
//     the query-tile axis fastest, so the CTAs resident at one time read
//     the same vb columns and the re-reads hit L2; a CTA keeps its
//     accumulators in registers and writes only the final [qt, MT] tiles;
//   * products on the int8 tensor cores, mma.sync m16n8k32 s8 x s8 -> s32.
//     Its B fragment wants four consecutive k bytes of one bucket column
//     per register, but vb keeps the columns contiguous (the layout int8
//     and int8f packs share, so JAX packs load unchanged) and ldmatrix
//     .trans moves 16-bit elements only. So a chunk is staged by cp.async
//     as it lies, [k][n], with a row stride of 8 (mod 32) words; a thread
//     reads four words (four columns at k = t, t+4, t+8, t+12: one word per
//     bank across the warp) and transposes the 4x4 bytes in registers
//     (eight prmt), which gives the B fragments of four MMAs whose columns
//     lie 4 apart. Inside each group of 16 k the order is thereby permuted
//     (fragment position 4t + i holds k = t + 4i); the query tile is staged
//     with the same byte transpose of every 16-byte group, so the A
//     fragments (ldmatrix, not transposed) match and the dot is unchanged;
//   * registers: the score and block-id accumulators, the slice minima and
//     the products are four int32 per element; a warp covers 16 rows x 32
//     columns, so they take 64 registers and two CTAs share an SM
//     (8 warps: WM along the rows, 8 / WM of 32 columns each along m).
// Deliberately simple (later work): no TMA, no wgmma, no warp
// specialisation, no persistent CTAs.

#include <stdint.h>

#include "ptx.cuh"

namespace {

using namespace vdb;

constexpr int KC = 128;       // contraction rows of vb staged per pass
constexpr int THREADS = 256;  // 8 warps
constexpr int APAD = 16;      // bytes of row padding of the query tile
constexpr int BPAD = 32;      // bytes of row padding of the vb chunk

__host__ __device__ constexpr int cta_cols(int wm) { return 32 * (8 / wm); }

template <int WM>
__global__ void __launch_bounds__(THREADS, 2)
bucket_scan_i8_kernel(const int* __restrict__ vn,
                      const int8_t* __restrict__ vb,
                      const int8_t* __restrict__ q, int* __restrict__ out_s,
                      int* __restrict__ out_b, int nb, int d_pad, int block,
                      int m, int qt) {
  constexpr int MT = cta_cols(WM);  // bucket columns per CTA
  constexpr int WN = 8 / WM;        // warps along the buckets
  constexpr int ROWS = 16 * WM;     // rows of the mma tile (>= qt)
  constexpr int BS = MT + BPAD;     // bytes per staged vb row
  constexpr int BSW = BS / 4;       // ... in words: 8 or 24 (mod 32)

  extern __shared__ __align__(16) unsigned char smem[];
  const int as = d_pad + APAD;  // bytes per query-tile row
  int8_t* As = reinterpret_cast<int8_t*>(smem);
  int8_t* Bs = As + ROWS * as;                           // [2][KC][BS]
  int* vns = reinterpret_cast<int*>(Bs + 2 * KC * BS);  // [2][MT]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const int row0 = blockIdx.x * qt;
  const int c0 = blockIdx.y * MT;
  const int w = block / m;

  // the query tile, zero rows past qt (computed, never written); each
  // 16-byte k group transposed as 4x4 bytes (the k permutation above)
  const int avec = d_pad / 16;
  for (int i = tid; i < ROWS * avec; i += THREADS) {
    const int r = i / avec, cv = i - r * avec;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < qt)
      v = *reinterpret_cast<const uint4*>(q + (size_t)(row0 + r) * d_pad +
                                          cv * 16);
    transpose_bytes(v.x, v.y, v.z, v.w);
    *reinterpret_cast<uint4*>(As + r * as + cv * 16) = v;
  }

  // per thread: rows g and g + 8 of the warp's 16 ([h]), columns
  // 8t .. 8t + 7 of its 32 ([e]); prod[jt] is MMA tile jt's fragment
  int accs[2][8], accb[2][8], mins[2][8], prod[4][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      accs[h][e] = 0x7fffffff;
      accb[h][e] = 0;
    }

  const int nk = (d_pad + KC - 1) / KC;  // contraction chunks per slice
  const int total = nb * w * nk;          // staged tiles, in walk order

  // stage tile s (block b, slice j, chunk kci) into buffer s & 1; a
  // slice's vn2 row rides its first chunk into vns[(b*w + j) & 1]
  auto stage = [&](int s) {
    const int kci = s % nk, pj = s / nk;
    const int b = pj / w, j = pj - b * w;
    const int k0 = kci * KC, kc = min(KC, d_pad - k0);
    const int col0 = j * m + c0;
    int8_t* dst = Bs + (s & 1) * KC * BS;
    const int8_t* src = vb + ((size_t)b * d_pad + k0) * block + col0;
    for (int i = tid; i < kc * (MT / 16); i += THREADS) {
      const int r = i / (MT / 16), cv = i - r * (MT / 16);
      cp_async16(dst + r * BS + cv * 16, src + (size_t)r * block + cv * 16);
    }
    if (kci == 0 && tid < MT / 4)
      cp_async16(vns + (pj & 1) * MT + tid * 4,
                 vn + (size_t)b * block + col0 + tid * 4);
    cp_async_commit();
  };

  if (total > 0) stage(0);
  for (int s = 0; s < total; ++s) {
    // keep the next tile's copy in flight while this one is consumed
    if (s + 1 < total) {
      stage(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int kci = s % nk, pj = s / nk;
    const int b = pj / w, j = pj - b * w;
    const int k0 = kci * KC, kc = min(KC, d_pad - k0);
    if (kci == 0) {
#pragma unroll
      for (int jt = 0; jt < 4; ++jt)
#pragma unroll
        for (int i = 0; i < 4; ++i) prod[jt][i] = 0;
      if (j == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 8; ++e) mins[h][e] = 0x7fffffff;
      }
    }
    // this thread's column quad (warp columns 4g .. 4g + 3), as words
    const uint32_t* Bw = reinterpret_cast<const uint32_t*>(
                             Bs + (s & 1) * KC * BS) + wn * 8 + g;
    for (int kk = 0; kk < kc; kk += 32) {
      // A: the warp's 16x32 query fragment (b16 pairs of permuted k)
      uint32_t a[4];
      ldmatrix_x4(a, As + (wm * 16 + (lane & 15)) * as + k0 + kk +
                         (lane >> 4) * 16);
      // B: k = t + 4i (lo) and 16 + t + 4i (hi) of the quad, transposed
      // into column 4g + jt's four k bytes for MMA tile jt
      uint32_t lo[4], hi[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        lo[i] = Bw[(kk + t + 4 * i) * BSW];
        hi[i] = Bw[(kk + 16 + t + 4 * i) * BSW];
      }
      transpose_bytes(lo[0], lo[1], lo[2], lo[3]);
      transpose_bytes(hi[0], hi[1], hi[2], hi[3]);
#pragma unroll
      for (int jt = 0; jt < 4; ++jt) mma_16832_s8(prod[jt], a, lo[jt], hi[jt]);
    }
    if (kci == nk - 1) {
      // slice epilogue: S = vn2 + qi.(-vq), running min over slices. Tile
      // jt's c0/c2 are column 8t + jt, c1/c3 column 8t + 4 + jt.
      const int* vrow = vns + (pj & 1) * MT + wn * 32 + 8 * t;
      const int4 v0 = *reinterpret_cast<const int4*>(vrow);
      const int4 v1 = *reinterpret_cast<const int4*>(vrow + 4);
      const int vv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int jt = 0; jt < 4; ++jt) {
        mins[0][jt] = min(mins[0][jt], vv[jt] + prod[jt][0]);
        mins[0][4 + jt] = min(mins[0][4 + jt], vv[4 + jt] + prod[jt][1]);
        mins[1][jt] = min(mins[1][jt], vv[jt] + prod[jt][2]);
        mins[1][4 + jt] = min(mins[1][4 + jt], vv[4 + jt] + prod[jt][3]);
      }
      if (j == w - 1) {
        // block epilogue: strict improvement moves the id
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const bool better = mins[h][e] < accs[h][e];
            accs[h][e] = better ? mins[h][e] : accs[h][e];
            accb[h][e] = better ? b : accb[h][e];
          }
      }
    }
    __syncthreads();  // buffer s & 1 is free for tile s + 2
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wm * 16 + g + 8 * h;
    if (r < qt) {
      const size_t o = (size_t)(row0 + r) * m + c0 + wn * 32 + 8 * t;
      *reinterpret_cast<int4*>(out_s + o) =
          make_int4(accs[h][0], accs[h][1], accs[h][2], accs[h][3]);
      *reinterpret_cast<int4*>(out_s + o + 4) =
          make_int4(accs[h][4], accs[h][5], accs[h][6], accs[h][7]);
      *reinterpret_cast<int4*>(out_b + o) =
          make_int4(accb[h][0], accb[h][1], accb[h][2], accb[h][3]);
      *reinterpret_cast<int4*>(out_b + o + 4) =
          make_int4(accb[h][4], accb[h][5], accb[h][6], accb[h][7]);
    }
  }
}

template <int WM>
int launch(const int* vn, const int8_t* vb, const int8_t* q, int* out_s,
           int* out_b, int nb, int d_pad, int block, int m, int q_pad,
           int qt, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      bucket_scan_i8_kernel<WM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(q_pad / qt, m / cta_cols(WM));
  bucket_scan_i8_kernel<WM><<<grid, THREADS, smem, stream>>>(
      vn, vb, q, out_s, out_b, nb, d_pad, block, m, qt);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory of the kernel with wm warps along the query rows.
size_t bucket_scan_i8_smem_bytes(int wm, int d_pad) {
  const int mt = cta_cols(wm);
  return (size_t)16 * wm * (d_pad + APAD) + 2 * (size_t)KC * (mt + BPAD) +
         2 * (size_t)mt * 4;
}

// wm in {1, 2, 4}; qt <= 16 * wm divides q_pad; d_pad % 32 == 0;
// block % m == 0; m % (256 / wm) == 0. Returns cudaGetLastError.
int bucket_scan_i8_launch(const void* vn, const void* vb, const void* q,
                          void* out_s, void* out_b, int nb, int d_pad,
                          int block, int m, int q_pad, int qt, int wm,
                          void* stream) {
  const size_t smem = bucket_scan_i8_smem_bytes(wm, d_pad);
  auto* ivn = static_cast<const int*>(vn);
  auto* ivb = static_cast<const int8_t*>(vb);
  auto* iq = static_cast<const int8_t*>(q);
  auto* os = static_cast<int*>(out_s);
  auto* ob = static_cast<int*>(out_b);
  auto s = static_cast<cudaStream_t>(stream);
  if (wm == 4)
    return launch<4>(ivn, ivb, iq, os, ob, nb, d_pad, block, m, q_pad, qt,
                     smem, s);
  if (wm == 2)
    return launch<2>(ivn, ivb, iq, os, ob, nb, d_pad, block, m, q_pad, qt,
                     smem, s);
  return launch<1>(ivn, ivb, iq, os, ob, nb, d_pad, block, m, q_pad, qt,
                   smem, s);
}

}  // extern "C"
