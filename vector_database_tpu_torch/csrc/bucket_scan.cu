// Bucketed k-NN scan over a packed database: the serving hot path.
//
// Replaces the three TPU kernels of vector_database_tpu/ops/pallas_knn.py
// on the bf16 path:
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
// vb holds -2v in bf16 ([nb, d_pad, block]), vn holds |v|^2 in f32, so the
// score is |v|^2 - 2 q.v (the per-query |q|^2 is dropped). The products are
// bf16 x bf16 with f32 accumulation on the tensor cores (mma.sync
// m16n8k16), the epilogue in f32 registers.
//
// What bounds it on an H100: at 10M x 96 (d_pad 128), q=4096 the scan is
// 2 * 4096 * 10M * 128 = 10.7 TFLOP of bf16 products against 2.6 GB of
// packed blocks, about 4000 FLOP per byte streamed from HBM: far above the
// card's ~295 FLOP/byte ridge, so tensor-core issue is the bound, and each
// block's [d_pad, MT] tile is re-read once per query-tile row of CTAs.
// What the design does about that:
//   * the bucket axis is split over CTAs (grid.y = m / MT): the TPU kept
//     one [q_tile, m] accumulator per grid step in VMEM; here each CTA owns
//     a [QT, MT] accumulator in registers, so nothing but the final
//     [q_pad, m] result ever leaves the SM;
//   * grid.x (query tiles) varies fastest, so the CTAs resident at one time
//     share the same vb columns and the re-reads hit L2, not HBM;
//   * the query tile stays resident in shared memory for the CTA's whole
//     walk; vb is staged in [KC, MT] chunks by cp.async into two buffers,
//     so the next chunk's copy is in flight while this one is multiplied
//     (ldmatrix fragments, mma.sync m16n8k16), and two CTAs share an SM.
// Deliberately simple (later work): no TMA, no wgmma, no warp
// specialisation, no persistent CTAs.
//
// Block map contract: a CTA covers QT query rows that lie inside ONE group
// of q_tile rows (QT divides q_tile); it walks bmap[row0 / q_tile, :nprobe].

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int MT = 128;       // bucket columns per CTA
constexpr int KC = 128;       // contraction rows of vb staged per pass
constexpr int THREADS = 256;  // 8 warps
constexpr int PAD = 8;        // bf16 row padding of the smem tiles (banks)

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
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

// WM warps along the query rows (16 rows each), 8 / WM along the buckets.
template <int WM>
__global__ void __launch_bounds__(THREADS, 2)
bucket_scan_kernel(const float* __restrict__ vn,
                   const __nv_bfloat16* __restrict__ vb,
                   const __nv_bfloat16* __restrict__ q,
                   const int* __restrict__ bmap, float* __restrict__ out,
                   int nb, int d_pad, int block, int m, int bits, int qt,
                   int q_tile, int pmax, int nprobe) {
  constexpr int WN = 8 / WM;
  constexpr int WCOLS = MT / WN;  // bucket columns per warp
  constexpr int NT = WCOLS / 8;   // m16n8 tiles per warp
  constexpr int ROWS = 16 * WM;   // rows of the mma tile (>= qt)
  constexpr int BS = MT + PAD;    // smem row stride of the vb chunk

  extern __shared__ __align__(16) unsigned char smem[];
  const int as = d_pad + PAD;  // smem row stride of the query tile
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + ROWS * as;
  float* vns = reinterpret_cast<float*>(Bs + 2 * KC * BS);  // [2][MT]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const int row0 = blockIdx.x * qt;
  const int c0 = blockIdx.y * MT;
  const int w = block / m;
  const unsigned keep = ~((1u << bits) - 1u);

  // the query tile, zero rows past qt (they are computed, never written)
  const int avec = d_pad / 8;
  for (int i = tid; i < ROWS * avec; i += THREADS) {
    const int r = i / avec, cv = i - r * avec;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < qt)
      v = *reinterpret_cast<const uint4*>(q + (size_t)(row0 + r) * d_pad +
                                          cv * 8);
    *reinterpret_cast<uint4*>(As + r * as + cv * 8) = v;
  }

  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 3.0e38f;

  const int* map = bmap ? bmap + (size_t)(row0 / q_tile) * pmax : nullptr;
  const int count = bmap ? nprobe : nb;
  const int nk = (d_pad + KC - 1) / KC;  // contraction chunks per slice
  const int total = count * w * nk;       // staged tiles, in walk order

  // stage tile s (block p, slice j, chunk kci) into buffer s & 1; a
  // slice's |v|^2 row rides its first chunk into vns[(p*w + j) & 1]
  auto stage = [&](int s) {
    const int kci = s % nk, pj = s / nk;
    const int p = pj / w, j = pj - p * w;
    const int b = map ? map[p] : p;
    const int k0 = kci * KC, kc = min(KC, d_pad - k0);
    const int col0 = j * m + c0;
    __nv_bfloat16* dst = Bs + (s & 1) * KC * BS;
    const __nv_bfloat16* src = vb + ((size_t)b * d_pad + k0) * block + col0;
    for (int i = tid; i < kc * (MT / 8); i += THREADS) {
      const int r = i / (MT / 8), cv = i - r * (MT / 8);
      cp_async16(dst + r * BS + cv * 8, src + (size_t)r * block + cv * 8);
    }
    if (kci == 0 && tid < MT / 4)
      cp_async16(vns + (pj & 1) * MT + tid * 4,
                 vn + (size_t)b * block + col0 + tid * 4);
    cp_async_commit();
  };

  float mins[NT][4], prod[NT][4];
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
    const int p = pj / w, j = pj - p * w;
    const int k0 = kci * KC, kc = min(KC, d_pad - k0);
    if (kci == 0) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          prod[nt][i] = 0.f;
          if (j == 0) mins[nt][i] = __int_as_float(0x7f800000);
        }
    }
    const __nv_bfloat16* Bt = Bs + (s & 1) * KC * BS;
    for (int kk = 0; kk < kc; kk += 16) {
      // A: the warp's 16x16 query fragment, four 8x8 matrices
      uint32_t a[4];
      ldmatrix_x4(a, As + (wm * 16 + (lane & 15)) * as + k0 + kk +
                         (lane >> 4) * 8);
      // B: two n8 tiles per ldmatrix.trans from the [k][n] chunk
      const __nv_bfloat16* bp = Bt + (kk + (lane & 7) +
                                      ((lane >> 3) & 1) * 8) * BS +
                                wn * WCOLS + (lane >> 4) * 8;
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, bp + nt * 8);
        mma_16816(prod[nt], a, bf);
        mma_16816(prod[nt + 1], a, bf + 2);
      }
    }
    if (kci == nk - 1) {
      // slice epilogue: score = |v|^2 + q.(-2v), running min over slices
      const float* vrow = vns + (pj & 1) * MT;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = wn * WCOLS + nt * 8 + 2 * t;
        const float v0 = vrow[col], v1 = vrow[col + 1];
        mins[nt][0] = fminf(mins[nt][0], v0 + prod[nt][0]);
        mins[nt][1] = fminf(mins[nt][1], v1 + prod[nt][1]);
        mins[nt][2] = fminf(mins[nt][2], v0 + prod[nt][2]);
        mins[nt][3] = fminf(mins[nt][3], v1 + prod[nt][3]);
      }
      if (j == w - 1) {
        // block epilogue: the block id rides the low mantissa bits
        const unsigned b = map ? map[p] : p;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[nt][i] = fminf(
                acc[nt][i],
                __int_as_float((int)(
                    ((unsigned)__float_as_int(mins[nt][i]) & keep) | b)));
      }
    }
    __syncthreads();  // buffer s & 1 is free for tile s + 2
  }

#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = c0 + wn * WCOLS + nt * 8 + 2 * t;
    const int r = wm * 16 + g;
    if (r < qt)
      *reinterpret_cast<float2*>(out + (size_t)(row0 + r) * m + col) =
          make_float2(acc[nt][0], acc[nt][1]);
    if (r + 8 < qt)
      *reinterpret_cast<float2*>(out + (size_t)(row0 + r + 8) * m + col) =
          make_float2(acc[nt][2], acc[nt][3]);
  }
}

template <int WM>
int launch(const float* vn, const __nv_bfloat16* vb, const __nv_bfloat16* q,
           const int* bmap, float* out, int nb, int d_pad, int block, int m,
           int bits, int q_pad, int qt, int q_tile, int pmax, int nprobe,
           size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      bucket_scan_kernel<WM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(q_pad / qt, m / MT);
  bucket_scan_kernel<WM><<<grid, THREADS, smem, stream>>>(
      vn, vb, q, bmap, out, nb, d_pad, block, m, bits, qt, q_tile, pmax,
      nprobe);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory the kernel needs for a query tile of qt rows.
size_t bucket_scan_smem_bytes(int qt, int d_pad) {
  const int rows = qt > 32 ? 64 : (qt > 16 ? 32 : 16);
  return (size_t)rows * (d_pad + PAD) * 2 +
         2 * ((size_t)KC * (MT + PAD) * 2 + (size_t)MT * 4);
}

// qt in {8, 16, 32, 64} divides q_pad (and q_tile when bmap is set);
// d_pad % 16 == 0, block % m == 0, m % 128 == 0. Returns cudaGetLastError.
int bucket_scan_launch(const void* vn, const void* vb, const void* q,
                       const void* bmap, void* out, int nb, int d_pad,
                       int block, int m, int bits, int q_pad, int qt,
                       int q_tile, int pmax, int nprobe, void* stream) {
  const size_t smem = bucket_scan_smem_bytes(qt, d_pad);
  auto* fvn = static_cast<const float*>(vn);
  auto* fvb = static_cast<const __nv_bfloat16*>(vb);
  auto* fq = static_cast<const __nv_bfloat16*>(q);
  auto* fmap = static_cast<const int*>(bmap);
  auto* fout = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (qt > 32)
    return launch<4>(fvn, fvb, fq, fmap, fout, nb, d_pad, block, m, bits,
                     q_pad, qt, q_tile, pmax, nprobe, smem, s);
  if (qt > 16)
    return launch<2>(fvn, fvb, fq, fmap, fout, nb, d_pad, block, m, bits,
                     q_pad, qt, q_tile, pmax, nprobe, smem, s);
  return launch<1>(fvn, fvb, fq, fmap, fout, nb, d_pad, block, m, bits,
                   q_pad, qt, q_tile, pmax, nprobe, smem, s);
}

}  // extern "C"
