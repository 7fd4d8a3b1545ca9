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
// What bounds it: the same as bucket_scan.cu, whose staging (cp.async
// double buffering of [KC, MT] chunks), CTA split over the buckets and
// mma.sync m16n8k16 fragments it keeps unchanged, so the split it measures
// applies to the production kernel. What it does about that: nothing
// beyond bucket_scan.cu's design; it is a measurement, not a serving path.

#include <cuda_bf16.h>

#include "ptx.cuh"

namespace {

using namespace vdb;

enum Mode { FULL = 0, NOEPI = 1, NODOT = 2, DMAONLY = 3 };

constexpr int MT = 128;       // bucket columns per CTA
constexpr int KC = 128;       // contraction rows of vb staged per pass
constexpr int THREADS = 256;  // 8 warps
constexpr int PAD = 8;        // bf16 row padding of the smem tiles (banks)

template <int MODE, int WM>
__global__ void __launch_bounds__(THREADS, 2)
probe_kernel(const float* __restrict__ vn,
             const __nv_bfloat16* __restrict__ vb,
             const __nv_bfloat16* __restrict__ q,
             const float* __restrict__ qn, int* __restrict__ out, int nb,
             int d_pad, int block, int m, int bits, int qt) {
  constexpr bool DOT = MODE == FULL || MODE == NOEPI;
  constexpr int WN = 8 / WM;
  constexpr int WCOLS = MT / WN;
  constexpr int NT = WCOLS / 8;
  constexpr int ROWS = 16 * WM;
  constexpr int BS = MT + PAD;

  extern __shared__ __align__(16) unsigned char smem[];
  const int as = d_pad + PAD;
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
  const int keep = (int)~((1u << bits) - 1u);

  const int avec = d_pad / 8;
  for (int i = tid; i < ROWS * avec; i += THREADS) {
    const int r = i / avec, cv = i - r * avec;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < qt)
      v = *reinterpret_cast<const uint4*>(q + (size_t)(row0 + r) * d_pad +
                                          cv * 8);
    *reinterpret_cast<uint4*>(As + r * as + cv * 8) = v;
  }
  // |q|^2 of this thread's two rows (g and g + 8 of the warp's 16)
  const int r_lo = wm * 16 + g;
  const float qn0 = r_lo < qt ? qn[row0 + r_lo] : 0.f;
  const float qn1 = r_lo + 8 < qt ? qn[row0 + r_lo + 8] : 0.f;

  int acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0x7fffffff;

  const int nk = (d_pad + KC - 1) / KC;
  const int total = nb * w * nk;

  auto stage = [&](int s) {
    const int kci = s % nk, pj = s / nk;
    const int b = pj / w, j = pj - b * w;
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

  // the older scan's per-slice encode of one score
  auto enc = [&](float d2, int id) {
    return (__float_as_int(d2) & keep) | id;
  };
  auto full = [&](float v, float p, float qrow) {
    return __fadd_rn(__fsub_rn(v, __fmul_rn(2.f, p)), qrow);
  };
  auto nodot = [&](float v, float qrow) {
    return __fadd_rn(__fmaf_rn(v, -(2.f * 1.0001f), v), qrow);
  };

  float prod[NT][4];
  if (total > 0) stage(0);
  for (int s = 0; s < total; ++s) {
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
    if constexpr (DOT) {
      if (kci == 0) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) prod[nt][i] = 0.f;
      }
      const __nv_bfloat16* Bt = Bs + (s & 1) * KC * BS;
      for (int kk = 0; kk < kc; kk += 16) {
        uint32_t a[4];
        ldmatrix_x4(a, As + (wm * 16 + (lane & 15)) * as + k0 + kk +
                           (lane >> 4) * 8);
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
    }
    if (kci == nk - 1) {
      const float* vrow = vns + (pj & 1) * MT;
      const int id = b * w + j;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = wn * WCOLS + nt * 8 + 2 * t;
        const float v0 = vrow[col], v1 = vrow[col + 1];
        if constexpr (MODE == FULL) {
          acc[nt][0] = min(acc[nt][0], enc(full(v0, prod[nt][0], qn0), id));
          acc[nt][1] = min(acc[nt][1], enc(full(v1, prod[nt][1], qn0), id));
          acc[nt][2] = min(acc[nt][2], enc(full(v0, prod[nt][2], qn1), id));
          acc[nt][3] = min(acc[nt][3], enc(full(v1, prod[nt][3], qn1), id));
        } else if constexpr (MODE == NOEPI) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[nt][i] = min(acc[nt][i], __float_as_int(prod[nt][i]));
        } else if constexpr (MODE == NODOT) {
          acc[nt][0] = min(acc[nt][0], enc(nodot(v0, qn0), id));
          acc[nt][1] = min(acc[nt][1], enc(nodot(v1, qn0), id));
          acc[nt][2] = min(acc[nt][2], enc(nodot(v0, qn1), id));
          acc[nt][3] = min(acc[nt][3], enc(nodot(v1, qn1), id));
        } else {
          if (j == 0) {
            acc[nt][0] = min(acc[nt][0], __float_as_int(v0));
            acc[nt][1] = min(acc[nt][1], __float_as_int(v1));
            acc[nt][2] = min(acc[nt][2], __float_as_int(v0));
            acc[nt][3] = min(acc[nt][3], __float_as_int(v1));
          }
        }
      }
    }
    __syncthreads();  // buffer s & 1 is free for tile s + 2
  }

#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = c0 + wn * WCOLS + nt * 8 + 2 * t;
    if (r_lo < qt)
      *reinterpret_cast<int2*>(out + (size_t)(row0 + r_lo) * m + col) =
          make_int2(acc[nt][0], acc[nt][1]);
    if (r_lo + 8 < qt)
      *reinterpret_cast<int2*>(out + (size_t)(row0 + r_lo + 8) * m + col) =
          make_int2(acc[nt][2], acc[nt][3]);
  }
}

template <int MODE, int WM>
int launch(const float* vn, const __nv_bfloat16* vb, const __nv_bfloat16* q,
           const float* qn, int* out, int nb, int d_pad, int block, int m,
           int bits, int q_pad, int qt, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      probe_kernel<MODE, WM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(q_pad / qt, m / MT);
  probe_kernel<MODE, WM><<<grid, THREADS, smem, stream>>>(
      vn, vb, q, qn, out, nb, d_pad, block, m, bits, qt);
  return (int)cudaGetLastError();
}

template <int MODE>
int launch_m(const float* vn, const __nv_bfloat16* vb,
             const __nv_bfloat16* q, const float* qn, int* out, int nb,
             int d_pad, int block, int m, int bits, int q_pad, int qt,
             size_t smem, cudaStream_t s) {
  if (qt > 32)
    return launch<MODE, 4>(vn, vb, q, qn, out, nb, d_pad, block, m, bits,
                           q_pad, qt, smem, s);
  if (qt > 16)
    return launch<MODE, 2>(vn, vb, q, qn, out, nb, d_pad, block, m, bits,
                           q_pad, qt, smem, s);
  return launch<MODE, 1>(vn, vb, q, qn, out, nb, d_pad, block, m, bits,
                         q_pad, qt, smem, s);
}

}  // namespace

extern "C" {

size_t probe_kernel_ab_smem_bytes(int qt, int d_pad) {
  const int rows = qt > 32 ? 64 : (qt > 16 ? 32 : 16);
  return (size_t)rows * (d_pad + PAD) * 2 +
         2 * ((size_t)KC * (MT + PAD) * 2 + (size_t)MT * 4);
}

// mode: 0 full, 1 noepi, 2 nodot, 3 dmaonly. qt in {8, 16, 32, 64}
// divides q_pad; d_pad % 16 == 0, block % m == 0, m % 128 == 0.
// Returns cudaGetLastError (cudaErrorInvalidValue for an unknown mode).
int probe_kernel_ab_launch(int mode, const void* vn, const void* vb,
                           const void* q, const void* qn, void* out, int nb,
                           int d_pad, int block, int m, int bits, int q_pad,
                           int qt, void* stream) {
  const size_t smem = probe_kernel_ab_smem_bytes(qt, d_pad);
  auto* fvn = static_cast<const float*>(vn);
  auto* fvb = static_cast<const __nv_bfloat16*>(vb);
  auto* fq = static_cast<const __nv_bfloat16*>(q);
  auto* fqn = static_cast<const float*>(qn);
  auto* iout = static_cast<int*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case FULL:
      return launch_m<FULL>(fvn, fvb, fq, fqn, iout, nb, d_pad, block, m,
                            bits, q_pad, qt, smem, s);
    case NOEPI:
      return launch_m<NOEPI>(fvn, fvb, fq, fqn, iout, nb, d_pad, block, m,
                             bits, q_pad, qt, smem, s);
    case NODOT:
      return launch_m<NODOT>(fvn, fvb, fq, fqn, iout, nb, d_pad, block, m,
                             bits, q_pad, qt, smem, s);
    case DMAONLY:
      return launch_m<DMAONLY>(fvn, fvb, fq, fqn, iout, nb, d_pad, block, m,
                               bits, q_pad, qt, smem, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
