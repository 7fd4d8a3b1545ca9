// The k best delta rows of each query, one pass a 128 places, with no
// distance matrix in memory: the delta merge of DynamicIndex
// (vector_database_tpu_torch/dynamic.py, merge_delta, inside the
// vdb_torch.dynamic.merge span).
//
// Replaces no Pallas kernel: the JAX package merges the delta on the host
// (vector_database_tpu/dynamic.py: _exact_d2_blocked, then a partial sort),
// and the port did it in plain PyTorch (delta_knn_reference: the [Q, R]
// distance matrix in [Q, 1024, D] blocks, masked, then a top-k) before
// this kernel.
//
// What it computes, for every query q < Q and the live delta rows (slots
// s of the padded delta x, slots[0 .. n_live)):
//   d2(q, s) = the f32 sum over d = 0, 1, ..., D - 1 of (q[d] - x[s, d])^2,
// each difference one f32 subtraction and each square added by one fused
// multiply-add, in ascending d: the exact f32 difference form, never the
// |q|^2 + |x|^2 - 2 q.x expansion, which cancels on near-duplicates.
// Out: the k smallest pairs (d2, s) of each query in ascending order of
// the pair, so equal distances keep the lower slot, also at the k-th
// place: what a stable top-k over the masked [Q, R] matrix returns. Where
// fewer than k rows are live, the missing places hold (+inf, -1).
//
// What bounds it on an H100: the f32 pipes. A pair and dimension is two
// instructions (FSUB, FFMA), 2 Q R D in all: at Q = R = 10,000 and D = 96,
// 1.9e10 lane-instructions, ~0.6 ms at 132 SMs x 128 lanes x ~1.8 GHz.
// The bytes are nothing beside that (the rows, 3.8 MB, stay in L2).
//
// What the design does about it:
//  * A CTA holds 64 queries; each of its 8 warps owns 8 of them, and each
//    lane 4 rows of a 128-row tile: 32 running sums in registers. The
//    dimensions come in chunks of 32 through two shared-memory stages
//    (cp.async, the next chunk in flight while this one is summed), read
//    as float4: 12 shared loads for 256 f32 instructions.
//  * Selection happens once a tile, in registers: a warp keeps each of
//    its queries' best 32 P places spread over its lanes (place p at lane
//    p % 32, register p / 32; P = 1, 2 or 4 from k), and a candidate
//    enters only where it beats the k-th place. Past the first tiles few
//    do, so the test costs a compare a pair. An entry is placed by P
//    ballots (its rank) and a shift of the places behind it by shuffles.
//  * Any k: a pass fills at most 128 places; the next pass (launch) fills
//    the next ones from the pairs after the last place the one before
//    wrote, which its CTAs read back as each query's lower bound.
//  * The live rows are split over gridDim.y CTAs where the query tiles
//    alone would leave SMs idle (1.22x at 10,000 queries, 2.9x at 2,000
//    against one split); each CTA writes its split's places, and a second
//    kernel merges each query's splits by (distance, slot), also where
//    there is one. Neither order of arrival nor the split changes the
//    result: the output is the k smallest pairs of a total order.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TQ = 8;                  // queries a warp owns
constexpr int TR = 4;                  // rows a lane holds
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int QT = WARPS * TQ;         // queries a CTA
constexpr int RT = 32 * TR;            // rows a tile
constexpr int DC = 32;                 // dimensions a chunk
constexpr int LD = DC + 4;             // floats between rows in a stage
constexpr int STAGE = (QT + RT) * LD;  // floats a stage
// two stages, then each query's lower bound (distance, slot)
constexpr int SMEM_BYTES = 2 * STAGE * 4 + QT * 8;
constexpr int PASS_K = 128;            // places a pass fills: 32 x 4
constexpr int MAX_SPLITS = 32;
constexpr int MERGE_THREADS = 128;
constexpr int MAX_DEVICES = 64;
constexpr int NONE = INT_MAX;          // the slot of an empty place
constexpr unsigned FULL = 0xffffffffu;

// (a, as) comes before (b, bs): by distance, then by slot.
__device__ __host__ __forceinline__ bool before(float a, int as, float b,
                                                int bs) {
  return a < b || (a == b && as < bs);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One stage: dimensions [d0, d0 + DC) of the CTA's queries (stage rows
// 0 .. QT) and of the live rows at positions [r0, r0 + RT) of slots
// (stage rows QT ..), zeros past Q, past r1 and past D. VEC floats a copy:
// 4 where D % 4 == 0 and both matrices start on 16-byte boundaries.
template <int VEC>
__device__ __forceinline__ void load_stage(float* stage,
                                           const float* __restrict__ q,
                                           const float* __restrict__ x,
                                           const int* __restrict__ slots,
                                           int Q, int D, int q0, int r0,
                                           int r1, int d0) {
  constexpr int PER_ROW = DC / VEC;
  for (int e = threadIdx.x; e < (QT + RT) * PER_ROW; e += THREADS) {
    const int r = e / PER_ROW, d = d0 + (e % PER_ROW) * VEC;
    const float* src = q;  // read by no copy of 0 bytes
    bool ok = d < D;
    if (r < QT) {
      ok = ok && q0 + r < Q;
      if (ok) src = q + (long long)(q0 + r) * D + d;
    } else {
      const int p = r0 + r - QT;
      ok = ok && p < r1;
      if (ok) src = x + (long long)slots[p] * D + d;
    }
    float* dst = stage + r * LD + (d - d0);
    if (VEC == 4)
      cp_async16(dst, src, ok ? 16 : 0);
    else
      cp_async4(dst, src, ok ? 4 : 0);
  }
}

// Adds a stage's DC dimensions to the warp's 8 x 4 running sums, in
// ascending dimension order.
__device__ __forceinline__ void accumulate(float (&acc)[TQ][TR],
                                           const float* stage, int warp,
                                           int lane) {
  const float* qs = stage + warp * TQ * LD;
  const float* xs = stage + (QT + lane) * LD;
#pragma unroll
  for (int d = 0; d < DC; d += 4) {
    float4 xv[TR];
#pragma unroll
    for (int j = 0; j < TR; ++j)
      xv[j] = *reinterpret_cast<const float4*>(xs + j * 32 * LD + d);
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      const float4 qv = *reinterpret_cast<const float4*>(qs + i * LD + d);
#pragma unroll
      for (int j = 0; j < TR; ++j) {
        float t = __fsub_rn(qv.x, xv[j].x);
        acc[i][j] = __fmaf_rn(t, t, acc[i][j]);
        t = __fsub_rn(qv.y, xv[j].y);
        acc[i][j] = __fmaf_rn(t, t, acc[i][j]);
        t = __fsub_rn(qv.z, xv[j].z);
        acc[i][j] = __fmaf_rn(t, t, acc[i][j]);
        t = __fsub_rn(qv.w, xv[j].w);
        acc[i][j] = __fmaf_rn(t, t, acc[i][j]);
      }
    }
  }
}

// The warp's place p (lane p % 32, register p / 32) of one query.
template <int P>
__device__ __forceinline__ void place(const float (&d)[P], const int (&s)[P],
                                      int p, float& pd, int& ps) {
  float v = d[0];
  int w = s[0];
#pragma unroll
  for (int m = 1; m < P; ++m)
    if (m == p >> 5) {
      v = d[m];
      w = s[m];
    }
  pd = __shfl_sync(FULL, v, p & 31);
  ps = __shfl_sync(FULL, w, p & 31);
}

// Offers a tile's distances to the warp's places. bd[i], bs[i]: query
// i's places, ascending by place; rs[j] the slot of the lane's j-th row
// of the tile, NONE past the live rows; lo_d, lo_s the queries' lower
// bounds: a pair enters only after it.
template <int P>
__device__ __forceinline__ void offer(const float (&acc)[TQ][TR],
                                      const int (&rs)[TR],
                                      float (&bd)[TQ][P], int (&bs)[TQ][P],
                                      const float* lo_d, const int* lo_s,
                                      int k, int lane) {
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    float kd;
    int ks;
    place<P>(bd[i], bs[i], k - 1, kd, ks);
    unsigned pend = 0;  // the lane's rows that beat the k-th place
#pragma unroll
    for (int j = 0; j < TR; ++j)
      if (rs[j] != NONE && before(acc[i][j], rs[j], kd, ks)) pend |= 1u << j;
    if (pend != 0) {  // and come after the lower bound
      const float ld = lo_d[i];
      const int ls = lo_s[i];
#pragma unroll
      for (int j = 0; j < TR; ++j)
        if (!before(ld, ls, acc[i][j], rs[j])) pend &= ~(1u << j);
    }
    unsigned lanes;
    while ((lanes = __ballot_sync(FULL, pend != 0)) != 0) {
      const int src = __ffs(lanes) - 1;
      const int first = __ffs(pend) - 1;
      float cd = 0.f;
      int cs = 0;
#pragma unroll
      for (int j = 0; j < TR; ++j)
        if (j == first) {
          cd = acc[i][j];
          cs = rs[j];
        }
      cd = __shfl_sync(FULL, cd, src);
      cs = __shfl_sync(FULL, cs, src);
      if (lane == src) pend &= pend - 1;
      if (!before(cd, cs, kd, ks)) continue;  // an earlier entry beat it
      // its rank: the places before it, a prefix of the places
      int pos = 0;
#pragma unroll
      for (int m = 0; m < P; ++m)
        pos += __popc(__ballot_sync(FULL, before(bd[i][m], bs[i][m], cd, cs)));
      // places pos .. move up by one, the last register first: place
      // 32 m + lane takes what place 32 m + lane - 1 held
#pragma unroll
      for (int m = P - 1; m >= 0; --m) {
        if (32 * m + 31 < pos) continue;  // no place of this register moves
        float up_d = __shfl_up_sync(FULL, bd[i][m], 1);
        int up_s = __shfl_up_sync(FULL, bs[i][m], 1);
        if (m > 0) {
          const float wd = __shfl_sync(FULL, bd[i][m > 0 ? m - 1 : 0], 31);
          const int ws = __shfl_sync(FULL, bs[i][m > 0 ? m - 1 : 0], 31);
          if (lane == 0) {
            up_d = wd;
            up_s = ws;
          }
        }
        const int p = 32 * m + lane;
        if (p == pos) {
          bd[i][m] = cd;
          bs[i][m] = cs;
        } else if (p > pos) {
          bd[i][m] = up_d;
          bs[i][m] = up_s;
        }
      }
      place<P>(bd[i], bs[i], k - 1, kd, ks);
#pragma unroll
      for (int j = 0; j < TR; ++j)
        if ((pend >> j & 1u) && !before(acc[i][j], rs[j], kd, ks))
          pend &= ~(1u << j);
    }
  }
}

// One pass. Grid (ceil(Q / QT), splits): CTA (x, y) takes queries
// [x QT, x QT + QT) against the live rows at positions [y per_split,
// (y + 1) per_split) of slots and writes each query's k smallest pairs
// after its lower bound to part_d/part_s [splits, Q, k] for merge_splits.
// The lower bound is out[q, c0 - 1] of out_d/out_s [Q, ld] where c0 > 0
// (the last place of the pass before), else none.
template <int VEC, int P>
__global__ void __launch_bounds__(THREADS, P == 1 ? 2 : 1)
    delta_knn_kernel(const float* __restrict__ q, const float* __restrict__ x,
                     const int* __restrict__ slots, int Q, int D, int n_live,
                     int k, int c0, int ld, int per_split,
                     const float* __restrict__ out_d,
                     const long long* __restrict__ out_s,
                     float* __restrict__ part_d, int* __restrict__ part_s) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* lo_d = smem + 2 * STAGE;
  int* lo_s = reinterpret_cast<int*>(lo_d + QT);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * QT;
  const int lo = blockIdx.y * per_split;
  const int hi = min(lo + per_split, n_live);
  const int chunks = (D + DC - 1) / DC;
  const int steps = hi > lo ? (hi - lo + RT - 1) / RT * chunks : 0;

  if (threadIdx.x < QT) {
    const int qi = q0 + threadIdx.x;
    float d = -INFINITY;
    int s = -1;  // before every pair
    if (c0 > 0 && qi < Q) {
      d = out_d[(long long)qi * ld + c0 - 1];
      const long long o = out_s[(long long)qi * ld + c0 - 1];
      s = o < 0 ? NONE : (int)o;  // an empty place: after every pair
    }
    lo_d[threadIdx.x] = d;
    lo_s[threadIdx.x] = s;
  }

  float bd[TQ][P];
  int bs[TQ][P];
  float acc[TQ][TR];
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
#pragma unroll
    for (int m = 0; m < P; ++m) {
      bd[i][m] = INFINITY;
      bs[i][m] = NONE;
    }
#pragma unroll
    for (int j = 0; j < TR; ++j) acc[i][j] = 0.f;
  }

  if (steps > 0) {
    load_stage<VEC>(smem, q, x, slots, Q, D, q0, lo, hi, 0);
    cp_commit();
  }
  for (int n = 0; n < steps; ++n) {
    const int t = n / chunks, c = n - t * chunks;
    if (n + 1 < steps) {
      const int t1 = (n + 1) / chunks, c1 = n + 1 - t1 * chunks;
      load_stage<VEC>(smem + ((n + 1) & 1) * STAGE, q, x, slots, Q, D, q0,
                      lo + t1 * RT, hi, c1 * DC);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    accumulate(acc, smem + (n & 1) * STAGE, warp, lane);
    __syncthreads();  // the next step's copies overwrite this stage
    if (c == chunks - 1) {
      int rs[TR];
#pragma unroll
      for (int j = 0; j < TR; ++j) {
        const int p = lo + t * RT + lane + 32 * j;
        rs[j] = p < hi ? slots[p] : NONE;
      }
      offer<P>(acc, rs, bd, bs, lo_d + warp * TQ, lo_s + warp * TQ, k,
               lane);
#pragma unroll
      for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int j = 0; j < TR; ++j) acc[i][j] = 0.f;
    }
  }

#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const int qi = q0 + warp * TQ + i;
#pragma unroll
    for (int m = 0; m < P; ++m) {
      const int p = 32 * m + lane;
      if (qi >= Q || p >= k) continue;
      const long long o = ((long long)blockIdx.y * Q + qi) * k + p;
      part_d[o] = bd[i][m];
      part_s[o] = bs[i][m];
    }
  }
}

// One thread a query: the k smallest pairs of its splits' sorted places,
// to columns [c0, c0 + k) of out [Q, ld].
__global__ void __launch_bounds__(MERGE_THREADS)
    merge_splits(const float* __restrict__ part_d,
                 const int* __restrict__ part_s, int splits, int Q, int k,
                 int c0, int ld, float* __restrict__ out_d,
                 long long* __restrict__ out_s) {
  const int qi = blockIdx.x * MERGE_THREADS + threadIdx.x;
  if (qi >= Q) return;
  int head[MAX_SPLITS];
  for (int s = 0; s < splits; ++s) head[s] = 0;
  for (int j = 0; j < k; ++j) {
    int from = -1, bs = NONE;
    float bd = INFINITY;
    for (int s = 0; s < splits; ++s) {
      if (head[s] >= k) continue;
      const long long o = ((long long)s * Q + qi) * k + head[s];
      const float d = part_d[o];
      const int sl = part_s[o];
      if (from < 0 || before(d, sl, bd, bs)) {
        from = s;
        bd = d;
        bs = sl;
      }
    }
    ++head[from];
    out_d[(long long)qi * ld + c0 + j] = bd;
    out_s[(long long)qi * ld + c0 + j] = bs == NONE ? -1 : bs;
  }
}

// What the plan needs of a card: its SMs, and the CTAs of a pass with P
// places a lane that one SM holds (P = 1, 2, 4 at 0, 1, 2).
struct Card {
  int sms;
  int per_sm[3];
};
Card cards[MAX_DEVICES];
bool ready[MAX_DEVICES];

template <int VEC, int P>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(delta_knn_kernel<VEC, P>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              SMEM_BYTES);
}

template <int P>
cudaError_t per_sm(int* n) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      n, delta_knn_kernel<4, P>, THREADS, SMEM_BYTES);
}

// The current card's Card, reading it at the first call on the card:
// the kernels' claim on shared memory (over the 48 KB default) is set
// there too, once.
cudaError_t current_card(const Card** out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  Card& c = cards[dev];
  if (!ready[dev]) {
    const cudaError_t errs[] = {
        allow_smem<1, 1>(), allow_smem<1, 2>(), allow_smem<1, 4>(),
        allow_smem<4, 1>(), allow_smem<4, 2>(), allow_smem<4, 4>(),
        per_sm<1>(&c.per_sm[0]), per_sm<2>(&c.per_sm[1]),
        per_sm<4>(&c.per_sm[2]),
        cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev)};
    for (cudaError_t e : errs)
      if (e != cudaSuccess) return e;
    if (c.per_sm[0] < 1 || c.per_sm[1] < 1 || c.per_sm[2] < 1)
      return cudaErrorInvalidConfiguration;
    ready[dev] = true;
  }
  *out = &c;
  return cudaSuccess;
}

// A pass: places [c0, c0 + k) of each query, P places a lane, the live
// rows in `splits` runs of `per_split` rows.
struct Pass {
  int c0, k, p, splits, per_split;
};

// The pass that starts at place c0 of k. The split count minimises
// (waves of CTAs) x (row tiles a split + 1/2), the half tile standing for
// a split's fixed cost, the fewest splits on a tie; the rows a split are
// whole tiles, and no split is empty.
Pass plan_pass(const Card& card, int Q, int n_live, int k, int c0) {
  Pass pass;
  pass.c0 = c0;
  pass.k = k - c0 < PASS_K ? k - c0 : PASS_K;
  pass.p = pass.k <= 32 ? 1 : pass.k <= 64 ? 2 : 4;
  const long long resident =
      (long long)card.per_sm[pass.p == 1 ? 0 : pass.p == 2 ? 1 : 2] *
      card.sms;
  const long long q_tiles = (Q + QT - 1) / QT;
  const int row_tiles = n_live > RT ? (n_live + RT - 1) / RT : 1;
  const int most = row_tiles < MAX_SPLITS ? row_tiles : MAX_SPLITS;
  int best = 1;
  long long best_cost = -1;
  for (int s = 1; s <= most; ++s) {
    const long long waves = (q_tiles * s + resident - 1) / resident;
    const long long cost = waves * (2 * ((row_tiles + s - 1) / s) + 1);
    if (best_cost < 0 || cost < best_cost) {
      best = s;
      best_cost = cost;
    }
  }
  pass.per_split = (row_tiles + best - 1) / best * RT;
  pass.splits = n_live > pass.per_split
                    ? (n_live + pass.per_split - 1) / pass.per_split
                    : 1;
  return pass;
}

// The places of split partials the passes need.
long long scratch_places(const Card& card, int Q, int n_live, int k) {
  long long most = 0;
  for (int c0 = 0; c0 < k; c0 += PASS_K) {
    const Pass pass = plan_pass(card, Q, n_live, k, c0);
    const long long n = (long long)pass.splits * Q * pass.k;
    if (n > most) most = n;
  }
  return most;
}

template <int VEC, int P>
cudaError_t launch_pass(const Pass& pass, const float* q, const float* x,
                        const int* slots, int Q, int D, int n_live, int ld,
                        float* out_d, long long* out_s, float* part_d,
                        int* part_s, cudaStream_t stream) {
  const dim3 grid((Q + QT - 1) / QT, pass.splits);
  delta_knn_kernel<VEC, P><<<grid, THREADS, SMEM_BYTES, stream>>>(
      q, x, slots, Q, D, n_live, pass.k, pass.c0, ld, pass.per_split, out_d,
      out_s, part_d, part_s);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_splits<<<(Q + MERGE_THREADS - 1) / MERGE_THREADS, MERGE_THREADS, 0,
                 stream>>>(part_d, part_s, pass.splits, Q, pass.k, pass.c0,
                           ld, out_d, out_s);
  return cudaGetLastError();
}

// launch_pass with P from the pass.
template <int VEC>
cudaError_t dispatch_pass(const Pass& pass, const float* q, const float* x,
                          const int* slots, int Q, int D, int n_live, int ld,
                          float* out_d, long long* out_s, float* part_d,
                          int* part_s, cudaStream_t stream) {
  switch (pass.p) {
    case 1:
      return launch_pass<VEC, 1>(pass, q, x, slots, Q, D, n_live, ld, out_d,
                                 out_s, part_d, part_s, stream);
    case 2:
      return launch_pass<VEC, 2>(pass, q, x, slots, Q, D, n_live, ld, out_d,
                                 out_s, part_d, part_s, stream);
    default:
      return launch_pass<VEC, 4>(pass, q, x, slots, Q, D, n_live, ld, out_d,
                                 out_s, part_d, part_s, stream);
  }
}

}  // namespace

extern "C" {

// The places of scratch (part_d f32 and part_s int32 each) that
// delta_knn_launch needs for Q queries over n_live live rows and k places
// on the current card, or minus a CUDA error code.
long long delta_knn_scratch(int Q, int n_live, int k) {
  const Card* card = nullptr;
  const cudaError_t err = current_card(&card);
  if (err != cudaSuccess) return -(long long)err;
  return scratch_places(*card, Q, n_live, k);
}

// queries [Q, D] and delta [R, D] f32, contiguous, D >= 1; slots [n_live]
// int32, distinct live slots of delta; out_d [Q, k] f32 and out_s [Q, k]
// int64, contiguous; part_d, part_s: scratch of `places` places each,
// at least delta_knn_scratch(Q, n_live, k). Returns the kernels launched,
// two a pass of 128 places (ceil(k / 128) passes), or minus a CUDA error
// code.
int delta_knn_launch(const void* queries, const void* delta,
                     const void* slots, int Q, int D, int n_live, int k,
                     void* out_d, void* out_s, void* part_d, void* part_s,
                     long long places, void* stream) {
  if (Q < 1 || D < 1 || n_live < 0 || k < 1) return -(int)cudaErrorInvalidValue;
  const Card* card = nullptr;
  cudaError_t err = current_card(&card);
  if (err != cudaSuccess) return -(int)err;
  if (places < scratch_places(*card, Q, n_live, k))
    return -(int)cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(queries);
  const float* xf = static_cast<const float*>(delta);
  const int* sl = static_cast<const int*>(slots);
  float* od = static_cast<float*>(out_d);
  long long* os = static_cast<long long*>(out_s);
  float* pd = static_cast<float*>(part_d);
  int* ps = static_cast<int*>(part_s);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const bool vec4 = D % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(queries) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(delta) % 16 == 0;
  int launched = 0;
  for (int c0 = 0; c0 < k; c0 += PASS_K) {
    const Pass pass = plan_pass(*card, Q, n_live, k, c0);
    err = vec4 ? dispatch_pass<4>(pass, qf, xf, sl, Q, D, n_live, k, od, os,
                                  pd, ps, cs)
               : dispatch_pass<1>(pass, qf, xf, sl, Q, D, n_live, k, od, os,
                                  pd, ps, cs);
    if (err != cudaSuccess) return -(int)err;
    launched += 2;
  }
  return launched;
}

}  // extern "C"
