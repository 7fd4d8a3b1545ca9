// Per-segment sums and sums of squares of every k-th row: phase 1 of the
// fused build (vector_database_tpu_torch/ops/sorted_build.py, inside the
// vdb_torch.build.moments span), which ranks the split dimensions.
//
// Replaces no Pallas kernel: the JAX build (vector_database_tpu/ops/
// sorted_build.py) leaves this pass to XLA, as prefix sums of the
// transposed rows differenced at the segment bounds, and the port did the
// same in plain PyTorch (segment_moments_reference) before this kernel.
//
// What it computes, for every segment s < S, whose samples are
//   lo = ceil(seg_start[s] / k), hi = ceil((seg_start[s] + seg_cnt[s]) / k)
// (sample j is row r(j) = j * k, or r(j) = rows[j * k] given a row index:
// the rows of x[::k], or of x[rows[::k]], inside the segment):
//   sums[s, d]  = the sum over j in [lo, hi) of x[r(j), d]
//   sumsq[s, d] = the sum over j in [lo, hi) of x[r(j), d]^2
// in f32, zeros where lo == hi. Segments lie in ascending order and do not
// overlap (seg_start[s] + seg_cnt[s] <= seg_start[s + 1]), as the build
// keeps them. Rows between segments (retired leaves) are never read.
//
// The build keeps its rows in place and partitions a row index instead
// (rows); the partition is stable, so rows ascends inside each segment and
// a warp's reads stay in row order, only sparser. The order of additions
// is the same with or without the index: the sums on (x, rows) are those
// on x[rows], bit for bit.
//
// What bounds it on an H100: bytes. Each sample row is read once and each
// segment writes 2 D floats: at 10M x 96 with k = 4 a level reads at most
// 2.5M x 384 B = 0.96 GB (0.29 ms at 3.35 TB/s), and the deepest levels
// write ~1.17M x 768 B besides. Two additions a value are nothing beside
// that.
//
// What the design does about it:
//  * The samples are cut into tiles of TILE consecutive samples, one warp
//    a tile. The lanes lie across a row, a float4 each where D % 4 == 0 and
//    the rows start on 16-byte boundaries, so a warp reads a 384-byte row
//    as three whole 128-byte lines, with U rows in flight. Given a row
//    index, a warp first copies its tile's sample rows from it into
//    shared memory (4 KB, the loads all in flight at once), so that no
//    row's address waits on a load of its own.
//  * A warp walks the segments that meet its tile in order (a binary
//    search finds the first; the lanes fetch 32 segments' bounds at once),
//    sums each one's rows of the tile in registers, in row order, and
//    writes the sums: to sums/sumsq where the segment meets this tile
//    alone, else to the tile's head partial (a segment begun in an earlier
//    tile) or its tail partial (a segment that goes on past the tile).
//  * A second kernel, one block a tile, finishes each segment that spans
//    tiles: its tail partial, then the head partials of the later tiles it
//    meets, summed in contiguous groups that are then added in order.
//  * The order of additions is fixed by the shape, k and the segment
//    bounds, with no atomics: one input gives the same bits on every run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 512;       // samples a warp's tile holds
constexpr int U = 8;            // rows a lane has in flight
constexpr int TILE_WARPS = 2;   // warps a block of the tile kernel
constexpr int COMBINE_THREADS = 1024;
constexpr unsigned FULL_MASK = 0xffffffffu;

struct Samples {
  long long lo, hi;
};

__device__ __forceinline__ Samples samples(const long long* start,
                                           const long long* cnt, int s,
                                           long long k) {
  const long long a = start[s];
  const long long b = a + cnt[s];
  return {(a + k - 1) / k, (b + k - 1) / k};
}

// The first and the last tile a segment's samples meet. A segment without
// samples belongs to the tile where its samples would start (the last tile
// where that is past the end). Both ascend with the segment index.
__device__ __forceinline__ int first_tile(const Samples& g, int T) {
  return (int)min(g.lo / TILE, (long long)(T - 1));
}

__device__ __forceinline__ int last_tile(const Samples& g, int T) {
  return g.hi > g.lo ? (int)((g.hi - 1) / TILE) : first_tile(g, T);
}

template <int VEC>
struct Vec;

template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ float zero() { return 0.f; }
  static __device__ __forceinline__ float stream(const float* p) {
    return __ldcs(p);
  }
  static __device__ __forceinline__ void add(float& s, float v) {
    s = __fadd_rn(s, v);
  }
  static __device__ __forceinline__ void add_sq(float& q, float v) {
    q = __fmaf_rn(v, v, q);
  }
};

template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ float4 zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ float4 stream(const float* p) {
    return __ldcs(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void add(float4& s, float4 v) {
    s.x = __fadd_rn(s.x, v.x);
    s.y = __fadd_rn(s.y, v.y);
    s.z = __fadd_rn(s.z, v.z);
    s.w = __fadd_rn(s.w, v.w);
  }
  static __device__ __forceinline__ void add_sq(float4& q, float4 v) {
    q.x = __fmaf_rn(v.x, v.x, q.x);
    q.y = __fmaf_rn(v.y, v.y, q.y);
    q.z = __fmaf_rn(v.z, v.z, q.z);
    q.w = __fmaf_rn(v.w, v.w, q.w);
  }
};

// One warp a tile of samples [t * TILE, min((t + 1) * TILE, ns)). head and
// tail hold [T, 2 D] partials (sums, then sums of squares); tail_seg[t] is
// the segment whose tail partial tile t wrote, or -1.
template <int VEC, bool ROWS>
__global__ void __launch_bounds__(TILE_WARPS * 32)
    moments_tiles(const float* __restrict__ x,
                  const long long* __restrict__ rows, long long sstride,
                  const long long* __restrict__ start,
                  const long long* __restrict__ cnt, int S, long long k,
                  int D, long long ns, int T, float* __restrict__ sums,
                  float* __restrict__ sumsq, float* __restrict__ head,
                  float* __restrict__ tail, int* __restrict__ tail_seg) {
  using V = Vec<VEC>;
  using VT = typename V::T;
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * TILE_WARPS + (threadIdx.x >> 5);
  if (t >= T) return;
  const long long t0 = (long long)t * TILE;
  const long long t1 = min(t0 + TILE, ns);
  // given a row index, the rows of the tile's samples, read once
  __shared__ long long rows_smem[ROWS ? TILE_WARPS * TILE : 1];
  long long* tile_rows = rows_smem + (ROWS ? (threadIdx.x >> 5) * TILE : 0);
  if (ROWS) {
    for (long long i = t0 + lane; i < t1; i += 32)
      tile_rows[i - t0] = rows[i * k];
    __syncwarp();
  }
  // the first segment whose last tile is t or later
  int f = 0, e = S;
  while (f < e) {
    const int m = (f + e) >> 1;
    if (last_tile(samples(start, cnt, m, k), T) < t)
      f = m + 1;
    else
      e = m;
  }
  int tail_s = -1;
  for (int c0 = 0; c0 < D; c0 += 32 * VEC) {
    const int c = c0 + lane * VEC;
    const bool on = c < D;
    bool done = false;
    for (int base = f; base < S && !done; base += 32) {
      Samples mine = {0, 0};
      if (base + lane < S) mine = samples(start, cnt, base + lane, k);
      const int n = min(32, S - base);
      for (int i = 0; i < n; ++i) {
        Samples g;
        g.lo = __shfl_sync(FULL_MASK, mine.lo, i);
        g.hi = __shfl_sync(FULL_MASK, mine.hi, i);
        const int ta = first_tile(g, T);
        if (ta > t) {
          done = true;
          break;
        }
        const int tb = last_tile(g, T);
        VT acc = V::zero(), acc2 = V::zero();
        const long long a = max(g.lo, t0), b = min(g.hi, t1);
        if (on) {
          for (long long j = a; j < b; j += U) {
            VT v[U];
#pragma unroll
            for (int u = 0; u < U; ++u)
              if (j + u < b)
                v[u] = V::stream(
                    x + (ROWS ? tile_rows[j + u - t0] : j + u) * sstride + c);
#pragma unroll
            for (int u = 0; u < U; ++u)
              if (j + u < b) {
                V::add(acc, v[u]);
                V::add_sq(acc2, v[u]);
              }
          }
        }
        const int s = base + i;
        float *ps, *pq;
        if (ta == tb) {
          ps = sums + (long long)s * D;
          pq = sumsq + (long long)s * D;
        } else {
          if (ta == t) tail_s = s;
          ps = (ta == t ? tail : head) + (long long)t * 2 * D;
          pq = ps + D;
        }
        if (on) {
          *reinterpret_cast<VT*>(ps + c) = acc;
          *reinterpret_cast<VT*>(pq + c) = acc2;
        }
      }
    }
  }
  if (lane == 0) tail_seg[t] = tail_s;
}

__device__ __forceinline__ void put(float* sums, float* sumsq, int s, int D,
                                    int e, float v) {
  (e < D ? sums + (long long)s * D + e : sumsq + (long long)s * D + e - D)[0] =
      v;
}

__device__ __forceinline__ void put(float* sums, float* sumsq, int s, int D,
                                    int e, float4 v) {
  *reinterpret_cast<float4*>(e < D ? sums + (long long)s * D + e
                                   : sumsq + (long long)s * D + e - D) = v;
}

// One block a tile t whose tail partial began a segment s: s's sums are
// tail[t] + head[t + 1] + ... + head[last tile of s]. A row of partials is
// cols elements of VEC floats, summed width = min(cols, COMBINE_THREADS)
// columns a pass: the head partials in COMBINE_THREADS / width contiguous
// groups, whose sums are added to the tail in group order.
template <int VEC>
__global__ void __launch_bounds__(COMBINE_THREADS)
    moments_combine(const long long* __restrict__ start,
                    const long long* __restrict__ cnt, long long k, int D,
                    int T, const float* __restrict__ head,
                    const float* __restrict__ tail,
                    const int* __restrict__ tail_seg,
                    float* __restrict__ sums, float* __restrict__ sumsq) {
  using V = Vec<VEC>;
  using VT = typename V::T;
  __shared__ VT red[COMBINE_THREADS];
  const int t = blockIdx.x;
  const int s = tail_seg[t];
  if (s < 0) return;
  const int tb = last_tile(samples(start, cnt, s, k), T);
  const int cols = 2 * D / VEC;
  const int width = min(cols, COMBINE_THREADS);
  const int groups = COMBINE_THREADS / width;
  const int grp = threadIdx.x / width;
  const long long P = tb - t;
  const int p0 = t + 1 + (int)(grp * P / groups);
  const int p1 = t + 1 + (int)((grp + 1) * P / groups);
  const VT* hp = reinterpret_cast<const VT*>(head);
  const VT* tp = reinterpret_cast<const VT*>(tail);
  for (int c0 = 0; c0 < cols; c0 += width) {
    const int c = c0 + threadIdx.x % width;
    VT part = V::zero();
    if (grp < groups && c < cols) {
#pragma unroll 8
      for (int p = p0; p < p1; ++p) V::add(part, hp[(long long)p * cols + c]);
    }
    red[threadIdx.x] = part;
    __syncthreads();
    if (grp == 0 && c < cols) {
      VT acc = tp[(long long)t * cols + c];
      for (int g = 0; g < groups; ++g) V::add(acc, red[g * width + c - c0]);
      put(sums, sumsq, s, D, c * VEC, acc);
    }
    __syncthreads();
  }
}

template <int VEC>
int launch(const float* x, const long long* rows, long long sstride,
           const long long* start, const long long* cnt, int S, long long k,
           int D, long long ns, int T, float* sums, float* sumsq, float* head,
           float* tail, int* tail_seg, cudaStream_t stream) {
  const int blocks = (T + TILE_WARPS - 1) / TILE_WARPS;
  if (rows)
    moments_tiles<VEC, true><<<blocks, TILE_WARPS * 32, 0, stream>>>(
        x, rows, sstride, start, cnt, S, k, D, ns, T, sums, sumsq, head,
        tail, tail_seg);
  else
    moments_tiles<VEC, false><<<blocks, TILE_WARPS * 32, 0, stream>>>(
        x, rows, sstride, start, cnt, S, k, D, ns, T, sums, sumsq, head,
        tail, tail_seg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || T == 1) return (int)err;
  moments_combine<VEC><<<T, COMBINE_THREADS, 0, stream>>>(
      start, cnt, k, D, T, head, tail, tail_seg, sums, sumsq);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Samples a tile holds: the wrapper sizes the partials from it.
int segment_moments_tile_samples(void) { return TILE; }

// x [*, D] f32 with rows row_stride floats apart (columns adjacent);
// rows null (position i is row i of x, n_rows of them) or [n_rows] int64
// (position i is row rows[i]); seg_start, seg_cnt [S] int64 positions,
// ascending and not overlapping; sums, sumsq [S, D] f32, contiguous; head,
// tail [T, 2 D] f32 and tail_seg [T] int32 scratch, T = max(1,
// ceil(ceil(n_rows / k) / TILE)). Returns a CUDA error code, 0 on success.
int segment_moments_launch(const void* x, long long row_stride,
                           const void* rows, const void* seg_start,
                           const void* seg_cnt, int S, long long k, int D,
                           long long n_rows, void* sums, void* sumsq,
                           void* head, void* tail, void* tail_seg, int T,
                           void* stream) {
  const long long ns = (n_rows + k - 1) / k;
  if (S < 0 || D < 1 || k < 1 || n_rows < 0 ||
      T != (int)(ns > TILE ? (ns + TILE - 1) / TILE : 1))
    return (int)cudaErrorInvalidValue;
  if (S == 0) return 0;
  // a sample's row is sstride floats on from the last without an index,
  // sstride floats a row of x with one
  const long long sstride = rows ? row_stride : row_stride * k;
  const long long* ri = static_cast<const long long*>(rows);
  const float* xf = static_cast<const float*>(x);
  const long long* st = static_cast<const long long*>(seg_start);
  const long long* ct = static_cast<const long long*>(seg_cnt);
  float *su = static_cast<float*>(sums), *sq = static_cast<float*>(sumsq);
  float *hd = static_cast<float*>(head), *tl = static_cast<float*>(tail);
  int* ts = static_cast<int*>(tail_seg);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (D % 4 == 0 && sstride % 4 == 0 &&
      reinterpret_cast<uintptr_t>(x) % 16 == 0)
    return launch<4>(xf, ri, sstride, st, ct, S, k, D, ns, T, su, sq, hd, tl,
                     ts, cs);
  return launch<1>(xf, ri, sstride, st, ct, S, k, D, ns, T, su, sq, hd, tl,
                   ts, cs);
}

}  // extern "C"
