// Fused row-sparse Adagrad for Hopper (sm_90a), in place, without atomics.
//
// Replaces the TPU kernels sparse_adagrad_rows / sparse_adagrad_blocked in
// src/repro/kernels/sparse_adagrad/sparse_adagrad.py. For every row r named
// by the occurrence list: acc[r] += sum g^2, then
// table[r] -= lr * rsqrt(acc_final[r] + eps) * sum g, the step scaled by the
// FINAL accumulator, duplicates accumulated. Rows not named stay bit-identical.
// A row id outside [0, n_rows) is dropped, as JAX drops out-of-range scatter
// updates.
//
// Bound on this card: device-memory bytes. g (n_bags, d), the sorted ids and
// the bags are read once, and each of the U distinct rows reads and writes
// its table and acc row (4 * d * 4 B).
//
// Input: the occurrence list sorted by row with a stable sort (the TPU
// wrapper's argsort), as the sorted ids and the sort's permutation; an
// occurrence's bag is its unsorted position / m. Each row's occurrences form
// one run, in their original order.
//
// Design: a run's length follows the data's skew (a hot row of a small table
// holds ~10^3 occurrences in one DLRM batch; a click log can put a quarter of
// a batch on one row), so no thread walks a run. The sorted list is cut into
// tiles of TILE positions, one block each:
//   1. sparse_adagrad_tile_kernel: every (position, lane) thread reads its
//      position's id and bag (words the whole block shares) and loads its g
//      word at once: no thread walks a rows -> bags -> g chain occurrence
//      after occurrence. The thread group at each run's first position in
//      the tile then sums the run's g^2 and g from shared memory in order. A
//      run wholly inside the tile is finished there: acc[r] + the g^2 in
//      order, then table[r], each written once (their loads issue with the g
//      loads). A run that crosses a tile boundary leaves its partial (sum
//      g^2, sum g, from zero) in a scratch slot of the tile instead: slot 1
//      in the tile where it begins, slot 0 in each later tile, so at most two
//      partials a tile.
//   2. sparse_adagrad_combine_kernel: one warp a tile. The warp of a tile in
//      which a crossing run begins finds the run's last tile (a lane a tile
//      boundary), sums the run's partials in tile order in contiguous chunks,
//      one chunk a thread group, and adds the chunks to acc[r] in order, then
//      writes table[r], each once. A run that goes on past the next 32 tiles
//      is left to the warp's whole block, which does the same with all its
//      threads once its warps are done.
// Every row is written by exactly one thread group and every sum is taken in
// a fixed order, so the result is the same on every run. A tile's serial
// work is at most TILE shared-memory steps; a crossing run's combine keeps a
// chunk's loads in flight together. No run length sets the kernels' time.
#include <climits>
#include <cuda_runtime.h>

constexpr int TILE = 32;             // sorted occurrence positions a tile
constexpr int MAX_LANES = 32;        // float4 words of a row a thread group covers a pass
constexpr int TILE_MIN_BLOCKS = 2;   // of TILE * MAX_LANES threads an SM: 32 registers a thread
constexpr int COMBINE_THREADS = 512;  // a combine block: one warp a tile

__device__ __forceinline__ bool in_range(int r, long long n_rows) {
  return r >= 0 && (long long)r < n_rows;
}

__device__ __forceinline__ void add_sq(float4& q, float4& s, const float4 x) {
  q.x += x.x * x.x;
  q.y += x.y * x.y;
  q.z += x.z * x.z;
  q.w += x.w * x.w;
  s.x += x.x;
  s.y += x.y;
  s.z += x.z;
  s.w += x.w;
}

__device__ __forceinline__ void add4(float4& a, const float4 x) {
  a.x += x.x;
  a.y += x.y;
  a.z += x.z;
  a.w += x.w;
}

// table[off] -= lr * rsqrt(a + eps) * s; acc[off] = a
__device__ __forceinline__ void apply_row(float4* table, float4* acc, long long off, float4 w,
                                          const float4 a, const float4 s, float lr, float eps) {
  w.x -= lr * rsqrtf(a.x + eps) * s.x;
  w.y -= lr * rsqrtf(a.y + eps) * s.y;
  w.z -= lr * rsqrtf(a.z + eps) * s.z;
  w.w -= lr * rsqrtf(a.w + eps) * s.w;
  table[off] = w;
  acc[off] = a;
}

// partial[tile][slot][0: sum g^2, 1: sum g][dv]
__device__ __forceinline__ long long partial_at(long long tile, int slot, int dv) {
  return (tile * 2 + slot) * 2 * (long long)dv;
}

// One block a tile, TILE * lanes threads: thread (p, lane) owns position p
// and the words lane, lane + lanes, ... of the row. Each thread reads its
// position's id, bag and neighbours itself (the same few words for the whole
// block), so its acc, table and g loads issue before the block first waits.
__global__ void __launch_bounds__(TILE * MAX_LANES, TILE_MIN_BLOCKS)
sparse_adagrad_tile_kernel(float4* __restrict__ table, float4* __restrict__ acc,
                           const int* __restrict__ rows, const long long* __restrict__ order,
                           int m, const float4* __restrict__ g, long long n_items, int dv,
                           int lanes, long long n_rows, float lr, float eps,
                           float4* __restrict__ partial) {
  __shared__ int s_row[TILE];
  __shared__ float4 s_x[TILE * MAX_LANES];
  const long long tile = blockIdx.x;
  const long long base = tile * TILE;
  const int n = (int)min((long long)TILE, n_items - base);
  const int tid = threadIdx.x;
  if (tid < n) s_row[tid] = __ldg(rows + base + tid);
  const int p = tid / lanes, lane = tid - p * lanes;
  const bool live = p < n;
  const int r = live ? __ldg(rows + base + p) : -1;
  const bool head = live && (p == 0 || __ldg(rows + base + p - 1) != r) && in_range(r, n_rows);
  // the run began in an earlier tile / goes on in the next (sorted: then it fills the tile's end)
  const bool first = p == 0 && base > 0 && __ldg(rows + base - 1) == r;
  const bool last = live && base + n < n_items && __ldg(rows + base + n) == r;
  const bool finish = head && !first && !last;
  const long long bag = live ? (int)__ldg(order + base + p) / m : 0;
  for (int v0 = 0; v0 < dv; v0 += lanes) {
    const int v = v0 + lane;
    const long long off = (long long)r * dv + v;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), w = a;
    if (finish && v < dv) {
      a = acc[off];
      w = table[off];
    }
    if (live && v < dv) s_x[p * lanes + lane] = __ldg(g + bag * dv + v);
    __syncthreads();
    if (head && v < dv) {
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int j = p; j < n && s_row[j] == r; ++j) add_sq(a, s, s_x[j * lanes + lane]);
      if (finish) {
        apply_row(table, acc, off, w, a, s, lr, eps);
      } else {
        float4* slot = partial + partial_at(tile, first ? 0 : 1, dv) + v;
        slot[0] = a;
        slot[dv] = s;
      }
    }
    if (v0 + lanes < dv) __syncthreads();  // s_x is refilled by the next pass
  }
}

// Whether a crossing run begins in ``tile`` (its last run goes on in the next
// tile and did not come from the one before); if so, its row in ``r``.
__device__ __forceinline__ bool begins_crossing_run(const int* __restrict__ rows, long long tile,
                                                    long long n_tiles, long long n_items,
                                                    long long n_rows, int& r) {
  if (tile >= n_tiles) return false;
  const long long base = tile * TILE;
  const long long stop = min(base + TILE, n_items);  // one past the tile's last position
  if (stop >= n_items) return false;
  r = __ldg(rows + stop - 1);
  if (__ldg(rows + stop) != r || !in_range(r, n_rows)) return false;  // none, or dropped
  return !(base > 0 && __ldg(rows + base) == r && __ldg(rows + base - 1) == r);
}

// Whether the run of row r that covers tile t's last position ends there.
__device__ __forceinline__ bool ends_in(const int* __restrict__ rows, long long t,
                                        long long n_items, int r) {
  const long long after = (t + 1) * TILE;
  return after >= n_items || __ldg(rows + after) != r;
}

// The address of part k of the run that begins in ``tile``: k = 0 is slot 1
// of that tile, k >= 1 slot 0 of tile + k.
__device__ __forceinline__ const float4* part_at(const float4* partial, int tile, int k, int dv) {
  return partial + (k == 0 ? partial_at(tile, 1, dv) : partial_at((long long)tile + k, 0, dv));
}

// Sum of parts [lo, hi) of a run, in order, for word v, UNROLL parts' loads
// in flight.
template <int UNROLL>
__device__ __forceinline__ void sum_parts(const float4* partial, int tile, int lo, int hi, int dv,
                                          int v, float4& q, float4& s) {
#pragma unroll UNROLL
  for (int k = lo; k < hi; ++k) {
    const float4* part = part_at(partial, tile, k, dv) + v;
    add4(q, __ldg(part));
    add4(s, __ldg(part + dv));
  }
}

__device__ __forceinline__ float4 shfl4(const float4 x, int from) {
  return make_float4(__shfl_sync(0xffffffffu, x.x, from), __shfl_sync(0xffffffffu, x.y, from),
                     __shfl_sync(0xffffffffu, x.z, from), __shfl_sync(0xffffffffu, x.w, from));
}

// One warp combines the run of row r that begins in ``tile`` when it ends
// within the next 32 tiles (one a lane): the parts in 32 / lanes contiguous
// chunks, the chunks in order. Returns false, having done nothing, for a
// longer run.
__device__ bool warp_combine_run(float4* __restrict__ table, float4* __restrict__ acc,
                                 const int* __restrict__ rows, long long n_items, int n_tiles,
                                 int dv, int lanes, float lr, float eps,
                                 const float4* __restrict__ partial, int tile, int r) {
  const int l = threadIdx.x & 31;
  const int t = tile + 1 + l;
  const unsigned found = __ballot_sync(0xffffffffu, t < n_tiles && ends_in(rows, t, n_items, r));
  if (found == 0) return false;
  const int n_parts = __ffs(found) + 1;  // the run's last tile is tile + __ffs(found)
  const int chunks = 32 / lanes;
  const int c = l / lanes, lane = l - c * lanes;
  const int per = (n_parts + chunks - 1) / chunks;
  const int lo = min(c * per, n_parts), hi = min(lo + per, n_parts);
  for (int v0 = 0; v0 < dv; v0 += lanes) {
    const int v = v0 + lane;
    const long long off = (long long)r * dv + v;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), w = a, q = a, s = a, sum = a;
    if (c == 0 && v < dv) {
      a = acc[off];
      w = table[off];
    }
    if (c < chunks && v < dv) sum_parts<4>(partial, tile, lo, hi, dv, v, q, s);
    for (int cc = 0; cc < chunks; ++cc) {
      add4(a, shfl4(q, cc * lanes + lane));
      add4(sum, shfl4(s, cc * lanes + lane));
    }
    if (c == 0 && v < dv) apply_row(table, acc, off, w, a, sum, lr, eps);
  }
  return true;
}

// The first tile t >= from in which the run of row r ends, found by the
// whole block: ends_in is false up to that tile and true from it on, so one
// pass tests every blockDim-th tile, and a second the blockDim tiles before
// the first hit. The last tile ends every run.
__device__ int block_find_end(const int* __restrict__ rows, int from, int n_tiles,
                              long long n_items, int r, int* s_first) {
  for (int stride = blockDim.x;; stride = 1) {
    if (threadIdx.x == 0) *s_first = INT_MAX;
    __syncthreads();
    for (long long i0 = 0;; i0 += blockDim.x) {
      const long long t = from + (i0 + threadIdx.x) * stride;
      const bool ends = t >= n_tiles - 1 || ends_in(rows, t, n_items, r);
      if (__syncthreads_or(ends)) {
        if (ends) atomicMin(s_first, (int)(i0 + threadIdx.x));
        __syncthreads();
        break;
      }
    }
    const int i = *s_first;
    if (stride == 1) return min(from + i, n_tiles - 1);
    if (i == 0) return from;
    from += (i - 1) * stride + 1;
    __syncthreads();  // every thread has read s_first before it is set again
  }
}

// The whole block combines the run that begins in ``tile``, however long:
// it finds the run's last tile (block_find_end), then sums the parts in
// COMBINE_THREADS / lanes contiguous chunks, the chunks in order. Called by
// every thread of the block.
__device__ void block_combine_run(float4* __restrict__ table, float4* __restrict__ acc,
                                  const int* __restrict__ rows, long long n_items, int n_tiles,
                                  int dv, int lanes, float lr, float eps,
                                  const float4* __restrict__ partial, int tile, int* s_first,
                                  float4* s_q, float4* s_s) {
  const int r = __ldg(rows + min((long long)(tile + 1) * TILE, n_items) - 1);
  const int end = block_find_end(rows, tile + 1, n_tiles, n_items, r, s_first);
  const int n_parts = end - tile + 1;
  const int chunks = blockDim.x / lanes;
  const int c = threadIdx.x / lanes, lane = threadIdx.x - c * lanes;
  const int per = (n_parts + chunks - 1) / chunks;
  const int lo = min(c * per, n_parts), hi = min(lo + per, n_parts);
  for (int v0 = 0; v0 < dv; v0 += lanes) {
    const int v = v0 + lane;
    const long long off = (long long)r * dv + v;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), w = a, q = a, s = a;
    if (c == 0 && v < dv) {
      a = acc[off];
      w = table[off];
    }
    if (c < chunks && v < dv) sum_parts<8>(partial, tile, lo, hi, dv, v, q, s);
    s_q[threadIdx.x] = q;
    s_s[threadIdx.x] = s;
    __syncthreads();
    if (c == 0 && v < dv) {
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int cc = 0; cc < chunks; ++cc) {
        add4(a, s_q[cc * lanes + lane]);
        add4(sum, s_s[cc * lanes + lane]);
      }
      apply_row(table, acc, off, w, a, sum, lr, eps);
    }
    __syncthreads();  // s_q, s_s are refilled by the next pass or run
  }
}

// One warp a tile, COMBINE_THREADS / 32 tiles a block: the warp of a tile in
// which a crossing run begins combines it, or leaves a run that goes on past
// the next 32 tiles to the whole block, after the warps are done.
__global__ void __launch_bounds__(COMBINE_THREADS)
sparse_adagrad_combine_kernel(float4* __restrict__ table, float4* __restrict__ acc,
                              const int* __restrict__ rows, long long n_items, int n_tiles,
                              int dv, int lanes, long long n_rows, float lr, float eps,
                              const float4* __restrict__ partial) {
  __shared__ unsigned s_long;  // warps whose run is left to the block
  __shared__ int s_first;
  __shared__ float4 s_q[COMBINE_THREADS], s_s[COMBINE_THREADS];
  const int warp = threadIdx.x >> 5;
  const long long tile0 = (long long)blockIdx.x * (COMBINE_THREADS / 32);
  if (threadIdx.x == 0) s_long = 0;
  __syncthreads();
  int r;
  if (begins_crossing_run(rows, tile0 + warp, n_tiles, n_items, n_rows, r) &&
      !warp_combine_run(table, acc, rows, n_items, n_tiles, dv, lanes, lr, eps, partial,
                        (int)tile0 + warp, r) &&
      (threadIdx.x & 31) == 0)
    atomicOr(&s_long, 1u << warp);
  __syncthreads();
  for (unsigned mask = s_long; mask != 0; mask &= mask - 1)
    block_combine_run(table, acc, rows, n_items, n_tiles, dv, lanes, lr, eps, partial,
                      (int)tile0 + __ffs(mask) - 1, &s_first, s_q, s_s);
}

extern "C" int sparse_adagrad_tile_size() { return TILE; }

// partial: (n_tiles, 2, 2, d) f32 scratch, n_tiles = ceil(n_items / TILE).
extern "C" int sparse_adagrad_rows_f32(void* table, void* acc, const void* rows,
                                       const void* order, long long m, const void* g,
                                       long long n_items, int d, long long n_rows, float lr,
                                       float eps, void* partial, long long n_tiles,
                                       void* stream) {
  if (n_items <= 0) return (int)cudaGetLastError();
  if (n_tiles != (n_items + TILE - 1) / TILE || n_items > INT_MAX || m <= 0 || m > INT_MAX ||
      d % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const int dv = d / 4, lanes = dv < MAX_LANES ? dv : MAX_LANES;
  cudaStream_t s = (cudaStream_t)stream;
  sparse_adagrad_tile_kernel<<<(unsigned)n_tiles, TILE * lanes, 0, s>>>(
      (float4*)table, (float4*)acc, (const int*)rows, (const long long*)order, (int)m,
      (const float4*)g, n_items, dv, lanes, n_rows, lr, eps, (float4*)partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_tiles == 1) return (int)err;
  const long long tiles_a_block = COMBINE_THREADS / 32;
  sparse_adagrad_combine_kernel<<<(unsigned)((n_tiles + tiles_a_block - 1) / tiles_a_block),
                                  COMBINE_THREADS, 0, s>>>(
      (float4*)table, (float4*)acc, (const int*)rows, n_items, (int)n_tiles, dv, lanes, n_rows,
      lr, eps, (const float4*)partial);
  return (int)cudaGetLastError();
}
