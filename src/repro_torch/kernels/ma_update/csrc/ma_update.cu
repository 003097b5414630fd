// Model Averaging (paper Algorithm 3) over flat replica space, for Hopper
// (sm_90a): the replica mean over a list of replica ids, and the elastic
// pull-back of a list of replicas toward a mean plane.
//
// replica_mean_rows_f32 replaces the TPU kernels replica_mean and
// replica_mean_rows of src/repro/kernels/ma_update/ma_update.py:
//   out = (sum over k = 0..A-1 of stack[rows[k]]) * (1/A)
// stack (R, n, 128) f32, rows (A,) int32, out (n, 128) f32. The all-replica
// mean passes rows = 0..R-1. The sum runs in the order of rows into an f32
// accumulator that starts at zero, then is multiplied by the reciprocal of
// A, as the TPU kernels do (their revisited output block, scaled at the last
// grid step); the plain version (torch.mean) sums and divides, so the two
// may differ by an ulp. A row id outside [0, R) makes the mean NaN, so a
// bad id is loud rather than a silent wrong mean.
// Bound on this card: device-memory bytes, (A + 1) planes of n*128*4 B (each
// listed replica read once, the mean written once); 10 MiB at A = 4, n = 4096.
// Out of place: the mean is a new plane (the launch snapshot of MA and BMUF,
// and a joiner's bootstrap).
//
// ma_pullback_all_f32 and ma_pullback_rows_f32 replace the TPU kernels
// ma_update and ma_update_rows of the same file: for every row r (all, or
// each listed id in order),
//   dst[r] = (1-alpha) src[r] + alpha mean
// src, dst (R, n, 128) f32, mean (n, 128) f32. Rows not listed are neither
// read nor written, which is the TPU kernels' input/output aliasing: they
// come back bitwise unchanged. With dst == src the pull-back is in place
// (HogwildSim's landings, where the stack is the sim's own buffer). With a
// separate dst it is out of place: ThreadedShadowRunner's trainer threads
// may still be reading the old plane on their own streams, so the round
// writes a new one, in the same single pass (no copy first). A listed id
// outside [0, R) is skipped.
// Bound on this card: device-memory bytes, (2A + 1) planes (each row read
// and written once, the mean read once); 18 MiB at A = 4.
//
// Design (mean): one thread per float4 of the plane, as the EASGD kernels.
// The loop over the listed ids runs inside the thread, never as a grid axis:
// it is the TPU's revisited output block held in registers. Neighbouring
// threads read neighbouring 16-byte words of each plane, so every plane
// streams through once, coalesced.
// Design (pull-back): the same loop, with nothing read from device memory
// before the planes and the first row's loads issued with the mean's. The
// all-rows kernel (every landing of HogwildSim's MA and the threaded round's
// one-plane pull-back) has no id list: row k is k and needs no range check,
// so its loads wait on nothing; on a 2 MiB plane a check before them showed
// in the time. The listed kernel (the elastic forms) takes the ids as a
// launch parameter from the host list the caller keeps.
#include <cuda_runtime.h>

__device__ __forceinline__ float4 lerp4(float c, float4 a, float alpha, float4 b) {
  return make_float4(c * a.x + alpha * b.x, c * a.y + alpha * b.y, c * a.z + alpha * b.z,
                     c * a.w + alpha * b.w);
}

__global__ void replica_mean_rows_kernel(const float4* __restrict__ stack,
                                         const int* __restrict__ rows, int n_rows,
                                         int n_replicas, float4* __restrict__ out, long long nv,
                                         float inv) {
  long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= nv) return;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k = 0; k < n_rows; ++k) {
    int r = __ldg(rows + k);
    if (r < 0 || r >= n_replicas) {
      const float nan = __int_as_float(0x7fc00000);
      acc = make_float4(nan, nan, nan, nan);
      break;
    }
    float4 x = __ldg(stack + (long long)r * nv + e);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  out[e] = make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
}

extern "C" int replica_mean_rows_f32(const void* stack, const void* rows, int n_rows,
                                     int n_replicas, void* out, long long n4, void* stream) {
  if (n4 > 0 && n_rows > 0) {
    const int block = 256;
    long long grid = (n4 + block - 1) / block;
    replica_mean_rows_kernel<<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
        (const float4*)stack, (const int*)rows, n_rows, n_replicas, (float4*)out, n4,
        1.0f / (float)n_rows);
  }
  return (int)cudaGetLastError();
}

constexpr int MAX_IDS = 64;  // replica ids a listed pull-back launch takes by value

// The listed ids, a launch parameter (read from the constant bank); an id
// outside [0, R) is skipped.
struct RowIds {
  static constexpr bool checked = true;
  int n;
  int id[MAX_IDS];
  __device__ int operator[](int k) const { return id[k]; }
};

// Every row 0..n-1: no list at all, nothing to check.
struct AllRows {
  static constexpr bool checked = false;
  int n;
  __device__ int operator[](int k) const { return k; }
};

// VEC float4 words a thread, a block's width apart. The first listed row's
// loads issue with the mean's; each later row's after the row before is
// stored (in place, that row may be the one just written).
// src and dst may be the same buffer (in place), so neither is __restrict__.
template <int VEC, class Ids>
__device__ __forceinline__ void pullback(const float4* src, float4* dst,
                                         const float4* __restrict__ mean, const Ids& ids,
                                         int n_replicas, long long nv, float alpha,
                                         float one_minus_alpha) {
  const long long e0 = (long long)blockIdx.x * blockDim.x * VEC + threadIdx.x;
  float4 g[VEC], x[VEC];
  int r = ids[0];
  bool ok = !Ids::checked || (r >= 0 && r < n_replicas);
#pragma unroll
  for (int u = 0; u < VEC; ++u) {
    const long long e = e0 + (long long)u * blockDim.x;
    if (e < nv) {
      g[u] = __ldg(mean + e);
      if (ok) x[u] = src[(long long)r * nv + e];
    }
  }
  for (int k = 0;;) {
    if (ok) {
#pragma unroll
      for (int u = 0; u < VEC; ++u) {
        const long long e = e0 + (long long)u * blockDim.x;
        if (e < nv) dst[(long long)r * nv + e] = lerp4(one_minus_alpha, x[u], alpha, g[u]);
      }
    }
    if (++k >= ids.n) break;
    r = ids[k];
    ok = !Ids::checked || (r >= 0 && r < n_replicas);
    if (ok) {
#pragma unroll
      for (int u = 0; u < VEC; ++u) {
        const long long e = e0 + (long long)u * blockDim.x;
        if (e < nv) x[u] = src[(long long)r * nv + e];
      }
    }
  }
}

constexpr int ALL_VEC = 2, ALL_BLOCK = 512;   // one (4096, 128) plane: 128 blocks
constexpr int ROWS_VEC = 1, ROWS_BLOCK = 256;

__global__ void ma_pullback_all_kernel(const float4* src, float4* dst,
                                       const float4* __restrict__ mean, int n_replicas,
                                       long long nv, float alpha, float one_minus_alpha) {
  pullback<ALL_VEC>(src, dst, mean, AllRows{n_replicas}, n_replicas, nv, alpha, one_minus_alpha);
}

__global__ void ma_pullback_rows_kernel(const float4* src, float4* dst,
                                        const float4* __restrict__ mean,
                                        const __grid_constant__ RowIds ids, int n_replicas,
                                        long long nv, float alpha, float one_minus_alpha) {
  pullback<ROWS_VEC>(src, dst, mean, ids, n_replicas, nv, alpha, one_minus_alpha);
}

static long long blocks(long long n4, int vec, int block) {
  return (n4 + (long long)vec * block - 1) / ((long long)vec * block);
}

// Every row of src (n_replicas planes of n4 float4 words).
extern "C" int ma_pullback_all_f32(const void* src, void* dst, const void* mean, int n_replicas,
                                   long long n4, float alpha, float one_minus_alpha,
                                   void* stream) {
  if (n4 > 0 && n_replicas > 0)
    ma_pullback_all_kernel<<<(unsigned)blocks(n4, ALL_VEC, ALL_BLOCK), ALL_BLOCK, 0,
                             (cudaStream_t)stream>>>((const float4*)src, (float4*)dst,
                                                     (const float4*)mean, n_replicas, n4, alpha,
                                                     one_minus_alpha);
  return (int)cudaGetLastError();
}

// The listed rows; ids: n_ids host ints, MAX_IDS a launch, in order.
extern "C" int ma_pullback_rows_f32(const void* src, void* dst, const void* mean,
                                    const int* ids, int n_ids, int n_replicas, long long n4,
                                    float alpha, float one_minus_alpha, void* stream) {
  if (n4 > 0) {
    for (int k0 = 0; k0 < n_ids; k0 += MAX_IDS) {
      RowIds list;
      list.n = n_ids - k0 < MAX_IDS ? n_ids - k0 : MAX_IDS;
      for (int k = 0; k < list.n; ++k) list.id[k] = ids[k0 + k];
      ma_pullback_rows_kernel<<<(unsigned)blocks(n4, ROWS_VEC, ROWS_BLOCK), ROWS_BLOCK, 0,
                                (cudaStream_t)stream>>>((const float4*)src, (float4*)dst,
                                                        (const float4*)mean, list, n_replicas,
                                                        n4, alpha, one_minus_alpha);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return (int)cudaGetLastError();
}
