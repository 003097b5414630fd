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
// ma_pullback_rows_f32 replaces the TPU kernels ma_update and ma_update_rows
// of the same file: for k = 0..A-1,
//   dst[rows[k]] = (1-alpha) src[rows[k]] + alpha mean
// src, dst (R, n, 128) f32, mean (n, 128) f32. Rows not in rows are neither
// read nor written, which is the TPU kernels' input/output aliasing: they
// come back bitwise unchanged. With dst == src the pull-back is in place
// (HogwildSim's landings, where the stack is the sim's own buffer). With a
// separate dst it is out of place: ThreadedShadowRunner's trainer threads
// may still be reading the old plane on their own streams, so the round
// writes a new one, in the same single pass (no copy first). A row id
// outside [0, R) is skipped.
// Bound on this card: device-memory bytes, (2A + 1) planes (each listed row
// read and written once, the mean read once); 18 MiB at A = 4.
//
// Design (both): one thread per float4 of the plane, as the EASGD kernels. The
// loop over the listed ids runs inside the thread, never as a grid axis: it
// is the TPU's revisited output block (or its resident mean block) held in
// registers. Neighbouring threads read neighbouring 16-byte words of each
// plane, so every plane streams through once, coalesced.
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

// src and dst may be the same buffer (in place), so neither is __restrict__.
__global__ void ma_pullback_rows_kernel(const float4* src, float4* dst,
                                        const float4* __restrict__ mean,
                                        const int* __restrict__ rows, int n_rows, int n_replicas,
                                        long long nv, float alpha, float one_minus_alpha) {
  long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= nv) return;
  float4 g = __ldg(mean + e);
  for (int k = 0; k < n_rows; ++k) {
    int r = __ldg(rows + k);
    if (r < 0 || r >= n_replicas) continue;
    long long off = (long long)r * nv + e;
    dst[off] = lerp4(one_minus_alpha, src[off], alpha, g);
  }
}

extern "C" int ma_pullback_rows_f32(const void* src, void* dst, const void* mean,
                                    const void* rows, int n_rows, int n_replicas, long long n4,
                                    float alpha, float one_minus_alpha, void* stream) {
  if (n4 > 0 && n_rows > 0) {
    const int block = 256;
    long long grid = (n4 + block - 1) / block;
    ma_pullback_rows_kernel<<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
        (const float4*)src, (float4*)dst, (const float4*)mean, (const int*)rows, n_rows,
        n_replicas, n4, alpha, one_minus_alpha);
  }
  return (int)cudaGetLastError();
}
