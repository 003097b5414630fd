// Fused row-sparse Adagrad for Hopper (sm_90a), in place, without atomics.
//
// Replaces the TPU kernels sparse_adagrad_rows / sparse_adagrad_blocked in
// src/repro/kernels/sparse_adagrad/sparse_adagrad.py. For every row r named
// by the occurrence list: acc[r] += sum g^2, then
// table[r] -= lr * rsqrt(acc_final[r] + eps) * sum g, the step scaled by the
// FINAL accumulator, duplicates accumulated. Rows not named stay bit-identical.
//
// Bound on this card: device-memory bytes. g (n_bags, d) is read, and each
// of the U distinct rows reads and writes its table and acc row (4 * d * 4 B).
//
// Design: the wrapper sorts the occurrences by row with a stable sort (as the
// TPU wrapper's argsort does), so each row's occurrences form one run, in
// their original order. d/4 consecutive threads take one occurrence position;
// those at the start of a run own the whole run: they read acc[r] once, walk
// the run in order adding g^2 into the accumulator and g into a running sum
// in registers, and write acc[r] and table[r] once. Each row is written by
// exactly one thread group, so no atomics are needed and the result is the
// same on every run. The walk fetches four occurrences at a time so that
// long runs (hot rows of the small tables) keep four loads in flight. A row
// id outside [0, n_rows) is dropped, as JAX drops out-of-range scatter updates.
#include <cuda_runtime.h>

__device__ __forceinline__ void accumulate(float4& a, float4& s, const float4 x) {
  a.x += x.x * x.x;
  a.y += x.y * x.y;
  a.z += x.z * x.z;
  a.w += x.w * x.w;
  s.x += x.x;
  s.y += x.y;
  s.z += x.z;
  s.w += x.w;
}

__global__ void sparse_adagrad_rows_kernel(float4* __restrict__ table, float4* __restrict__ acc,
                                           const int* __restrict__ rows,
                                           const int* __restrict__ bags,
                                           const float4* __restrict__ g, long long n_items,
                                           int dv, long long n_rows, float lr, float eps) {
  long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= n_items * dv) return;
  long long i = t / dv;
  int v = (int)(t - i * dv);
  int r = __ldg(rows + i);
  if (i > 0 && __ldg(rows + i - 1) == r) return;  // not the start of a run
  if (r < 0 || (long long)r >= n_rows) return;
  long long off = (long long)r * dv + v;
  float4 a = acc[off];
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long j = i;; j += 4) {
    bool ok[4];
    float4 x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      // rows are sorted: once an occurrence leaves the run, so do all after it
      ok[u] = j + u < n_items && __ldg(rows + j + u) == r;
      if (ok[u]) x[u] = __ldg(g + (long long)__ldg(bags + j + u) * dv + v);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (ok[u]) accumulate(a, s, x[u]);
    if (!ok[3]) break;
  }
  float4 w = table[off];
  w.x -= lr * rsqrtf(a.x + eps) * s.x;
  w.y -= lr * rsqrtf(a.y + eps) * s.y;
  w.z -= lr * rsqrtf(a.z + eps) * s.z;
  w.w -= lr * rsqrtf(a.w + eps) * s.w;
  table[off] = w;
  acc[off] = a;
}

extern "C" int sparse_adagrad_rows_f32(void* table, void* acc, const void* rows, const void* bags,
                                       const void* g, long long n_items, int d, long long n_rows,
                                       float lr, float eps, void* stream) {
  int dv = d / 4;
  long long threads = n_items * dv;
  if (threads > 0) {
    const int block = 256;
    long long grid = (threads + block - 1) / block;
    sparse_adagrad_rows_kernel<<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
        (float4*)table, (float4*)acc, (const int*)rows, (const int*)bags, (const float4*)g,
        n_items, dv, n_rows, lr, eps);
  }
  return (int)cudaGetLastError();
}
