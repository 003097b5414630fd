// Fused embedding lookup + sum-pool for Hopper (sm_90a).
//
// Replaces the TPU kernels embedding_bag / embedding_bag_blocked in
// src/repro/kernels/embedding_bag/embedding_bag.py: table (rows, d) f32,
// ids (n_bags, m) int32 -> out (n_bags, d) f32, out[b] = sum_j table[ids[b, j]].
//
// Bound on this card: device-memory bytes. Each bag gathers m random rows of
// d floats (256 B at d = 64) and writes one row; there is no reuse to speak
// of, so the least time is (n_bags*m*d + n_bags*m + n_bags*d) * 4 B over the
// memory rate. The TPU's scalar prefetch of the ids becomes each thread
// loading its bag's ids itself; the TPU lane padding of d to 128 is dropped.
//
// Design: d/4 consecutive threads own one bag, one float4 of the row each,
// so a row is read as d*4 contiguous bytes by neighbouring threads (16 B a
// thread, the card's widest load). Each thread sums its slice over the m ids
// in registers in id order j = 0..m-1, the order of the JAX oracle and the
// TPU kernel, then stores once. An id outside [0, rows) contributes NaN, as
// jnp.take's fill mode does; it is never dereferenced.
#include <cuda_runtime.h>
#include <math.h>

__global__ void embedding_bag_kernel(const float4* __restrict__ table, const int* __restrict__ ids,
                                     float4* __restrict__ out, long long n_bags, int m, int dv,
                                     long long n_rows) {
  long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= n_bags * dv) return;
  long long bag = t / dv;
  int v = (int)(t - bag * dv);
  const int* bag_ids = ids + bag * m;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int j = 0; j < m; ++j) {
    int r = __ldg(bag_ids + j);
    if (r < 0 || (long long)r >= n_rows) {
      s = make_float4(NAN, NAN, NAN, NAN);
      continue;
    }
    float4 x = __ldg(table + (long long)r * dv + v);
    s.x += x.x;
    s.y += x.y;
    s.z += x.z;
    s.w += x.w;
  }
  out[t] = s;
}

extern "C" int embedding_bag_f32(const void* table, const void* ids, void* out, long long n_bags,
                                 int m, int d, long long n_rows, void* stream) {
  int dv = d / 4;
  long long threads = n_bags * dv;
  if (threads > 0) {
    const int block = 256;
    long long grid = (threads + block - 1) / block;
    embedding_bag_kernel<<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
        (const float4*)table, (const int*)ids, (float4*)out, n_bags, m, dv, n_rows);
  }
  return (int)cudaGetLastError();
}
