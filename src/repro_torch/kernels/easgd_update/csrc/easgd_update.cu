// EASGD over flat replica space, for Hopper (sm_90a): the masked sequential
// round over the replica buffer (in place) and the single PS<->replica pair
// exchange (out of place).
//
// easgd_round_f32 replaces the TPU kernel easgd_round_update in
// src/repro/kernels/easgd_update/easgd_update.py. For each fired replica id
// in order k = 0..F-1:
//   ps <- (1-alpha) ps + alpha snap[k]
//   w[fired[k]] <- (1-alpha) w[fired[k]] + alpha ps
// stack (R, n, 128), ps (n, 128), snap (F, n, 128), all f32; fired (F,) int32.
//
// Bound on this card: device-memory bytes, (3F + 2) planes of n*128*4 B:
// each fired replica's plane is read and written, each snapshot plane read,
// the PS plane read and written once.
//
// Design: the grid is parallel over elements of the plane and never over the
// fired ids, because replica k+1 must see the PS that replica k moved. Each
// thread owns one float4 of the plane: it loads ps once, walks the fired ids
// in order with ps in registers, and stores ps at the end, which is the TPU
// kernel's VMEM-resident PS block as registers. Un-fired replicas are never
// read or written. A fired id outside [0, R) still moves the PS but writes
// nothing, as JAX drops an out-of-range .at[].set.
//
// easgd_pair_f32 replaces the TPU kernel easgd_update in the same file: one
// exchange between the PS plane and replica i's plane, both (n, 128) f32,
//   ps' = (1-alpha) ps + alpha w;   w' = (1-alpha) w + alpha ps'
// written to two NEW planes. It is out of place because the threaded runner's
// trainer threads may still be reading the old planes on their own streams.
// Bound on this card: device-memory bytes, 2 planes read and 2 written
// (8 MiB at n = 4096). One thread per float4: both planes are loaded once,
// both lerps run in registers (the second on the new PS), both results are
// stored once, which is the TPU kernel's single pass through VMEM.
#include <cuda_runtime.h>

__device__ __forceinline__ float4 lerp4(float c, float4 a, float alpha, float4 b) {
  return make_float4(c * a.x + alpha * b.x, c * a.y + alpha * b.y, c * a.z + alpha * b.z,
                     c * a.w + alpha * b.w);
}

__global__ void easgd_round_kernel(float4* __restrict__ stack, float4* __restrict__ ps,
                                   const float4* __restrict__ snap, const int* __restrict__ fired,
                                   int n_fired, int n_replicas, long long nv, float alpha,
                                   float one_minus_alpha) {
  long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= nv) return;
  float4 p = ps[e];
  for (int k = 0; k < n_fired; ++k) {
    int i = __ldg(fired + k);
    p = lerp4(one_minus_alpha, p, alpha, __ldg(snap + (long long)k * nv + e));
    if (i >= 0 && i < n_replicas) {
      float4* w = stack + (long long)i * nv + e;
      *w = lerp4(one_minus_alpha, *w, alpha, p);
    }
  }
  ps[e] = p;
}

extern "C" int easgd_round_f32(void* stack, void* ps, const void* snap, const void* fired,
                               int n_fired, int n_replicas, long long n_elems, float alpha,
                               float one_minus_alpha, void* stream) {
  long long nv = n_elems / 4;
  if (nv > 0) {
    const int block = 256;
    long long grid = (nv + block - 1) / block;
    easgd_round_kernel<<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
        (float4*)stack, (float4*)ps, (const float4*)snap, (const int*)fired, n_fired, n_replicas,
        nv, alpha, one_minus_alpha);
  }
  return (int)cudaGetLastError();
}

__global__ void easgd_pair_kernel(const float4* __restrict__ ps, const float4* __restrict__ w,
                                  float4* __restrict__ new_ps, float4* __restrict__ new_w,
                                  long long nv, float alpha, float one_minus_alpha) {
  long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= nv) return;
  float4 wi = w[e];
  float4 p = lerp4(one_minus_alpha, ps[e], alpha, wi);
  new_ps[e] = p;
  new_w[e] = lerp4(one_minus_alpha, wi, alpha, p);
}

extern "C" int easgd_pair_f32(const void* ps, const void* w, void* new_ps, void* new_w,
                              long long n_elems, float alpha, float one_minus_alpha,
                              void* stream) {
  long long nv = n_elems / 4;
  if (nv > 0) {
    const int block = 256;
    long long grid = (nv + block - 1) / block;
    easgd_pair_kernel<<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
        (const float4*)ps, (const float4*)w, (float4*)new_ps, (float4*)new_w, nv, alpha,
        one_minus_alpha);
  }
  return (int)cudaGetLastError();
}
