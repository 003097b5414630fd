// Gossip (ADPSGD-style pairwise averaging) over flat replica space, for
// Hopper (sm_90a): the symmetric exchange of two planes (out of place) and a
// whole round of pair landings over the replica buffer (in place).
//
// gossip_pair_f32 replaces the TPU kernel gossip_pair_update of
// src/repro/kernels/gossip_update/gossip_update.py:
//   mix = 0.5 (a + b);  a' = (1-alpha) a + alpha mix;  b' = (1-alpha) b + alpha mix
// a, b (n, 128) f32, written to two NEW planes a', b'. Out of place because
// ThreadedShadowRunner's trainer threads may still be reading the old planes
// on their own streams.
// Bound on this card: device-memory bytes, 2 planes read and 2 written
// (8 MiB at n = 4096).
//
// gossip_round_f32 replaces the TPU kernel gossip_round_update of the same
// file: for each participant p = 0..P-1,
//   mix = 0.5 (snap[self_pos[p]] + snap[partner_pos[p]])
//   stack[land[p]] = (1-alpha) stack[land[p]] + alpha mix
// stack (R, n, 128), snap (F, n, 128) f32; land, self_pos, partner_pos (P,)
// int32. In place on the stack (HogwildSim's own buffer; the reference
// donates it), so rows not in land are neither read nor written and come
// back bitwise unchanged. snap is the launch snapshot, a separate buffer (the
// wrapper refuses a view of the stack): the landing reads it, never the
// moving stack. A land id outside [0, R) is skipped; a position outside
// [0, F) makes that row's mix NaN.
// Bound on this card: device-memory bytes of the unique planes, 3P: each
// participant's row read and written, and its own snapshot plane read (each
// snapshot plane is some participant's own and another's partner, so it
// counts once); 24 MiB at P = 4.
//
// Design: one thread per float4. The participants' rows are distinct and have
// no order between them, so the round's grid is 2-D: x over the float4s of a
// plane, y over the participants; each thread reads its two snapshot words
// and its row's word once and mixes in registers, which is the TPU kernel's
// two index maps onto one snapshot without a mixed plane in memory.
#include <cuda_runtime.h>

__device__ __forceinline__ float4 lerp4(float c, float4 a, float alpha, float4 b) {
  return make_float4(c * a.x + alpha * b.x, c * a.y + alpha * b.y, c * a.z + alpha * b.z,
                     c * a.w + alpha * b.w);
}

__device__ __forceinline__ float4 mix4(float4 a, float4 b) {
  return make_float4(0.5f * (a.x + b.x), 0.5f * (a.y + b.y), 0.5f * (a.z + b.z),
                     0.5f * (a.w + b.w));
}

__global__ void gossip_pair_kernel(const float4* __restrict__ a, const float4* __restrict__ b,
                                   float4* __restrict__ out_a, float4* __restrict__ out_b,
                                   long long nv, float alpha, float one_minus_alpha) {
  long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= nv) return;
  float4 x = __ldg(a + e), y = __ldg(b + e);
  float4 m = mix4(x, y);
  out_a[e] = lerp4(one_minus_alpha, x, alpha, m);
  out_b[e] = lerp4(one_minus_alpha, y, alpha, m);
}

extern "C" int gossip_pair_f32(const void* a, const void* b, void* out_a, void* out_b,
                               long long n4, float alpha, float one_minus_alpha, void* stream) {
  if (n4 > 0) {
    const int block = 256;
    long long grid = (n4 + block - 1) / block;
    gossip_pair_kernel<<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
        (const float4*)a, (const float4*)b, (float4*)out_a, (float4*)out_b, n4, alpha,
        one_minus_alpha);
  }
  return (int)cudaGetLastError();
}

__global__ void gossip_round_kernel(float4* __restrict__ stack, const float4* __restrict__ snap,
                                    const int* __restrict__ land,
                                    const int* __restrict__ self_pos,
                                    const int* __restrict__ partner_pos, int n_replicas,
                                    int n_snap, long long nv, float alpha,
                                    float one_minus_alpha) {
  long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  int p = blockIdx.y;
  if (e >= nv) return;
  int r = __ldg(land + p);
  if (r < 0 || r >= n_replicas) return;
  int s = __ldg(self_pos + p), q = __ldg(partner_pos + p);
  float4 m;
  if (s < 0 || s >= n_snap || q < 0 || q >= n_snap) {
    const float nan = __int_as_float(0x7fc00000);
    m = make_float4(nan, nan, nan, nan);
  } else {
    m = mix4(__ldg(snap + (long long)s * nv + e), __ldg(snap + (long long)q * nv + e));
  }
  float4* w = stack + (long long)r * nv + e;
  *w = lerp4(one_minus_alpha, *w, alpha, m);
}

extern "C" int gossip_round_f32(void* stack, const void* snap, const void* land,
                                const void* self_pos, const void* partner_pos, int n_part,
                                int n_replicas, int n_snap, long long n4, float alpha,
                                float one_minus_alpha, void* stream) {
  if (n4 > 0 && n_part > 0) {
    const int block = 256;
    long long grid = (n4 + block - 1) / block;
    dim3 g((unsigned)grid, (unsigned)n_part);
    gossip_round_kernel<<<g, block, 0, (cudaStream_t)stream>>>(
        (float4*)stack, (const float4*)snap, (const int*)land, (const int*)self_pos,
        (const int*)partner_pos, n_replicas, n_snap, n4, alpha, one_minus_alpha);
  }
  return (int)cudaGetLastError();
}
