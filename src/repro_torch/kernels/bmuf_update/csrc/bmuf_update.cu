// BMUF (paper Algorithm 4) landing over flat replica space, for Hopper
// (sm_90a): the block-momentum global step and the elastic pull-back of a
// list of replicas toward its result, in one pass.
//
// bmuf_rows_f32 replaces the TPU kernels bmuf_update and bmuf_update_rows of
// src/repro/kernels/bmuf_update/bmuf_update.py. Per element:
//   vel' = bm vel + (eta scale) (mean - wg)
//   wg'  = wg + vel'
//   look = nesterov ? wg' + bm vel' : wg'
//   stack[rows[k]] = (1-alpha) stack[rows[k]] + alpha look,   k = 0..A-1
// stack (R, n, 128), mean, wg, vel (n, 128), all f32; rows (A,) int32. The
// all-replica landing passes rows = 0..R-1. The replica mean itself comes
// from the launch snapshot (ma_update.cu's replica_mean_rows_f32).
// Bound on this card: device-memory bytes, (2A + 5) planes of n*128*4 B:
// each listed row read and written, mean, wg and vel read, wg and vel
// written; 26 MiB at A = 4, n = 4096.
// In place, all three: stack, wg and vel are HogwildSim's own state, and the
// reference donates them (input/output aliasing). Rows not in rows are
// neither read nor written and come back bitwise unchanged; a row id outside
// [0, R) is skipped. The global step has no replica axis, so it runs whatever
// rows holds.
//
// Design: one thread per float4 of the plane. It runs the N-sized global step
// once, in registers (the TPU kernel's step at the first replica grid step,
// kept resident in the revisited output blocks), stores wg' and vel', then
// walks the listed rows with look in registers. The loop over rows is never
// a grid axis; each plane streams through once, coalesced.
#include <cuda_runtime.h>

__device__ __forceinline__ float4 lerp4(float c, float4 a, float alpha, float4 b) {
  return make_float4(c * a.x + alpha * b.x, c * a.y + alpha * b.y, c * a.z + alpha * b.z,
                     c * a.w + alpha * b.w);
}

__device__ __forceinline__ void bmuf_step(float m, float& g, float& v, float& look, float bm,
                                          float eta_scale, int nesterov) {
  v = bm * v + eta_scale * (m - g);
  g = g + v;
  look = nesterov ? g + bm * v : g;
}

__global__ void bmuf_rows_kernel(float4* __restrict__ stack, const float4* __restrict__ mean,
                                 float4* __restrict__ wg, float4* __restrict__ vel,
                                 const int* __restrict__ rows, int n_rows, int n_replicas,
                                 long long nv, float alpha, float one_minus_alpha,
                                 float eta_scale, float bm, int nesterov) {
  long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= nv) return;
  float4 m = __ldg(mean + e), g = wg[e], v = vel[e], look;
  bmuf_step(m.x, g.x, v.x, look.x, bm, eta_scale, nesterov);
  bmuf_step(m.y, g.y, v.y, look.y, bm, eta_scale, nesterov);
  bmuf_step(m.z, g.z, v.z, look.z, bm, eta_scale, nesterov);
  bmuf_step(m.w, g.w, v.w, look.w, bm, eta_scale, nesterov);
  wg[e] = g;
  vel[e] = v;
  for (int k = 0; k < n_rows; ++k) {
    int r = __ldg(rows + k);
    if (r < 0 || r >= n_replicas) continue;
    float4* w = stack + (long long)r * nv + e;
    *w = lerp4(one_minus_alpha, *w, alpha, look);
  }
}

extern "C" int bmuf_rows_f32(void* stack, const void* mean, void* wg, void* vel,
                             const void* rows, int n_rows, int n_replicas, long long n4,
                             float alpha, float one_minus_alpha, float eta_scale,
                             float block_momentum, int nesterov, void* stream) {
  if (n4 > 0) {
    const int block = 256;
    long long grid = (n4 + block - 1) / block;
    bmuf_rows_kernel<<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
        (float4*)stack, (const float4*)mean, (float4*)wg, (float4*)vel, (const int*)rows, n_rows,
        n_replicas, n4, alpha, one_minus_alpha, eta_scale, block_momentum, nesterov);
  }
  return (int)cudaGetLastError();
}
