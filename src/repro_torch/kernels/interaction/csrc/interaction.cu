// Fused DLRM pairwise-dot interaction for Hopper (sm_90a).
//
// Replaces the TPU kernel interaction in
// src/repro/kernels/interaction/interaction.py: z (B, F, d), f32 or bf16 ->
// out (B, F(F-1)/2) f32, out[b, p] = z[b, i] . z[b, j] for the p-th pair
// i < j in np.triu_indices order ((0,1), (0,2), ..., (0,F-1), (1,2), ...).
//
// Bound on this card: device-memory bytes. A pair costs 2d flops and the
// sample's F*d inputs are reused by F-1 pairs each, but at DLRM's F = 27,
// d = 64 that is 44,928 flops against 6,912 + 1,404 bytes a sample: about
// 5 flops per byte, far below the card's balance point. The least time is
// one read of z and one write of the triangle.
//
// Design: one block of 256 threads owns a tile of TB samples. It stages
// their z rows in shared memory as f32 (rows padded to d + 1 floats, so the
// lanes reading different rows at the same column hit different banks),
// then each thread takes pairs p = tid, tid + 256, ... of the tile, finds
// (i, j) from p, sums the d products in column order in f32 and writes
// out[b, p]: neighbouring threads write neighbouring pairs. The Gram matrix
// never exists, in shared memory or in device memory (the TPU kernel builds
// it in VMEM and gathers its triangle).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int NT = 256;
constexpr int SMEM_DEFAULT = 48 * 1024;
constexpr int SMEM_MAX = 227 * 1024;

template <typename T>
__global__ void __launch_bounds__(NT) interaction_kernel(const T* __restrict__ z,
                                                         float* __restrict__ out, int B, int F,
                                                         int d, int tb) {
  extern __shared__ float zs[];
  const int ld = d + 1;
  const int n_pairs = F * (F - 1) / 2;
  const int b0 = blockIdx.x * tb;
  const int nb = min(tb, B - b0);
  const long long base = (long long)b0 * F * d;
  for (int idx = threadIdx.x; idx < nb * F * d; idx += NT) {
    int row = idx / d, c = idx - row * d;
    float x;
    if constexpr (std::is_same<T, float>::value) {
      x = __ldg(z + base + idx);
    } else {
      x = __bfloat162float(z[base + idx]);
    }
    zs[row * ld + c] = x;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < nb * n_pairs; t += NT) {
    const int s = t / n_pairs;
    int p = t - s * n_pairs, i = 0;
    while (p >= F - 1 - i) {  // row i holds the F-1-i pairs (i, i+1..F-1)
      p -= F - 1 - i;
      ++i;
    }
    const int j = i + 1 + p;
    const float* zi = zs + (s * F + i) * ld;
    const float* zj = zs + (s * F + j) * ld;
    float acc = 0.f;
    for (int c = 0; c < d; ++c) acc += zi[c] * zj[c];
    out[(long long)(b0 + s) * n_pairs + (t - s * n_pairs)] = acc;
  }
}

template <typename T>
int launch(const void* z, void* out, int B, int F, int d, void* stream) {
  const size_t per_sample = sizeof(float) * (size_t)F * (d + 1);
  if (per_sample > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  // as many samples as fit the default 48 KB (at least one), at most 8
  int tb = (int)(SMEM_DEFAULT / per_sample);
  tb = tb < 1 ? 1 : (tb > 8 ? 8 : tb);
  const size_t smem = per_sample * tb;
  if (smem > (size_t)SMEM_DEFAULT) {
    cudaError_t err = cudaFuncSetAttribute(interaction_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (B > 0 && F > 1) {
    const int grid = (B + tb - 1) / tb;
    interaction_kernel<T><<<grid, NT, smem, (cudaStream_t)stream>>>((const T*)z, (float*)out, B,
                                                                    F, d, tb);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int interaction_f32(const void* z, void* out, int B, int F, int d, void* stream) {
  return launch<float>(z, out, B, F, d, stream);
}

extern "C" int interaction_bf16(const void* z, void* out, int B, int F, int d, void* stream) {
  return launch<__nv_bfloat16>(z, out, B, F, d, stream);
}
