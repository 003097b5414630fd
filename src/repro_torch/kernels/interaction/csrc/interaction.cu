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
// Design: one block of 128 threads owns a tile of tb samples, tb sized so
// that its 4x4 blocks of pairs (below) about fill the block's threads; the
// blocks are small (33 KB of shared memory at DLRM's shape), so several sit
// on an SM and one's arithmetic overlaps another's loads.
//   1. z's tb*F*d contiguous values go to shared memory as f32 by 16-byte
//      cp.async copies (f32) or 16-byte loads converted in registers (bf16),
//      coalesced, all in flight at once. Rows are d floats apart (padded to
//      a multiple of 4) and samples an odd number of 16-byte units apart, so
//      8 neighbouring samples hit 8 different bank groups.
//   2. The Gram matrix's upper triangle is cut into 4x4 blocks of rows
//      (bi <= bj), listed in a shared-memory table that each block builds
//      once at its start. A thread takes one (block, sample) item:
//      neighbouring threads take neighbouring samples of the same block. It
//      reads its 4 + 4 rows as float4s and keeps 16 sums in registers: each
//      value read from shared memory serves 4 pairs, so shared memory does
//      not set the pace. Sums run over d in order, in f32.
//   3. Its pairs i < j go to an output tile in shared memory at their
//      np.triu_indices position, and the block writes its tb*F(F-1)/2
//      outputs, contiguous in out, with coalesced stores.
// The Gram matrix never exists in device memory (the TPU kernel builds it in
// VMEM and gathers its triangle).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NT = 128;
constexpr int SMEM_DEFAULT = 48 * 1024;
constexpr int SMEM_MAX = 227 * 1024;

// a tile of tb samples in shared memory: z rows dp floats apart, samples sp
// floats apart, then the tb x P output tile, then the table of 4x4 blocks
struct Geometry {
  int F, d, tb, dp, P, nb, nblk, sp;
  __host__ __device__ Geometry(int F_, int d_, int tb_) : F(F_), d(d_), tb(tb_) {
    dp = (d + 3) & ~3;
    P = F * (F - 1) / 2;
    nb = (F + 3) / 4;
    nblk = nb * (nb + 1) / 2;
    const int sp4 = F * dp / 4;
    sp = 4 * (sp4 + (sp4 % 2 == 0));  // an odd number of float4s
  }
  __host__ __device__ size_t smem_bytes() const {
    return sizeof(float) * ((size_t)tb * (sp + P) + nblk);
  }
};

template <typename T>
__global__ void __launch_bounds__(NT) interaction_kernel(const T* __restrict__ z,
                                                         float* __restrict__ out, int B, int F,
                                                         int d, int tb, int vec) {
  extern __shared__ float4 smem4[];
  const Geometry g(F, d, tb);
  float* zs = reinterpret_cast<float*>(smem4);
  float* os = zs + (size_t)tb * g.sp;
  uint32_t* blocks = reinterpret_cast<uint32_t*>(os + (size_t)tb * g.P);
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * tb, ns = min(tb, B - b0);
  const int fd = F * d;
  const T* zb = z + (size_t)b0 * fd;

  // 1. stage z as f32
  if (vec) {  // d % 4 == 0 (so dp == d) and every sample starts 16-byte aligned
    if constexpr (std::is_same<T, float>::value) {
      const int n4 = fd / 4;
      for (int idx = tid; idx < ns * n4; idx += NT) {
        const int s = idx / n4, c = idx - s * n4;
        const uint32_t dst =
            static_cast<uint32_t>(__cvta_generic_to_shared(zs + (size_t)s * g.sp + 4 * c));
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                     "l"(zb + (size_t)s * fd + 4 * c)
                     : "memory");
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    } else {
      const int n8 = fd / 8;
#pragma unroll 4
      for (int idx = tid; idx < ns * n8; idx += NT) {
        const int s = idx / n8, c = idx - s * n8;
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(zb + (size_t)s * fd) + c);
        const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
        const float2 a = __bfloat1622float2(h2[0]), b = __bfloat1622float2(h2[1]);
        const float2 e = __bfloat1622float2(h2[2]), f = __bfloat1622float2(h2[3]);
        float4* dst = reinterpret_cast<float4*>(zs + (size_t)s * g.sp + 8 * c);
        dst[0] = make_float4(a.x, a.y, b.x, b.y);
        dst[1] = make_float4(e.x, e.y, f.x, f.y);
      }
    }
  } else {  // any d: one value at a time, the row padding zeroed
    const int fdp = F * g.dp;
    for (int idx = tid; idx < ns * fdp; idx += NT) {
      const int s = idx / fdp, rem = idx - s * fdp, r = rem / g.dp, c = rem - r * g.dp;
      float x = 0.f;
      if (c < d) {
        if constexpr (std::is_same<T, float>::value) x = __ldg(zb + (size_t)s * fd + r * d + c);
        else x = __bfloat162float(zb[(size_t)s * fd + r * d + c]);
      }
      zs[(size_t)s * g.sp + rem] = x;
    }
  }

  // 2. the 4x4 blocks (bi, bj), bi <= bj, row by row
  for (int t = tid; t < g.nblk; t += NT) {
    int bi = 0, r = t;
    while (r >= g.nb - bi) {
      r -= g.nb - bi;
      ++bi;
    }
    blocks[t] = (uint32_t)bi | ((uint32_t)(bi + r) << 16);
  }
  if constexpr (std::is_same<T, float>::value) {
    if (vec) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
  __syncthreads();

  // 3. one 4x4 block of one sample per item; rows past F read row F-1 and are dropped
  for (int item = tid; item < ns * g.nblk; item += NT) {
    const int blk = item / ns, s = item - blk * ns;
    const int bi = (int)(blocks[blk] & 0xffffu), bj = (int)(blocks[blk] >> 16);
    const float* zsm = zs + (size_t)s * g.sp;
    const float4* ra[4];
    const float4* rb[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      ra[a] = reinterpret_cast<const float4*>(zsm + min(4 * bi + a, F - 1) * g.dp);
      rb[a] = reinterpret_cast<const float4*>(zsm + min(4 * bj + a, F - 1) * g.dp);
    }
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
    const int n4 = g.dp / 4;
#pragma unroll 2
    for (int c = 0; c < n4; ++c) {
      float4 x[4], y[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        x[a] = ra[a][c];
        y[a] = rb[a][c];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          acc[a][b] = fmaf(x[a].x, y[b].x, acc[a][b]);
          acc[a][b] = fmaf(x[a].y, y[b].y, acc[a][b]);
          acc[a][b] = fmaf(x[a].z, y[b].z, acc[a][b]);
          acc[a][b] = fmaf(x[a].w, y[b].w, acc[a][b]);
        }
    }
    float* osm = os + (size_t)s * g.P;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = 4 * bi + a;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = 4 * bj + b;
        if (i < j && j < F) osm[i * (2 * F - i - 1) / 2 + (j - i - 1)] = acc[a][b];
      }
    }
  }
  __syncthreads();

  // 4. the tile's outputs are contiguous in out
  float* ob = out + (size_t)b0 * g.P;
  for (int idx = tid; idx < ns * g.P; idx += NT) ob[idx] = os[idx];
}

template <typename T>
int launch(const void* z, void* out, int B, int F, int d, void* stream) {
  if (F < 2 || d < 1) return (int)cudaErrorInvalidValue;
  int tb = max(1, NT / Geometry(F, d, 1).nblk);
  while (tb > 1 && Geometry(F, d, tb).smem_bytes() > (size_t)SMEM_MAX) --tb;
  const size_t smem = Geometry(F, d, tb).smem_bytes();
  if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (smem > (size_t)SMEM_DEFAULT) {
    cudaError_t err = cudaFuncSetAttribute(interaction_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int vec = reinterpret_cast<uintptr_t>(z) % 16 == 0 && d % 4 == 0 &&
                  (F * d) % (int)(16 / sizeof(T)) == 0;
  if (B > 0) {
    const int grid = (B + tb - 1) / tb;
    interaction_kernel<T><<<grid, NT, smem, (cudaStream_t)stream>>>((const T*)z, (float*)out, B,
                                                                    F, d, tb, vec);
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
