// Flash attention (online softmax, causal or full) for Hopper (sm_90a).
//
// Replaces the TPU kernel flash_attention in
// src/repro/kernels/flash_attention/flash_attention.py, and with it the
// head folding of its wrapper gqa_attention_op (ops.py there): q (B, S, H, D),
// k and v (B, S, Hkv, D), f32 or bf16, H a multiple of Hkv, D in {32, 64,
// 128}; out (B, S, H, D) in q's type,
//   out[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h / n_rep] / sqrt(D)) v[b, j, h / n_rep]
// over j < S (and j <= i when causal). A (BH, S, D) array is the case H = 1.
//
// Bound on this card: operations. At the prefill's shape (S = 2048, D = 128)
// a score costs 4*D flops against 2*D*bytes of q, k, v read once per query
// row; the work is 2*S*D per row against 4*D*2 bytes, far above the card's
// ~295 flops per byte. This first kernel computes on the CUDA cores in f32
// (67 TFLOP/s), not on the tensor cores (989 TFLOP/s in bf16): wgmma and TMA
// are later work.
//
// Design. One block of 128 threads owns a tile of BQ = 64 query rows of one
// (b, h) and walks the key tiles of BK = 32 in order, as the TPU grid's kv
// axis does: the K and V tiles are staged in shared memory as f32, the
// running max, denominator and the (64, D) accumulator stay in registers
// (each thread owns 4 rows x D/8 columns of it). The reads of the TPU
// kernel's VMEM scratch become register reads. Per key tile:
//   1. scores: thread (ty, tx) computes rows 4ty..4ty+3 against keys
//      tx + 8n (n < 4), float4 reads of q and k rows along D (k rows are
//      padded by 4 floats so the 8 lanes of a quarter warp hit 8 banks);
//   2. masking and the online softmax in the log2 domain (the scale times
//      log2 e is folded into the scores): keys >= S are masked in the kernel,
//      so no zero padding is needed (the reference pads K/V with zeros and,
//      in its non-causal form, lets the padded keys into the softmax); the
//      row max and sum are reduced over the 8 lanes of a row with shuffles;
//   3. out += p v: p goes through shared memory, each thread updates its
//      4 x D/8 accumulator slice (float4 reads of v, conflict-free).
// Causal key tiles wholly above the diagonal are never visited (the TPU
// kernel's pl.when). Query tiles run heaviest first (the causal tiles near
// the end of the sequence have the most key tiles). GQA reads KV head
// h / n_rep directly: no repeated copy of k and v is made.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace {

constexpr int BQ = 64;
constexpr int BK = 32;
constexpr int NT = 128;  // 16 row groups (ty) x 8 lanes (tx)
constexpr int LDP = BK + 4;

template <int D>
__host__ __device__ constexpr int ld_rows() {
  return D + 4;  // row pitch of the q, k, v tiles in floats (keeps float4 alignment)
}

template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)(BQ + 2 * BK) * ld_rows<D>() + (size_t)BQ * LDP);
}

// rows [r0, r0 + rows) of a (., D) row-strided source into dst[r][0..D) as f32;
// rows at or beyond S are zero (a zero v row times p = 0 adds nothing).
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, long long stride,
                                          int r0, int rows, int S) {
  constexpr int LD = ld_rows<D>();
  if constexpr (std::is_same<T, float>::value) {
    constexpr int CH = D / 4;  // float4 chunks per row
    for (int idx = threadIdx.x; idx < rows * CH; idx += NT) {
      int r = idx / CH, c = (idx - r * CH) * 4;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r0 + r < S) val = __ldg(reinterpret_cast<const float4*>(src + (long long)(r0 + r) * stride + c));
      *reinterpret_cast<float4*>(dst + r * LD + c) = val;
    }
  } else {
    constexpr int CH = D / 8;  // 16-byte chunks of 8 bf16 per row
    for (int idx = threadIdx.x; idx < rows * CH; idx += NT) {
      int r = idx / CH, c = (idx - r * CH) * 8;
      float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
      if (r0 + r < S) {
        uint4 raw = __ldg(reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * stride + c));
        const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
        float2 a = __bfloat1622float2(h2[0]), b = __bfloat1622float2(h2[1]);
        float2 e = __bfloat1622float2(h2[2]), f = __bfloat1622float2(h2[3]);
        lo = make_float4(a.x, a.y, b.x, b.y);
        hi = make_float4(e.x, e.y, f.x, f.y);
      }
      *reinterpret_cast<float4*>(dst + r * LD + c) = lo;
      *reinterpret_cast<float4*>(dst + r * LD + c + 4) = hi;
    }
  }
}

template <typename T>
__device__ __forceinline__ void store4(T* dst, float a, float b, float c, float d) {
  if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
  } else {
    __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
    uint2 raw;
    raw.x = *reinterpret_cast<unsigned*>(&lo);
    raw.y = *reinterpret_cast<unsigned*>(&hi);
    *reinterpret_cast<uint2*>(dst) = raw;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ o,
    int H, int n_rep, int S, long long q_sb, long long q_ss, long long kv_sb, long long kv_ss,
    int causal, float scale_log2) {
  constexpr int LD = ld_rows<D>();
  constexpr int DC = D / 32;  // float4 column groups per thread in the accumulator
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;

  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest causal tiles first
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H, kvh = h / n_rep;
  const T* qb = q + b * q_sb + (long long)h * D;
  const T* kb = k + b * kv_sb + (long long)kvh * D;
  const T* vb = v + b * kv_sb + (long long)kvh * D;

  load_tile<T, D>(Qs, qb, q_ss, q0, BQ, S);

  float acc[4][4 * DC];
  float m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * DC; ++c) acc[r][c] = 0.f;
  }

  const int kend = causal ? min(S, q0 + BQ) : S;  // keys this tile can see
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile's K, V and P are read
    load_tile<T, D>(Ks, kb, kv_ss, k0, BK, S);
    load_tile<T, D>(Vs, vb, kv_ss, k0, BK, S);
    __syncthreads();

    // 1. scores of rows 4ty+r against keys tx+8n
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int n = 0; n < 4; ++n) s[r][n] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      float4 qa[4], ka[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qa[r] = *reinterpret_cast<const float4*>(Qs + (ty * 4 + r) * LD + c);
#pragma unroll
      for (int n = 0; n < 4; ++n) ka[n] = *reinterpret_cast<const float4*>(Ks + (tx + 8 * n) * LD + c);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int n = 0; n < 4; ++n)
          s[r][n] += qa[r].x * ka[n].x + qa[r].y * ka[n].y + qa[r].z * ka[n].z + qa[r].w * ka[n].w;
    }

    // 2. mask, online softmax (log2 domain), p into shared memory
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = q0 + ty * 4 + r;
      float mt = -INFINITY;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int j = k0 + tx + 8 * n;
        const bool ok = j < S && (!causal || j <= i);
        s[r][n] = ok ? s[r][n] * scale_log2 : -INFINITY;
        mt = fmaxf(mt, s[r][n]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[r], mt);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // a row with nothing seen yet
      const float corr = exp2f(m[r] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float p = exp2f(s[r][n] - m_use);
        sum += p;
        Ps[(ty * 4 + r) * LDP + tx + 8 * n] = p;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = l[r] * corr + sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * DC; ++c) acc[r][c] *= corr;
    }
    __syncthreads();

    // 3. acc += p v over this tile's keys
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float4 pa[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[r] = *reinterpret_cast<const float4*>(Ps + (ty * 4 + r) * LDP + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int cc = 0; cc < DC; ++cc) {
          const float4 vv = *reinterpret_cast<const float4*>(Vs + (j + jj) * LD + tx * 4 + 32 * cc);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float p = jj == 0 ? pa[r].x : jj == 1 ? pa[r].y : jj == 2 ? pa[r].z : pa[r].w;
            acc[r][cc * 4 + 0] += p * vv.x;
            acc[r][cc * 4 + 1] += p * vv.y;
            acc[r][cc * 4 + 2] += p * vv.z;
            acc[r][cc * 4 + 3] += p * vv.w;
          }
        }
      }
    }
  }

  // out = acc / l, in q's type, rows < S only
  T* ob = o + b * q_sb + (long long)h * D;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + ty * 4 + r;
    if (i >= S) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc)
      store4<T>(ob + (long long)i * q_ss + tx * 4 + 32 * cc, acc[r][cc * 4] * inv,
                acc[r][cc * 4 + 1] * inv, acc[r][cc * 4 + 2] * inv, acc[r][cc * 4 + 3] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Hkv, int S,
           long long q_sb, long long q_ss, long long kv_sb, long long kv_ss, int causal,
           void* stream) {
  auto kern = flash_attention_kernel<T, D>;
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0 && S > 0 && H > 0) {
    dim3 grid((S + BQ - 1) / BQ, B * H);
    const float scale_log2 = (1.0f / sqrtf((float)D)) * 1.4426950408889634f;
    kern<<<grid, NT, smem, (cudaStream_t)stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)o, H, H / Hkv, S, q_sb, q_ss, kv_sb, kv_ss,
        causal, scale_log2);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B, int H, int Hkv, int S,
             int D, long long q_sb, long long q_ss, long long kv_sb, long long kv_ss, int causal,
             void* stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, B, H, Hkv, S, q_sb, q_ss, kv_sb, kv_ss, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, H, Hkv, S, q_sb, q_ss, kv_sb, kv_ss, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, H, Hkv, S, q_sb, q_ss, kv_sb, kv_ss, causal, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q/o strides (elements) between batches and between sequence positions; a
// head's D values are contiguous and heads are D apart. k and v share theirs.
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* o, int B,
                                   int H, int Hkv, int S, int D, long long q_sb, long long q_ss,
                                   long long kv_sb, long long kv_ss, int causal, void* stream) {
  return dispatch<float>(q, k, v, o, B, H, Hkv, S, D, q_sb, q_ss, kv_sb, kv_ss, causal, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* o, int B,
                                    int H, int Hkv, int S, int D, long long q_sb, long long q_ss,
                                    long long kv_sb, long long kv_ss, int causal, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, B, H, Hkv, S, D, q_sb, q_ss, kv_sb, kv_ss, causal,
                                 stream);
}
