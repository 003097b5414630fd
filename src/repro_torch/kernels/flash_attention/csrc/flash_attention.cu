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
// a query row does 4*S*D flops (causal: half) against 8*D bytes of q, k, v
// and out, far above the card's ~295 bf16 flops per byte. Only the tensor
// cores come near that bound: 989 TFLOP/s in bf16 through wgmma, and for f32
// 165 TFLOP/s of f32-accurate products in 3xTF32 through mma.sync (the CUDA
// cores give 67).
//
// Two kernels, chosen by dtype:
//
// bf16: flash_attention_wgmma_kernel<D>, warp-specialised, on the tensor
// cores. The numerics follow the TPU kernel at default precision (bf16
// operands into the MXU, f32 accumulation): S = Q K^T accumulates bf16
// products in f32; the online softmax runs in f32 in the log2 domain; P is
// rounded to bf16 for P V, which accumulates in f32; the output is rounded to
// bf16 once. One block of 384 threads owns BQ = 128 query rows of one (b, h):
//   - warpgroup 2 is the producer: it gives up registers (setmaxnreg) and
//     one of its threads issues every TMA load: the Q tile once, then the K
//     and V tiles of BK = 128 keys into a ring of STAGES shared-memory
//     stages, each with a full and an empty mbarrier. One 4-D tensor map per
//     operand over (B, S, heads, D) reads KV head h / n_rep in place (no
//     repeat, no transpose), and TMA fills rows at or beyond S with zeros, so
//     nothing is padded. Tiles are 128B-swizzled boxes of 64 bf16 along D
//     (two at D = 128; 64B-swizzled boxes of 32 at D = 32);
//   - warpgroups 0 and 1 each own 64 query rows. Per key tile: S (64 x 128)
//     by wgmma m64n128k16 with Q and K both from shared memory, K-major; the
//     mask (keys >= S; j <= i on the diagonal tile only) and the online
//     softmax on the accumulator in registers, rows reduced over the four
//     lanes that hold them; P converted in registers to bf16 as wgmma's A
//     operand (the accumulator's layout is the A fragment's) and O += P V by
//     wgmma m64nDk16 with V from shared memory, MN-major (transposed). P
//     never touches shared memory. Lane 0 of each consumer warp then frees
//     the stage;
//   - the epilogue divides by l, rounds to bf16, writes each warpgroup's 64
//     rows into its own (no longer read) part of the Q tile in the swizzled
//     layout, and one TMA store per box writes them out; TMA clips rows >= S.
// Key tiles wholly above the diagonal are never loaded (the TPU kernel's
// pl.when), and the grid runs the heaviest causal query tiles first, for
// every (b, h), so the short tiles fill the tail. For training (D in {64,
// 128}) the same kernel also writes each query row's log2-sum-exp2, and
// three backward kernels take it (section "bf16 backward" below; the TPU
// kernel has no backward: the JAX package trains through plain jnp).
//
// f32: flash_attention_tf32x3_kernel<D>, on the tensor cores in 3xTF32.
// The f32 path runs on the card wherever a model is f32: the mesh program's
// prefill and the reduced families' prefills. Its work is bound by
// operations too (granite-20b's MQA layout, S = 1,024, D = 128: 12.9 GFLOP
// against 51 MB), and the CUDA cores' 67 TFLOP/s of f32 would put its
// bound at 0.19 ms. One TF32 pass (495 TFLOP/s) keeps 11 significant bits
// of each operand, and attention so taken lies ~1e-3 from the f32 result:
// it would not hold the reference's 2e-4. So each operand x is split into
// two TF32 values, hi = x rounded to TF32 and lo = x - hi (exact), and a . b
// is taken as lo_a . hi_b + hi_a . lo_b + hi_a . hi_b, the two small
// products issued first (lo . lo, below 2^-22 of the product, is dropped):
// within a few 1e-6 of f32, at a third of the TF32 rate, 165 TFLOP/s, 2.5x
// the CUDA cores'. The tensor cores truncate what they add, so no sum runs
// long in one accumulator: Q K^T keeps the small products and hi . hi in
// two, and each key tile's P V starts from zero and is added to O in f32.
// One block of 4 warps owns BQ = 64 query rows of one (b, h), 16 a warp;
// cp.async stages its Q tile in shared memory once, and key tiles of BK
// (32 at D = 128, 64 below) two stages deep (the next tile loads while this
// one is used; rows at or beyond S are zero-filled). Each warp keeps its
// (16, D) output accumulator in registers (mma.sync m16n8k8 fragments;
// 0 spills). Per key tile:
//   - S = Q K^T: for each 16 columns of D a thread reads 4 consecutive
//     floats of a q row and of a key row with one 16-byte load each, and the
//     k-steps take D's columns in the order that puts those 4 in its
//     fragment slots of two k-steps (the same sum). Q and K rows are D + 16
//     floats apart, so a quarter warp's reads hit all 32 banks;
//   - the mask (only on a tile that crosses the diagonal or S) and the
//     online softmax in the log2 domain on the accumulator, each row
//     reduced over the four lanes that hold it;
//   - O += P V with P straight from the accumulator: a thread holds keys
//     (2t, 2t + 1) of each 8 where the A fragment wants slots (t, t + 4), so
//     V's B fragment takes its key rows in that order too (key 2t in slot
//     t, 2t + 1 in slot t + 4) and P never touches shared memory. The
//     output columns are taken in an order that lets a thread read 4
//     consecutive floats of a V row at once for four n-tiles (V rows D + 4
//     floats apart: conflict-free) and write 8 consecutive outputs at the
//     end.
// Operands are split in registers as each product uses them (two integer
// and one f32 operation each). Key tiles wholly above the diagonal are
// never loaded, a warp skips a tile wholly above its own rows, and the
// blocks start with every (b, h) of the heaviest causal query tile.
// <cuda.h> for CUtensorMap and its enums only: libcuda's cuTensorMapEncodeTiled
// is fetched at run time through the CUDA runtime, so nothing links libcuda
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// f32: the tensor-core kernel in 3xTF32 (mma.sync)
// ---------------------------------------------------------------------------

namespace tf {

constexpr int BQ = 64;   // query rows a block: 16 a warp
constexpr int NT = 128;  // 4 warps

template <int D>
struct Cfg {
  static constexpr int BK = D == 128 ? 32 : 64;  // keys a tile
  static constexpr int LDQ = D + 16;             // Q and K row pitch in floats
  static constexpr int LDV = D + 4;              // V row pitch in floats
  static constexpr int STAGE = BK * (LDQ + LDV);  // floats of one K, V stage
  static constexpr int SMEM = (BQ * LDQ + 2 * STAGE) * 4;  // Q, then two stages, bytes
};

// 16 bytes from global to shared memory, asynchronously; zeros where
// src_bytes is 0
__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// rows [r0, r0 + ROWS) of a (., D) row-strided source into shared memory
// LD floats apart, asynchronously; rows at or beyond S zero-filled
template <int D, int ROWS, int LD>
__device__ __forceinline__ void load_rows(uint32_t dst, const float* __restrict__ src,
                                          long long stride, int r0, int S) {
  constexpr int CH = D / 4;  // 16-byte chunks a row
#pragma unroll
  for (int it = 0; it < ROWS * CH / NT; ++it) {
    const int idx = threadIdx.x + it * NT, r = idx / CH, c = (idx - r * CH) * 4;
    const bool in = r0 + r < S;
    cp_async16(dst + (r * LD + c) * 4, src + (long long)(in ? r0 + r : 0) * stride + c,
               in ? 16 : 0);
  }
}

// K and V rows [k0, k0 + BK) into one stage, as one group of copies
template <int D>
__device__ __forceinline__ void load_kv(uint32_t sk, const float* __restrict__ kb,
                                        const float* __restrict__ vb, long long stride, int k0,
                                        int S) {
  using C = Cfg<D>;
  load_rows<D, C::BK, C::LDQ>(sk, kb, stride, k0, S);
  load_rows<D, C::BK, C::LDV>(sk + C::BK * C::LDQ * 4, vb, stride, k0, S);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// x = hi + lo: hi is x rounded to TF32 (to nearest, ties away: half a TF32
// ulp added to the bits, the 13 low bits cleared), lo = x - hi (exact),
// handed to the tensor cores as it is: they read a TF32 operand's 19 high
// bits, so lo is taken truncated to TF32. Two integer and one f32 operation
// (cvt.rna.tf32.f32 compiles to five or more, with its checks for inf/NaN).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// D (16 x 8, f32) += A (16 x 8, tf32) . B (8 x 8, tf32)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float at(const float4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

template <int D>
__global__ void __launch_bounds__(NT, 2) flash_attention_tf32x3_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, int H, int n_rep, int S, long long q_sb, long long q_ss,
    long long kv_sb, long long kv_ss, int causal, float scale_log2) {
  using C = Cfg<D>;
  constexpr int BK = C::BK, NJ = BK / 8, NC = D / 16, NV = D / 32;
  extern __shared__ float4 smem4[];
  const float* sm = reinterpret_cast<const float*>(smem4);
  const uint32_t s0 = smem_u32(smem4), s_kv = s0 + BQ * C::LDQ * 4;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // blocks start in the order of their linear index: give it every (b, h)
  // of the heaviest causal query tile first, then of the next
  const long long lin = blockIdx.x + (long long)gridDim.x * blockIdx.y;
  const int rank = (int)(lin / gridDim.y), bh = (int)(lin - (long long)rank * gridDim.y);
  const int q0 = (gridDim.x - 1 - rank) * BQ;
  const int b = bh / H, h = bh - b * H, kvh = h / n_rep;
  const float* kb = k + b * kv_sb + (long long)kvh * D;
  const float* vb = v + b * kv_sb + (long long)kvh * D;
  const int w0 = q0 + warp * 16;       // this warp's first row
  const int i0 = w0 + g, i1 = i0 + 8;  // this thread's rows

  const int kend = causal ? min(S, q0 + BQ) : S;  // keys this block sees
  const int n_kt = (kend + BK - 1) / BK;
  load_rows<D, BQ, C::LDQ>(s0, q + b * q_sb + (long long)h * D, q_ss, q0, S);  // with tile 0
  load_kv<D>(s_kv, kb, vb, kv_ss, 0, S);
  // this thread's q: rows i0, i1, columns 16c + 4t .. + 3
  const float* qs = sm + (warp * 16 + g) * C::LDQ + 4 * t;

  // acc[4 cc + jj]: rows (i0, i1) x columns 32 cc + 8t + jj and + 4
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // l: this thread's columns only

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    if (kt + 1 < n_kt) {
      load_kv<D>(s_kv + ((kt + 1) & 1) * C::STAGE * 4, kb, vb, kv_ss, k0 + BK, S);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();  // this tile's stage (and at first Q) is in place for every warp

    if (!causal || k0 <= w0 + 15) {  // else the tile lies wholly above this warp's rows
      const float* Ks = sm + BQ * C::LDQ + (kt & 1) * C::STAGE;
      const float* Vs = Ks + BK * C::LDQ;

      // 1. s = q k^T: s[j] is rows (i0, i1) x keys k0 + 8j + 2t, + 1. The
      // small products and hi . hi go to two accumulators, added at the end:
      // twice the independent chains, and each sum's truncation in the
      // tensor cores relative to its own size
      float sb[NJ][4], ss[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sb[j][e] = ss[j][e] = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        // k-step 2c + hh: slots (t, t + 4) are columns 16c + 4t + 2hh, + 1
        const float4 qa = *reinterpret_cast<const float4*>(qs + 16 * c);
        const float4 qc = *reinterpret_cast<const float4*>(qs + 8 * C::LDQ + 16 * c);
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          split(at(qa, 2 * hh), ah[hh][0], al[hh][0]);
          split(at(qc, 2 * hh), ah[hh][1], al[hh][1]);
          split(at(qa, 2 * hh + 1), ah[hh][2], al[hh][2]);
          split(at(qc, 2 * hh + 1), ah[hh][3], al[hh][3]);
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float4 kx = *reinterpret_cast<const float4*>(Ks + (8 * j + g) * C::LDQ + 16 * c + 4 * t);
          uint32_t bh[4], bl[4];
          split(kx.x, bh[0], bl[0]);
          split(kx.y, bh[1], bl[1]);
          split(kx.z, bh[2], bl[2]);
          split(kx.w, bh[3], bl[3]);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            mma(ss[j], al[hh], bh[2 * hh], bh[2 * hh + 1]);
            mma(ss[j], ah[hh], bl[2 * hh], bl[2 * hh + 1]);
            mma(sb[j], ah[hh], bh[2 * hh], bh[2 * hh + 1]);
          }
        }
      }

      // 2. mask, online softmax in the log2 domain
      const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > w0);
      float s[NJ][4];
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float a = (sb[j][e] + ss[j][e]) * scale_log2;
          float c2 = (sb[j][2 + e] + ss[j][2 + e]) * scale_log2;
          if (edge) {
            const int key = k0 + 8 * j + 2 * t + e;
            if (key >= S || (causal && key > i0)) a = -INFINITY;
            if (key >= S || (causal && key > i1)) c2 = -INFINITY;
          }
          s[j][e] = a;
          s[j][2 + e] = c2;
          mx0 = fmaxf(mx0, a);
          mx1 = fmaxf(mx1, c2);
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mu0 = mx0 == -INFINITY ? 0.f : mx0;  // a row with nothing seen yet
      const float mu1 = mx1 == -INFINITY ? 0.f : mx1;
      const float corr0 = ex2(m0 - mu0), corr1 = ex2(m1 - mu1);
      m0 = mx0;
      m1 = mx1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[j][e] = ex2(s[j][e] - mu0);
          s[j][2 + e] = ex2(s[j][2 + e] - mu1);
          sum0 += s[j][e];
          sum1 += s[j][2 + e];
        }
      }
      l0 = l0 * corr0 + sum0;
      l1 = l1 * corr1 + sum1;

      // 3. o = o corr + p v: this tile's p v in a fresh accumulator (the
      // tensor cores truncate what they add; a running sum over every key
      // would gather that error), added to o in f32. k-step j is keys
      // k0 + 8j .. + 7, slot t key 2t and slot t + 4 key 2t + 1; n-tile
      // 4cc + jj's column g is output column 32cc + 4g + jj
      float pv[D / 8][4];
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[n][e] = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        uint32_t ph[4], pl[4];
        split(s[j][0], ph[0], pl[0]);
        split(s[j][2], ph[1], pl[1]);
        split(s[j][1], ph[2], pl[2]);
        split(s[j][3], ph[3], pl[3]);
        const float* v0 = Vs + (8 * j + 2 * t) * C::LDV + 4 * g;
#pragma unroll
        for (int cc = 0; cc < NV; ++cc) {
          const float4 va = *reinterpret_cast<const float4*>(v0 + 32 * cc);
          const float4 vc = *reinterpret_cast<const float4*>(v0 + C::LDV + 32 * cc);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            uint32_t bh0, bl0, bh1, bl1;
            split(at(va, jj), bh0, bl0);
            split(at(vc, jj), bh1, bl1);
            mma(pv[4 * cc + jj], pl, bh0, bh1);
            mma(pv[4 * cc + jj], ph, bl0, bl1);
            mma(pv[4 * cc + jj], ph, bh0, bh1);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][0] = fmaf(acc[n][0], corr0, pv[n][0]);
        acc[n][1] = fmaf(acc[n][1], corr0, pv[n][1]);
        acc[n][2] = fmaf(acc[n][2], corr1, pv[n][2]);
        acc[n][3] = fmaf(acc[n][3], corr1, pv[n][3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // out = acc / l, rows < S only: 8 consecutive columns 32cc + 8t .. + 7 a row
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f, inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  float* ob = o + b * q_sb + (long long)h * D + 8 * t;
#pragma unroll
  for (int cc = 0; cc < NV; ++cc) {
    const float(&a0)[4] = acc[4 * cc], (&a1)[4] = acc[4 * cc + 1];
    const float(&a2)[4] = acc[4 * cc + 2], (&a3)[4] = acc[4 * cc + 3];
    if (i0 < S) {
      float* out = ob + (long long)i0 * q_ss + 32 * cc;
      *reinterpret_cast<float4*>(out) = make_float4(a0[0] * inv0, a1[0] * inv0, a2[0] * inv0, a3[0] * inv0);
      *reinterpret_cast<float4*>(out + 4) = make_float4(a0[1] * inv0, a1[1] * inv0, a2[1] * inv0, a3[1] * inv0);
    }
    if (i1 < S) {
      float* out = ob + (long long)i1 * q_ss + 32 * cc;
      *reinterpret_cast<float4*>(out) = make_float4(a0[2] * inv1, a1[2] * inv1, a2[2] * inv1, a3[2] * inv1);
      *reinterpret_cast<float4*>(out + 4) = make_float4(a0[3] * inv1, a1[3] * inv1, a2[3] * inv1, a3[3] * inv1);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Hkv, int S,
           long long q_sb, long long q_ss, long long kv_sb, long long kv_ss, int causal,
           void* stream) {
  auto kern = flash_attention_tf32x3_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<D>::SMEM);
  if (err != cudaSuccess) return (int)err;
  if (B > 0 && S > 0 && H > 0) {
    dim3 grid((S + BQ - 1) / BQ, B * H);
    const float scale_log2 = (1.0f / sqrtf((float)D)) * 1.4426950408889634f;
    kern<<<grid, NT, Cfg<D>::SMEM, (cudaStream_t)stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o, H, H / Hkv, S, q_sb, q_ss,
        kv_sb, kv_ss, causal, scale_log2);
  }
  return (int)cudaGetLastError();
}

}  // namespace tf

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel (wgmma + TMA)
// ---------------------------------------------------------------------------

namespace wg {

constexpr int BQ = 128;         // query rows a block: two consumer warpgroups of 64
constexpr int BK = 128;         // keys a tile
constexpr int NTHREADS = 384;   // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;  // 128*40 + 256*232 <= 65,536

template <int D>
struct Cfg {
  static constexpr int SW = D * 2 >= 128 ? 128 : D * 2;  // swizzle span = bytes of a box row
  static constexpr int BOX = SW / 2;                      // bf16 along D in one box
  static constexpr int NC = D / BOX;                      // boxes along D
  static constexpr int KPB = SW / 32;                     // k16 steps within one box row
  static constexpr int LAYOUT = SW == 128 ? 1 : 2;        // wgmma descriptor: 128B or 64B swizzle
  static constexpr int STAGES = D == 128 ? 2 : 3;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int BARRIERS = 1 + 2 * STAGES;  // q full; full[STAGES]; empty[STAGES]
  // 1024 of slack to align the tiles to the swizzle pattern's 1024-byte repeat
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * BARRIERS;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// returns once the barrier's phase of this parity has completed; a phase
// that never completes (a fault) traps, failing the launch, rather than
// hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == (1u << 26)) __trap();
  }
}

// one box of a 4-D tensor map (coordinates innermost first) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accumulator registers across the asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle mode in bits 62-63
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              int layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)layout << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (64 x 128, f32) (+)= A (64 x 16, bf16, shared, K-major) . B (16 x 128, bf16, shared, K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D (64 x 32, f32) += A (64 x 16, bf16, registers) . B (16 x 32, bf16, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 64, f32) += A (64 x 16, bf16, registers) . B (16 x 64, bf16, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16, bf16, registers) . B (16 x 128, bf16, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (D == 32) wgmma_rs_n32(o, a, b);
  else if constexpr (D == 64) wgmma_rs_n64(o, a, b);
  else wgmma_rs_n128(o, a, b);
}

// a warpgroup's 64 rows of a (64 x D) f32 accumulator in bf16 into rows
// row0 .. row0 + 63 of a swizzled tile of `rows` rows a box (the layout
// the tensor map stores from), then one TMA store per box by thread 0
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2], uint32_t tile, int rows,
                                           int row0, int r0, int cq, int wgi, int tid,
                                           const CUtensorMap* map, int head, int s0, int b) {
  using C = Cfg<D>;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + cq, c = col / C::BOX;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const uint32_t off = c * rows * C::SW + (row0 + r0 + 8 * hh) * C::SW + (col % C::BOX) * 2;
      const uint32_t swz = off ^ (((off >> 7) & (C::SW / 16 - 1)) << 4);
      const uint32_t val = pack_bf16(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(tile + swz), "r"(val) : "memory");
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to the TMA store
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wgi) : "memory");
  if (tid == 0) {
#pragma unroll
    for (int c = 0; c < C::NC; ++c)
      tma_store(map, tile + c * rows * C::SW + row0 * C::SW, c * C::BOX, head, s0, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1) flash_attention_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o, int H,
    int n_rep, int S, int causal, float scale_log2, float* __restrict__ lse, int S_pad) {
  using C = Cfg<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + C::Q_BYTES;
  const uint32_t sV = sK + C::STAGES * C::KV_BYTES;
  const uint32_t bar_q = sV + C::STAGES * C::KV_BYTES;
  const uint32_t bar_full = bar_q + 8, bar_empty = bar_full + 8 * C::STAGES;

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H, kvh = h / n_rep;
  const int qt = gridDim.y - 1 - blockIdx.y, q0 = qt * BQ;  // heaviest causal tiles first
  const int n_all = (S + BK - 1) / BK;
  const int n_kt = causal ? min(n_all, qt + 1) : n_all;  // key tiles this block sees

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int st = 0; st < C::STAGES; ++st) {
      mbar_init(bar_full + 8 * st, 1);      // the producer's arrive + the tile's bytes
      mbar_init(bar_empty + 8 * st, 8);     // lane 0 of each of the 8 consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 2) {
    // ---- producer: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 256) {
      mbar_expect_tx(bar_q, C::Q_BYTES);
#pragma unroll
      for (int c = 0; c < C::NC; ++c)
        tma_load(sQ + c * BQ * C::SW, &tm_q, bar_q, c * C::BOX, h, q0, b);
      int st = 0;
      uint32_t phase = 0;
      for (int t = 0; t < n_kt; ++t) {
        mbar_wait(bar_empty + 8 * st, phase ^ 1);  // the first round passes at once
        const uint32_t full = bar_full + 8 * st;
        mbar_expect_tx(full, 2 * C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < C::NC; ++c) {
          tma_load(sK + st * C::KV_BYTES + c * BK * C::SW, &tm_k, full, c * C::BOX, kvh, t * BK, b);
          tma_load(sV + st * C::KV_BYTES + c * BK * C::SW, &tm_v, full, c * C::BOX, kvh, t * BK, b);
        }
        if (++st == C::STAGES) {
          st = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wgi owns query rows q0 + 64 wgi .. + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int r0 = warp * 16 + (lane >> 2);  // this thread's rows: r0 and r0 + 8
    const int i0 = q0 + wgi * 64 + r0, i1 = i0 + 8;
    const int cq = 2 * (lane & 3);            // its column pair within each 8 columns

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // l: this thread's columns only

    // A (this warpgroup's 64 rows of Q), K-major, 8-row groups 8 * SW apart
    const uint64_t dq = smem_desc(sQ + wgi * 64 * C::SW, 16, 8 * C::SW, C::LAYOUT);
    mbar_wait(bar_q, 0);
    int st = 0;
    uint32_t phase = 0;
    for (int t = 0; t < n_kt; ++t) {
      mbar_wait(bar_full + 8 * st, phase);
      const uint32_t kst = sK + st * C::KV_BYTES, vst = sV + st * C::KV_BYTES;

      // 1. s = q k^T (64 x 128), bf16 products accumulated in f32
      float s[64];
      const uint64_t dk = smem_desc(kst, 16, 8 * C::SW, C::LAYOUT);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        // k16 step kk: box kk / KPB, 32 bytes further along the box row per step
        const uint32_t a_off = (kk / C::KPB) * BQ * C::SW + (kk % C::KPB) * 32;
        const uint32_t b_off = (kk / C::KPB) * BK * C::SW + (kk % C::KPB) * 32;
        wgmma_ss_n128(s, dq + (a_off >> 4), dk + (b_off >> 4), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // 2. mask, online softmax in the log2 domain. s[4j + 2h + e] is row
      // r0 + 8h, key k0 + 8j + cq + e
      const int k0 = t * BK;
      const bool edge = k0 + BK > S || (causal && t == qt);
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float a = s[4 * j + e] * scale_log2, c = s[4 * j + 2 + e] * scale_log2;
          if (edge) {
            const int key = k0 + 8 * j + cq + e;
            if (key >= S || (causal && key > i0)) a = -INFINITY;
            if (key >= S || (causal && key > i1)) c = -INFINITY;
          }
          s[4 * j + e] = a;
          s[4 * j + 2 + e] = c;
          mx0 = fmaxf(mx0, a);
          mx1 = fmaxf(mx1, c);
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mu0 = mx0 == -INFINITY ? 0.f : mx0;  // a row with nothing seen yet
      const float mu1 = mx1 == -INFINITY ? 0.f : mx1;
      const float corr0 = ex2(m0 - mu0), corr1 = ex2(m1 - mu1);
      m0 = mx0;
      m1 = mx1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[4 * j + e] = ex2(s[4 * j + e] - mu0);
          s[4 * j + 2 + e] = ex2(s[4 * j + 2 + e] - mu1);
          sum0 += s[4 * j + e];
          sum1 += s[4 * j + 2 + e];
        }
      }
      l0 = l0 * corr0 + sum0;
      l1 = l1 * corr1 + sum1;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= corr0;
        o[4 * j + 1] *= corr0;
        o[4 * j + 2] *= corr1;
        o[4 * j + 3] *= corr1;
      }

      // 3. o += p v: p in bf16 as the A fragments of the eight k16 steps
      // (the accumulator of keys 16kk..16kk+15 is laid out as A's registers)
      uint32_t pa[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
      // B = V (keys x D), MN-major: 8-key groups 8 * SW apart, boxes along D BK * SW apart
      const uint64_t dv = smem_desc(vst, BK * C::SW, 8 * C::SW, C::LAYOUT);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) wgmma_pv<D>(o, pa[kk], dv + ((kk * 16 * C::SW) >> 4));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      if (lane == 0) mbar_arrive(bar_empty + 8 * st);  // this warp is done with the stage
      if (++st == C::STAGES) {
        st = 0;
        phase ^= 1;
      }
    }

    // epilogue: o / l in bf16 into this warpgroup's rows of the Q tile (its
    // reads of them are complete), then TMA stores
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f, inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
    if (lse != nullptr && cq == 0) {  // the training form: each row's log2-sum-exp2 (m + log2 l)
      float* lb = lse + (long long)bh * S_pad;
      lb[i0] = l0 > 0.f ? m0 + log2f(l0) : INFINITY;  // an empty row's p = 2^(s - inf) = 0
      lb[i1] = l1 > 0.f ? m1 + log2f(l1) : INFINITY;
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= inv0;
      o[4 * j + 1] *= inv0;
      o[4 * j + 2] *= inv1;
      o[4 * j + 3] *= inv1;
    }
    store_rows<D>(o, sQ, BQ, wgi * 64, r0, cq, wgi, tid, &tm_o, h, q0 + wgi * 64, b);
  }
}

// rows of a (B, H, S_pad) log-sum-exp or delta array: S rounded up to whole 128-row tiles
inline int padded(int S) { return (S + BQ - 1) / BQ * BQ; }

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, through the CUDA runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (B, S, heads, D) bf16 array with heads D apart, positions s_stride and
// batches b_stride elements apart; boxes of (box_d, 1, rows, 1), swizzled
bool make_map(CUtensorMap* map, const void* ptr, int D, int heads, int S, int B, long long s_stride,
              long long b_stride, int box_d, int rows, int sw) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)s_stride * 2,
                                 (cuuint64_t)b_stride * 2};
  const cuuint32_t box[4] = {(cuuint32_t)box_d, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            sw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Hkv, int S,
           long long q_sb, long long q_ss, long long kv_sb, long long kv_ss, int causal,
           void* stream, float* lse = nullptr) {
  using C = Cfg<D>;
  auto kern = flash_attention_wgmma_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  if (B > 0 && S > 0 && H > 0) {
    CUtensorMap tq, tk, tv, to;
    if (!make_map(&tq, q, D, H, S, B, q_ss, q_sb, C::BOX, BQ, C::SW) ||
        !make_map(&tk, k, D, Hkv, S, B, kv_ss, kv_sb, C::BOX, BK, C::SW) ||
        !make_map(&tv, v, D, Hkv, S, B, kv_ss, kv_sb, C::BOX, BK, C::SW) ||
        !make_map(&to, o, D, H, S, B, q_ss, q_sb, C::BOX, 64, C::SW))
      return (int)cudaErrorInvalidValue;
    dim3 grid(B * H, (S + BQ - 1) / BQ);  // every (b, h) of one query tile, heaviest tile first
    const float scale_log2 = (1.0f / sqrtf((float)D)) * 1.4426950408889634f;
    kern<<<grid, NTHREADS, C::SMEM, (cudaStream_t)stream>>>(tq, tk, tv, to, H, H / Hkv, S, causal,
                                                            scale_log2, lse, padded(S));
  }
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bf16 backward (the training form): delta, then dK and dV, then dQ
// ---------------------------------------------------------------------------
//
// Given the forward's output o and its rows' log2-sum-exp2 lse (both from
// flash_attention_wgmma_kernel with lse on) and do = dL/do, with
// p = 2^(s * scale_log2 - lse) the forward's probabilities (s = q . k):
//   delta_i = sum_d do_id o_id (f32)
//   ds_ij   = p_ij (do_i . v_j - delta_i) * scale
//   dv_j = sum_i p_ij do_i,  dk_j = sum_i ds_ij q_i,  dq_i = sum_j ds_ij k_j
// Three kernels on one stream, none with an atomic, so every gradient is
// summed in one fixed order and repeats bitwise:
//   - flash_attention_bwd_delta_kernel: delta, D / 8 lanes a row;
//   - flash_attention_bwd_dkdv_kernel<D>: one block a (b, KV head, 128
//     keys), its K and V tiles loaded once; consumer warpgroups 0 and 1 own
//     64 keys each. It walks the query heads of its KV head (GQA: their sums
//     meet in the block's registers, nothing repeated) and, for each, the
//     query tiles of 64 from the diagonal on (causal), which the producer
//     warpgroup brings through a TMA ring: Q and do tiles, and the tile's
//     lse and delta by bulk copy. Per tile: s^T = K Q^T and dp^T = V do^T
//     (wgmma, both operands in shared memory, K-major), then p^T and ds^T on
//     the accumulators in registers, rounded to bf16 as the A operands of
//     dV += p^T do and dK += ds^T Q (wgmma, do and Q MN-major);
//   - flash_attention_bwd_dq_kernel<D>: one block a (b, head, 128 query
//     rows), as the forward: its Q and do tiles once, K and V tiles of 64
//     keys through the ring up to the diagonal; s = Q K^T, dp = do V^T,
//     ds in registers, dQ += ds K.
// p and ds are rounded to bf16 for their products, as the plain path's
// autograd rounds them; s, dp and every sum stay f32. dK, dV and dQ are
// rounded to bf16 once and written by TMA stores (rows at or beyond S
// clipped). Bound on this card, as the forward: operations (five
// products of the forward's size against the forward's two).

constexpr int BW_PRODUCER_REGS = 24, BW_CONSUMER_REGS = 240;  // 128*24 + 256*240 <= 65,536

// D (64 x 64, f32) (+)= A (64 x 16, bf16, shared, K-major) . B (16 x 64, bf16, shared, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from global into
// shared memory, completing on barrier bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float2 lds_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}

// the (64 x 64) accumulator of s (or its transpose) as the bf16 A fragments
// of four k16 steps: keys (or queries) 16kk .. 16kk + 15 of step kk
__device__ __forceinline__ void to_a_frags(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(x[8 * kk], x[8 * kk + 1]);
    a[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// delta[(b * H + h) * S_pad + i] = sum_d do[b, i, h, d] o[b, i, h, d] for
// i < S, 0 for S <= i < S_pad; D / 8 lanes a row, 8 values each
template <int D>
__global__ void __launch_bounds__(256) flash_attention_bwd_delta_kernel(
    const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
    float* __restrict__ delta, int H, int S, int S_pad, long long q_sb, long long q_ss,
    long long n_rows) {
  constexpr int T = D / 8;
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = g / T;
  const int part = (int)(g - row * T);
  float acc = 0.f;
  if (row < n_rows) {
    const long long bh = row / S_pad;
    const int i = (int)(row - bh * S_pad), b = (int)(bh / H), h = (int)(bh - (long long)b * H);
    if (i < S) {
      const long long off = b * q_sb + i * q_ss + (long long)h * D + part * 8;
      const uint4 ov = *reinterpret_cast<const uint4*>(o + off);
      const uint4 dv = *reinterpret_cast<const uint4*>(dout + off);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 a = __bfloat1622float2(o2[e]), c = __bfloat1622float2(d2[e]);
        acc = fmaf(a.x, c.x, acc);
        acc = fmaf(a.y, c.y, acc);
      }
    }
  }
#pragma unroll
  for (int off = T / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < n_rows && part == 0) delta[row] = acc;
}

template <int D>
struct KvCfg {  // flash_attention_bwd_dkdv_kernel
  static constexpr int BK = 128;  // keys a block: 64 a consumer warpgroup
  static constexpr int BQ = 64;   // query rows a step
  static constexpr int STAGES = 3;
  static constexpr int KV_BYTES = BK * D * 2;  // the K tile, and the V tile
  static constexpr int Q_BYTES = BQ * D * 2;   // a stage's Q tile, and its do tile
  static constexpr int BARRIERS = 1 + 2 * STAGES;  // K and V; full[STAGES]; empty[STAGES]
  static constexpr int SMEM =
      1024 + 2 * KV_BYTES + 2 * STAGES * Q_BYTES + 2 * STAGES * BQ * 4 + 8 * BARRIERS;
};

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1) flash_attention_bwd_dkdv_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
    const __grid_constant__ CUtensorMap tm_dk, const __grid_constant__ CUtensorMap tm_dv,
    const float* __restrict__ lse, const float* __restrict__ delta, int H, int Hkv, int S,
    int S_pad, int causal, float scale_log2, float scale) {
  using C = Cfg<D>;
  using K = KvCfg<D>;
  constexpr int BQ = K::BQ;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sK = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sV = sK + K::KV_BYTES;
  const uint32_t sQ = sV + K::KV_BYTES;            // STAGES Q tiles
  const uint32_t sO = sQ + K::STAGES * K::Q_BYTES;  // STAGES do tiles
  const uint32_t sL = sO + K::STAGES * K::Q_BYTES;  // STAGES x BQ lse
  const uint32_t sDl = sL + K::STAGES * BQ * 4;     // STAGES x BQ delta
  const uint32_t bar_kv = sDl + K::STAGES * BQ * 4;
  const uint32_t bar_full = bar_kv + 8, bar_empty = bar_full + 8 * K::STAGES;

  const int n_rep = H / Hkv;
  const int b = blockIdx.x / Hkv, kvh = blockIdx.x - b * Hkv;
  const int k0 = blockIdx.y * K::BK;  // the lowest key tiles (the most query tiles, causal) first
  const int n_qt = (S + BQ - 1) / BQ;
  const int qt0 = causal ? k0 / BQ : 0;  // the first query tile that sees one of these keys
  const int nq = n_qt - qt0, n_it = n_rep * nq;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
#pragma unroll
    for (int st = 0; st < K::STAGES; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 2) {
    // ---- producer: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(BW_PRODUCER_REGS));
    if (threadIdx.x == 256) {
      mbar_expect_tx(bar_kv, 2 * K::KV_BYTES);
#pragma unroll
      for (int c = 0; c < C::NC; ++c) {
        tma_load(sK + c * K::BK * C::SW, &tm_k, bar_kv, c * C::BOX, kvh, k0, b);
        tma_load(sV + c * K::BK * C::SW, &tm_v, bar_kv, c * C::BOX, kvh, k0, b);
      }
      int st = 0;
      uint32_t phase = 0;
      for (int it = 0; it < n_it; ++it) {
        const int r = it / nq, qt = qt0 + (it - r * nq), h = kvh * n_rep + r;
        mbar_wait(bar_empty + 8 * st, phase ^ 1);
        const uint32_t full = bar_full + 8 * st;
        mbar_expect_tx(full, 2 * K::Q_BYTES + 2 * BQ * 4);
#pragma unroll
        for (int c = 0; c < C::NC; ++c) {
          tma_load(sQ + st * K::Q_BYTES + c * BQ * C::SW, &tm_q, full, c * C::BOX, h, qt * BQ, b);
          tma_load(sO + st * K::Q_BYTES + c * BQ * C::SW, &tm_do, full, c * C::BOX, h, qt * BQ, b);
        }
        const long long row = (long long)(b * H + h) * S_pad + qt * BQ;
        bulk_load(sL + st * BQ * 4, lse + row, BQ * 4, full);
        bulk_load(sDl + st * BQ * 4, delta + row, BQ * 4, full);
        if (++st == K::STAGES) {
          st = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wgi owns keys k0 + 64 wgi .. + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(BW_CONSUMER_REGS));
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int r0 = warp * 16 + (lane >> 2);  // this thread's key rows: r0 and r0 + 8
    const int kw0 = k0 + wgi * 64, key0 = kw0 + r0;
    const int cq = 2 * (lane & 3);  // its query column pair within each 8 columns

    float dv[D / 2], dk[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dv[i] = dk[i] = 0.f;
    // A: this warpgroup's 64 rows of K, and of V; K-major
    const uint64_t ak = smem_desc(sK + wgi * 64 * C::SW, 16, 8 * C::SW, C::LAYOUT);
    const uint64_t av = smem_desc(sV + wgi * 64 * C::SW, 16, 8 * C::SW, C::LAYOUT);
    mbar_wait(bar_kv, 0);
    int st = 0;
    uint32_t phase = 0;
    for (int it = 0; it < n_it; ++it) {
      const int q0 = (qt0 + it % nq) * BQ;
      mbar_wait(bar_full + 8 * st, phase);
      if (!(causal && q0 + BQ - 1 < kw0)) {  // else every query of the tile precedes every key
        const uint32_t qst = sQ + st * K::Q_BYTES, ost = sO + st * K::Q_BYTES;
        // 1. s^T = K Q^T and dp^T = V do^T (64 keys x 64 queries), f32
        float s[32], dp[32];
        const uint64_t bq = smem_desc(qst, 16, 8 * C::SW, C::LAYOUT);
        const uint64_t bo = smem_desc(ost, 16, 8 * C::SW, C::LAYOUT);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t a_off = (kk / C::KPB) * K::BK * C::SW + (kk % C::KPB) * 32;
          const uint32_t b_off = (kk / C::KPB) * BQ * C::SW + (kk % C::KPB) * 32;
          wgmma_ss_n64(s, ak + (a_off >> 4), bq + (b_off >> 4), kk > 0);
          wgmma_ss_n64(dp, av + (a_off >> 4), bo + (b_off >> 4), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);
        fence_regs(dp);

        // 2. p^T and ds^T in place. s[4j + 2h + e] is key row r0 + 8h, query
        // q0 + 8j + cq + e; masked: queries or keys at or beyond S, keys after
        // the query (causal)
        const bool edge = q0 + BQ > S || kw0 + 64 > S || (causal && q0 < kw0 + 63);
        const uint32_t lst = sL + st * BQ * 4, dst = sDl + st * BQ * 4;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 lv = lds_f2(lst + (8 * j + cq) * 4), dl = lds_f2(dst + (8 * j + cq) * 4);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int x = 4 * j + 2 * hh + e;
              float p = ex2(fmaf(s[x], scale_log2, -(e ? lv.y : lv.x)));
              if (edge) {
                const int q = q0 + 8 * j + cq + e, key = key0 + 8 * hh;
                if (q >= S || key >= S || (causal && key > q)) p = 0.f;
              }
              s[x] = p;
              dp[x] = p * (dp[x] - (e ? dl.y : dl.x)) * scale;
            }
          }
        }

        // 3. dV += p^T do, dK += ds^T Q: A from registers in bf16, B (do, Q:
        // queries x D) MN-major, 8-query groups 8 * SW apart, boxes BQ * SW
        uint32_t pa[4][4], da[4][4];
        to_a_frags(pa, s);
        to_a_frags(da, dp);
        const uint64_t to = smem_desc(ost, BQ * C::SW, 8 * C::SW, C::LAYOUT);
        const uint64_t tq = smem_desc(qst, BQ * C::SW, 8 * C::SW, C::LAYOUT);
        fence_regs(dv);
        fence_regs(dk);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_pv<D>(dv, pa[kk], to + ((kk * 16 * C::SW) >> 4));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_pv<D>(dk, da[kk], tq + ((kk * 16 * C::SW) >> 4));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(dv);
        fence_regs(dk);
      }
      if (lane == 0) mbar_arrive(bar_empty + 8 * st);  // this warp is done with the stage
      if (++st == K::STAGES) {
        st = 0;
        phase ^= 1;
      }
    }
    // epilogue: dK and dV into this warpgroup's own rows of the K and V
    // tiles (only it read them), then TMA stores
    store_rows<D>(dk, sK, K::BK, wgi * 64, r0, cq, wgi, tid, &tm_dk, kvh, kw0, b);
    store_rows<D>(dv, sV, K::BK, wgi * 64, r0, cq, wgi, tid, &tm_dv, kvh, kw0, b);
  }
}

template <int D>
struct DqCfg {  // flash_attention_bwd_dq_kernel
  static constexpr int BQ = 128;  // query rows a block: 64 a consumer warpgroup
  static constexpr int BK = 64;   // keys a step
  static constexpr int STAGES = 3;
  static constexpr int Q_BYTES = BQ * D * 2;   // the Q tile, and the do tile
  static constexpr int KV_BYTES = BK * D * 2;  // a stage's K tile, and its V tile
  static constexpr int BARRIERS = 1 + 2 * STAGES;
  static constexpr int SMEM = 1024 + 2 * Q_BYTES + 2 * STAGES * KV_BYTES + 8 * BARRIERS;
};

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1) flash_attention_bwd_dq_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
    const __grid_constant__ CUtensorMap tm_dq, const float* __restrict__ lse,
    const float* __restrict__ delta, int H, int n_rep, int S, int S_pad, int causal,
    float scale_log2, float scale) {
  using C = Cfg<D>;
  using Q = DqCfg<D>;
  constexpr int BK = Q::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sO = sQ + Q::Q_BYTES;
  const uint32_t sK = sO + Q::Q_BYTES;                // STAGES K tiles
  const uint32_t sV = sK + Q::STAGES * Q::KV_BYTES;  // STAGES V tiles
  const uint32_t bar_q = sV + Q::STAGES * Q::KV_BYTES;
  const uint32_t bar_full = bar_q + 8, bar_empty = bar_full + 8 * Q::STAGES;

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H, kvh = h / n_rep;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * Q::BQ;  // heaviest causal tiles first
  const int n_all = (S + BK - 1) / BK;
  const int n_kt = causal ? min(n_all, (q0 + Q::BQ) / BK) : n_all;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int st = 0; st < Q::STAGES; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(BW_PRODUCER_REGS));
    if (threadIdx.x == 256) {
      mbar_expect_tx(bar_q, 2 * Q::Q_BYTES);
#pragma unroll
      for (int c = 0; c < C::NC; ++c) {
        tma_load(sQ + c * Q::BQ * C::SW, &tm_q, bar_q, c * C::BOX, h, q0, b);
        tma_load(sO + c * Q::BQ * C::SW, &tm_do, bar_q, c * C::BOX, h, q0, b);
      }
      int st = 0;
      uint32_t phase = 0;
      for (int t = 0; t < n_kt; ++t) {
        mbar_wait(bar_empty + 8 * st, phase ^ 1);
        const uint32_t full = bar_full + 8 * st;
        mbar_expect_tx(full, 2 * Q::KV_BYTES);
#pragma unroll
        for (int c = 0; c < C::NC; ++c) {
          tma_load(sK + st * Q::KV_BYTES + c * BK * C::SW, &tm_k, full, c * C::BOX, kvh, t * BK, b);
          tma_load(sV + st * Q::KV_BYTES + c * BK * C::SW, &tm_v, full, c * C::BOX, kvh, t * BK, b);
        }
        if (++st == Q::STAGES) {
          st = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wgi owns query rows q0 + 64 wgi .. + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(BW_CONSUMER_REGS));
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int r0 = warp * 16 + (lane >> 2);
    const int qw0 = q0 + wgi * 64, i0 = qw0 + r0, i1 = i0 + 8;
    const int cq = 2 * (lane & 3);
    const long long rows = (long long)bh * S_pad;  // i0, i1 < S_pad: rows of whole 128-row tiles
    const float lse0 = lse[rows + i0], lse1 = lse[rows + i1];
    const float dl0 = delta[rows + i0], dl1 = delta[rows + i1];

    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    const uint64_t aq = smem_desc(sQ + wgi * 64 * C::SW, 16, 8 * C::SW, C::LAYOUT);
    const uint64_t ao = smem_desc(sO + wgi * 64 * C::SW, 16, 8 * C::SW, C::LAYOUT);
    mbar_wait(bar_q, 0);
    int st = 0;
    uint32_t phase = 0;
    for (int t = 0; t < n_kt; ++t) {
      const int kb0 = t * BK;
      mbar_wait(bar_full + 8 * st, phase);
      if (!(causal && kb0 > qw0 + 63)) {  // else the tile lies wholly after this warpgroup's rows
        const uint32_t kst = sK + st * Q::KV_BYTES, vst = sV + st * Q::KV_BYTES;
        // 1. s = Q K^T and dp = do V^T (64 rows x 64 keys), f32
        float s[32], dp[32];
        const uint64_t bk = smem_desc(kst, 16, 8 * C::SW, C::LAYOUT);
        const uint64_t bv = smem_desc(vst, 16, 8 * C::SW, C::LAYOUT);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t a_off = (kk / C::KPB) * Q::BQ * C::SW + (kk % C::KPB) * 32;
          const uint32_t b_off = (kk / C::KPB) * BK * C::SW + (kk % C::KPB) * 32;
          wgmma_ss_n64(s, aq + (a_off >> 4), bk + (b_off >> 4), kk > 0);
          wgmma_ss_n64(dp, ao + (a_off >> 4), bv + (b_off >> 4), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);
        fence_regs(dp);

        // 2. ds in place: s[4j + 2h + e] is row r0 + 8h, key kb0 + 8j + cq + e
        const bool edge = kb0 + BK > S || (causal && kb0 + BK - 1 > qw0);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int x = 4 * j + 2 * hh + e;
              float p = ex2(fmaf(s[x], scale_log2, -(hh ? lse1 : lse0)));
              if (edge) {
                const int key = kb0 + 8 * j + cq + e;
                if (key >= S || (causal && key > (hh ? i1 : i0))) p = 0.f;
              }
              dp[x] = p * (dp[x] - (hh ? dl1 : dl0)) * scale;
            }
          }
        }

        // 3. dQ += ds K: ds from registers in bf16, K (keys x D) MN-major
        uint32_t da[4][4];
        to_a_frags(da, dp);
        const uint64_t tk = smem_desc(kst, BK * C::SW, 8 * C::SW, C::LAYOUT);
        fence_regs(dq);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_pv<D>(dq, da[kk], tk + ((kk * 16 * C::SW) >> 4));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(dq);
      }
      if (lane == 0) mbar_arrive(bar_empty + 8 * st);
      if (++st == Q::STAGES) {
        st = 0;
        phase ^= 1;
      }
    }
    // epilogue: dQ into this warpgroup's own rows of the Q tile, then TMA stores
    store_rows<D>(dq, sQ, Q::BQ, wgi * 64, r0, cq, wgi, tid, &tm_dq, h, qw0, b);
  }
}

template <int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int H,
               int Hkv, int S, long long q_sb, long long q_ss, long long kv_sb, long long kv_ss,
               int causal, void* stream) {
  using C = Cfg<D>;
  auto kkv = flash_attention_bwd_dkdv_kernel<D>;
  auto kq = flash_attention_bwd_dq_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize, KvCfg<D>::SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize, DqCfg<D>::SMEM);
  if (err != cudaSuccess) return (int)err;
  if (B > 0 && S > 0 && H > 0) {
    const cudaStream_t st = (cudaStream_t)stream;
    const int S_pad = padded(S);
    const long long n_rows = (long long)B * H * S_pad;
    const long long lanes = n_rows * (D / 8);
    flash_attention_bwd_delta_kernel<D><<<(unsigned)((lanes + 255) / 256), 256, 0, st>>>(
        (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout, delta, H, S, S_pad, q_sb, q_ss,
        n_rows);
    CUtensorMap tq64, tdo64, tk128, tv128, tdk, tdv, tq128, tdo128, tk64, tv64, tdq;
    if (!make_map(&tq64, q, D, H, S, B, q_ss, q_sb, C::BOX, 64, C::SW) ||
        !make_map(&tdo64, dout, D, H, S, B, q_ss, q_sb, C::BOX, 64, C::SW) ||
        !make_map(&tk128, k, D, Hkv, S, B, kv_ss, kv_sb, C::BOX, 128, C::SW) ||
        !make_map(&tv128, v, D, Hkv, S, B, kv_ss, kv_sb, C::BOX, 128, C::SW) ||
        !make_map(&tdk, dk, D, Hkv, S, B, kv_ss, kv_sb, C::BOX, 64, C::SW) ||
        !make_map(&tdv, dv, D, Hkv, S, B, kv_ss, kv_sb, C::BOX, 64, C::SW) ||
        !make_map(&tq128, q, D, H, S, B, q_ss, q_sb, C::BOX, 128, C::SW) ||
        !make_map(&tdo128, dout, D, H, S, B, q_ss, q_sb, C::BOX, 128, C::SW) ||
        !make_map(&tk64, k, D, Hkv, S, B, kv_ss, kv_sb, C::BOX, 64, C::SW) ||
        !make_map(&tv64, v, D, Hkv, S, B, kv_ss, kv_sb, C::BOX, 64, C::SW) ||
        !make_map(&tdq, dq, D, H, S, B, q_ss, q_sb, C::BOX, 64, C::SW))
      return (int)cudaErrorInvalidValue;
    const float scale = 1.0f / sqrtf((float)D), scale_log2 = scale * 1.4426950408889634f;
    const int n_tiles = (S + 127) / 128;
    kkv<<<dim3(B * Hkv, n_tiles), NTHREADS, KvCfg<D>::SMEM, st>>>(
        tq64, tk128, tv128, tdo64, tdk, tdv, lse, delta, H, Hkv, S, S_pad, causal, scale_log2,
        scale);
    kq<<<dim3(B * H, n_tiles), NTHREADS, DqCfg<D>::SMEM, st>>>(
        tq128, tk64, tv64, tdo128, tdq, lse, delta, H, H / Hkv, S, S_pad, causal, scale_log2,
        scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace wg

}  // namespace

// q/o strides (elements) between batches and between sequence positions; a
// head's D values are contiguous and heads are D apart. k and v share theirs.
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* o, int B,
                                   int H, int Hkv, int S, int D, long long q_sb, long long q_ss,
                                   long long kv_sb, long long kv_ss, int causal, void* stream) {
  switch (D) {
    case 32: return tf::launch<32>(q, k, v, o, B, H, Hkv, S, q_sb, q_ss, kv_sb, kv_ss, causal, stream);
    case 64: return tf::launch<64>(q, k, v, o, B, H, Hkv, S, q_sb, q_ss, kv_sb, kv_ss, causal, stream);
    case 128: return tf::launch<128>(q, k, v, o, B, H, Hkv, S, q_sb, q_ss, kv_sb, kv_ss, causal, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the same interface; also needs 16-byte aligned q, k, v, o and strides
// (TMA), and at most 65,535 query tiles of 128
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* o, int B,
                                    int H, int Hkv, int S, int D, long long q_sb, long long q_ss,
                                    long long kv_sb, long long kv_ss, int causal, void* stream) {
  switch (D) {
    case 32: return wg::launch<32>(q, k, v, o, B, H, Hkv, S, q_sb, q_ss, kv_sb, kv_ss, causal, stream);
    case 64: return wg::launch<64>(q, k, v, o, B, H, Hkv, S, q_sb, q_ss, kv_sb, kv_ss, causal, stream);
    case 128: return wg::launch<128>(q, k, v, o, B, H, Hkv, S, q_sb, q_ss, kv_sb, kv_ss, causal, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the bf16 forward of the training form: flash_attention_bf16, and each
// query row's log2-sum-exp2 of its scaled scores into lse (B, H, S_pad) f32,
// S_pad = S rounded up to a multiple of 128 (the rows past S get theirs too).
// D in {64, 128}
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                        float* lse, int B, int H, int Hkv, int S, int D,
                                        long long q_sb, long long q_ss, long long kv_sb,
                                        long long kv_ss, int causal, void* stream) {
  switch (D) {
    case 64: return wg::launch<64>(q, k, v, o, B, H, Hkv, S, q_sb, q_ss, kv_sb, kv_ss, causal, stream, lse);
    case 128: return wg::launch<128>(q, k, v, o, B, H, Hkv, S, q_sb, q_ss, kv_sb, kv_ss, causal, stream, lse);
    default: return (int)cudaErrorInvalidValue;
  }
}

// its backward: dq, dk, dv (shaped and strided as q, k, v) from q, k, v, the
// forward's o and lse, and dout (strided as q); delta (B, H, S_pad) f32 is
// scratch. Three launches on the stream, in order
extern "C" int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                        const void* o, const void* dout, const float* lse,
                                        float* delta, void* dq, void* dk, void* dv, int B, int H,
                                        int Hkv, int S, int D, long long q_sb, long long q_ss,
                                        long long kv_sb, long long kv_ss, int causal,
                                        void* stream) {
  switch (D) {
    case 64:
      return wg::launch_bwd<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, Hkv, S, q_sb,
                                q_ss, kv_sb, kv_ss, causal, stream);
    case 128:
      return wg::launch_bwd<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, Hkv, S, q_sb,
                                 q_ss, kv_sb, kv_ss, causal, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dynamic shared memory of the bf16 (tensor-core) or f32 kernel at head dim D
// (0 for another D)
extern "C" int flash_attention_smem_bytes(int D, int bf16) {
  switch (D) {
    case 32: return bf16 ? wg::Cfg<32>::SMEM : tf::Cfg<32>::SMEM;
    case 64: return bf16 ? wg::Cfg<64>::SMEM : tf::Cfg<64>::SMEM;
    case 128: return bf16 ? wg::Cfg<128>::SMEM : tf::Cfg<128>::SMEM;
    default: return 0;
  }
}
