// One decoder layer's decode step as one kernel, for Hopper (sm_90a), in two
// designs that share their numerics' helpers:
//
//  - resident:: replaces the Pallas kernel
//    openviic_tpu/ops/resident_layer_step.py::resident_layer_step (the
//    beam-resident step: caches never reordered, positions resolved through
//    the ancestry table, this step's K/V an extra column, cross K/V at image
//    granularity, output zeroed where the input token is <pad>; it returns
//    this step's K/V rows and leaves the caches alone);
//  - fused:: replaces the Pallas kernel
//    openviic_tpu/ops/fused_decoder_step.py::fused_layer_step (the
//    non-resident step: no ancestry, cross K/V per row, f32 throughout; it
//    writes row t of the caches in place).
//
// Per row: qkv = x Wqkv + b; self-attention; x1 = LN1(x + (att Wo + bo));
// cross-attention; x2 = LN2(x1 + (att Woc + boc)); x3 = LN3(x2 + FFN(x2)).
// The rounding points are those of each TPU kernel:
//  - resident: every product's operands are rounded to bf16 and accumulate
//    in f32 (the JAX _mm), the q.k element products are rounded to bf16,
//    the softmax weights exp(s - m) are rounded to bf16 before PV with the
//    final max m (so the softmax takes two passes, never an online max),
//    this step's v enters PV unrounded, masks are additive -1e30;
//  - fused: f32 activations times the (bf16-valued) weights, accumulated in
//    f32; -1e30 additive masks and a max(sum, 1e-30) softmax guard.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s dense bf16): at the
// flagship step (N = 1600 rows, L = 25, M = 50, D = 512, h = 8, F = 2048,
// bf16) the products are ~11.7 GFLOP, ~12 us on the tensor cores, while the
// bytes are 82 MB of self K/V (at t = L - 1), 7.3 MB of weights, 6.6 MB in
// and out, plus the cross K/V: 33 MB at image granularity (resident), 164 MB
// per row (fused).  Both are bound by bytes: ~38 us (resident) and ~78 us
// (fused).  The fused step's f32 products go to the tensor cores with the
// f32 activation split into three bf16 terms (hi + mid + lo), each
// multiplied exactly by the bf16 weight and summed in f32.
//
// resident:: design.  A thread-block cluster of two CTAs shares a tile of up
// to 32 rows (two 16-row MMA tiles) and splits the layer between them: CTA
// c owns half of every D-wide product's output columns, half of the heads
// and half of the FFN's hidden columns, so each CTA streams half of the
// 7.3 MB of weights; the FFN's second product splits its depth (each CTA
// its own hidden columns) and the partial sums cross to the CTA that owns
// the columns through distributed shared memory.  The host takes rows per
// tile = ceil(N / tiles that fit at once), so the grid fills the card
// (1600 rows: 64 clusters, tiles of 25 rows).  Each CTA keeps its own
// columns of the residual stream in f32 and the A operand of every product
// (all D columns, bf16-rounded as the JAX _mm rounds it) in shared memory;
// the attention outputs and LayerNorm outputs are written into both CTAs'
// A operands, and the LayerNorm row sums are added across the cluster.  The
// consumers of the two CTAs meet at mbarriers in each other's shared memory
// (two alternating barriers per CTA, arrivals from all 32 consumer warps).
//
// The weights stream through a ring of 3 stages of 32 x 256 bf16 tiles: a
// producer warp per CTA loads each tile with 4 TMA copies (boxes of 32 rows
// x 64 columns, 128-byte swizzle, tensor maps made on the host through
// cuTensorMapEncodeTiled, L2 evict-last), completing on the stage's full
// mbarrier; it runs ahead across the six products and through the attention
// phases.  Few large copies matter: loading a stage with one 1-D bulk copy
// per weight row (32 per stage) was slower, as the copies' count and not
// their bytes set the pace (PERF.md).  16 consumer warps
// run mma.sync m16n8k16 (bf16, f32 sums), each 16 output columns of a
// 256-column pass, reading the swizzled tiles with ldmatrix.trans without
// bank conflicts, and release the stage on its empty mbarrier; the
// epilogues add the bias and write in place what the next phase reads (q *
// scale and k_new rounded to bf16, v_new in f32, the residual sum in f32,
// the FFN hidden layer rounded to bf16).  Attention runs one warp per (row,
// own head): the CTA's ancestry is resolved once into shared memory (the
// source row of every position, its mask folded in), d/8 lanes hold one
// position's 8 elements (one 16-byte load, L2 evict-first), and a warp
// issues the K loads of up to 32 positions before it reduces any score,
// then the V loads of a batch together; bf16 q.k products come from bf16
// multiplies (exact products, so the rounding is the JAX kernel's).
// Masked positions skip their K loads (score -1e30 exactly, as the additive
// mask gives), and V loads of weight 0 are skipped.  Shapes whose heads or
// widths do not split in two run with clusters of one CTA (16-row tiles).
//
// fused:: design (the first port, unchanged): a block owns 16 rows; the
// products run through WMMA 16x16x16 fragments with the weights staged
// through shared memory in synchronous 32-deep slices; its three-term
// split of a 16 x 2048 f32 hidden layer leaves no room for a weight ring.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <mma.h>
#include <math_constants.h>

#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float NEG = -1e30f;
constexpr float LN_EPS = 1e-5f;
constexpr int MAX_D = 512;  // the widest model (the fused step: one pass, a row in registers)

struct Params {
  const bf16* x;        // (N, D)
  const bf16* k_cache;  // (N, L, D)
  const bf16* v_cache;
  const bf16* cross_k;  // resident (IMG, M, D); fused (N, M, D)
  const bf16* cross_v;
  const int64_t* anc;   // resident (N, L): slot within the image
  const uint8_t* smask; // (N, L) 1 = masked (resident: raw per slot)
  const uint8_t* cmask; // resident (IMG, M); fused (N, M)
  const uint8_t* is_pad;  // resident (N,)
  const bf16* wqkv; const bf16* bqkv;  // (D, 3D), (3D,)
  const bf16* wo; const bf16* bo;      // (D, D), (D,)
  const bf16* wqc; const bf16* bqc;
  const bf16* woc; const bf16* boc;
  const bf16* w1; const bf16* b1;      // (D, F), (F,)
  const bf16* w2; const bf16* b2;      // (F, D), (D,)
  const bf16* ln[6];                   // ln1 scale, bias, ln2 ..., ln3 ...
  bf16* y;              // (N, D)
  bf16* out_k;          // resident: k_new (N, D); fused: k_cache, row t written
  bf16* out_v;
  int N, L, M, D, F, h, beam, t;
  int rows;             // resident: rows per cluster tile
  int cluster;          // resident: CTAs per cluster
  float scale;          // d ** -0.5
  CUtensorMap maps[6];  // resident: TMA maps of wqkv, wo, wqc, woc, w1, w2
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void unpack8(const uint4& u, float (&out)[8]) {
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const bf16* p, float (&out)[8]) {
  unpack8(*reinterpret_cast<const uint4*>(p), out);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// =========================================================== fused:: step
namespace fused {

using namespace nvcuda;

constexpr int BM = 16;                    // rows per block
constexpr int WARPS = 16;
constexpr int THREADS = 32 * WARPS;
constexpr int FRAGS = 2;                  // 16x16 output fragments per warp and pass
constexpr int PASS_N = WARPS * FRAGS * 16;  // output columns per pass (512)
constexpr int BK = 32;                    // depth of one staged slice
constexpr int LDA = BK + 8;               // bf16 pitch of the staged A slice
constexpr int LDW = PASS_N + 8;           // bf16 pitch of the staged W slice
constexpr int UNROLL = 2;                 // positions per lane group per round
constexpr int SPLIT = 3;                  // bf16 terms of an f32 A operand

// C[0:BM, 0:Nout] = A[0:BM, 0:K] @ W (W (K, Nout) bf16 row-major in device
// memory, A and C f32 in shared memory), A split into hi + mid + lo bf16
// terms (f32-accurate).  C is written after the whole depth is consumed, so
// C may overlap A when Nout fits one pass.  Ends with a barrier.
__device__ void block_gemm(const float* A, int lda, int K, const bf16* __restrict__ W, int Nout,
                           float* C, int ldc, bf16* ast, bf16* wst) {
  const int warp = threadIdx.x >> 5;
  for (int n0 = 0; n0 < Nout; n0 += PASS_N) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FRAGS];
#pragma unroll
    for (int f = 0; f < FRAGS; ++f) wmma::fill_fragment(acc[f], 0.f);
    for (int k0 = 0; k0 < K; k0 += BK) {
      for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
        const int r = e / BK, c = e % BK;
        const float a = A[r * lda + k0 + c];
        const bf16 hi = __float2bfloat16_rn(a);
        const float rem = a - __bfloat162float(hi);
        const bf16 mid = __float2bfloat16_rn(rem);
        ast[r * LDA + c] = hi;
        ast[BM * LDA + r * LDA + c] = mid;
        ast[2 * BM * LDA + r * LDA + c] = __float2bfloat16_rn(rem - __bfloat162float(mid));
      }
      for (int e = threadIdx.x; e < BK * (PASS_N / 8); e += THREADS) {
        const int r = e / (PASS_N / 8), c = (e % (PASS_N / 8)) * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (n0 + c < Nout) {
          val = *reinterpret_cast<const uint4*>(W + (size_t)(k0 + r) * Nout + n0 + c);
        }
        *reinterpret_cast<uint4*>(wst + r * LDW + c) = val;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[SPLIT];
#pragma unroll
        for (int s = 0; s < SPLIT; ++s) wmma::load_matrix_sync(a[s], ast + s * BM * LDA + kk, LDA);
#pragma unroll
        for (int f = 0; f < FRAGS; ++f) {
          const int col = (warp * FRAGS + f) * 16;
          if (n0 + col < Nout) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
            wmma::load_matrix_sync(b, wst + kk * LDW + col, LDW);
#pragma unroll
            for (int s = 0; s < SPLIT; ++s) wmma::mma_sync(acc[f], a[s], b, acc[f]);
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int f = 0; f < FRAGS; ++f) {
      const int col = n0 + (warp * FRAGS + f) * 16;
      if (col < Nout) wmma::store_matrix_sync(C + col, acc[f], ldc, wmma::mem_row_major);
    }
  }
  __syncthreads();
}

// C[:, 0:n] += bias (then ReLU); ends with a barrier.
__device__ void add_bias(float* C, int ldc, int n, const bf16* __restrict__ bias, bool relu) {
  for (int e = threadIdx.x; e < BM * n; e += THREADS) {
    const int r = e / n, c = e % n;
    float v = C[r * ldc + c] + __bfloat162float(bias[c]);
    C[r * ldc + c] = relu ? fmaxf(v, 0.f) : v;
  }
  __syncthreads();
}

// Row r: v = xs + (add + bias); out = (v - mean) / sqrt(var + eps) * s + b
// (the JAX _ln).  Written to xs, or, for the last LayerNorm, to y in device
// memory.  One warp per row; ends with a barrier.
__device__ void layer_norm(float* xs, const float* add, int ldadd, const bf16* __restrict__ bias,
                           const bf16* __restrict__ s, const bf16* __restrict__ b, int D,
                           bf16* y, int row0, int N) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < BM; r += WARPS) {
    float v[MAX_D / 32];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < MAX_D / 32; ++i) {
      const int c = lane + 32 * i;
      v[i] = 0.f;
      if (c < D) {
        v[i] = xs[r * D + c] + (add[r * ldadd + c] + __bfloat162float(bias[c]));
        sum += v[i];
      }
    }
    const float mean = warp_sum(sum) / D;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < MAX_D / 32; ++i) {
      const int c = lane + 32 * i;
      if (c < D) sq += (v[i] - mean) * (v[i] - mean);
    }
    const float inv = 1.f / sqrtf(warp_sum(sq) / D + LN_EPS);
    const int n = row0 + r;
#pragma unroll
    for (int i = 0; i < MAX_D / 32; ++i) {
      const int c = lane + 32 * i;
      if (c < D) {
        const float o = (v[i] - mean) * inv * __bfloat162float(s[c]) + __bfloat162float(b[c]);
        if (y == nullptr) {
          xs[r * D + c] = o;
        } else if (n < N) {
          y[(size_t)n * D + c] = __float2bfloat16_rn(o);
        }
      }
    }
  }
  __syncthreads();
}

// One warp's attention for row n, head `head`.  q: the f32 query of the
// head in shared memory; knew/vnew: this step's f32 K/V of the head
// (self-attention only); out: where the head's f32 output goes.  The d/8
// lanes of a group hold one position's 8 elements.
template <bool SELF>
__device__ void attend(const Params& p, int n, int head, const float* q, const float* knew,
                       const float* vnew, float* out, float* sc) {
  const int lane = threadIdx.x & 31;
  const int d = p.D / p.h;
  const int G = d / 8;        // lanes per position (a power of two <= 32)
  const int P = 32 / G;       // positions per round
  const int grp = lane / G;
  const int c = (lane % G) * 8;
  const int S = SELF ? p.L : p.M;
  const size_t hoff = (size_t)head * d + c;

  float qv[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) qv[e] = q[c + e];

  const size_t rows = (size_t)n * S;  // this row's cache or cross K/V rows
  const uint8_t* mask = (SELF ? p.smask : p.cmask) + rows;
  const bf16* kbase = SELF ? p.k_cache : p.cross_k;
  const bf16* vbase = SELF ? p.v_cache : p.cross_v;

  // pass 1: scores
  for (int j0 = 0; j0 < S; j0 += P * UNROLL) {
    float part[UNROLL];
    bool live[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + u * P + grp;
      part[u] = 0.f;
      live[u] = j < S && mask[j] == 0;
      if (live[u]) {
        float kv[8];
        if (SELF && j == p.t) {
#pragma unroll
          for (int e = 0; e < 8; ++e) kv[e] = knew[c + e];
        } else {
          load8(kbase + (rows + j) * p.D + hoff, kv);
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) part[u] += kv[e] * qv[e];
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      for (int o = G / 2; o > 0; o >>= 1) part[u] += __shfl_xor_sync(0xffffffffu, part[u], o);
      const int j = j0 + u * P + grp;
      if (j < S && lane % G == 0) sc[j] = live[u] ? part[u] * p.scale : NEG;
    }
  }
  __syncwarp();

  // pass 2: softmax and the weighted sum of V
  float m = -CUDART_INF_F;
  for (int j = 0; j < S; ++j) m = fmaxf(m, sc[j]);
  float denom = 0.f;
  for (int j = 0; j < S; ++j) denom += expf(sc[j] - m);
  denom = fmaxf(denom, 1e-30f);

  float acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;
  for (int j0 = 0; j0 < S; j0 += P * UNROLL) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + u * P + grp;
      if (j < S) {
        const float w = expf(sc[j] - m) / denom;
        if (w != 0.f) {
          float vv[8];
          if (SELF && j == p.t) {
#pragma unroll
            for (int e = 0; e < 8; ++e) vv[e] = vnew[c + e];
          } else {
            load8(vbase + (rows + j) * p.D + hoff, vv);
          }
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[e] += w * vv[e];
        }
      }
    }
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    for (int o = G; o < 32; o <<= 1) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  }
  if (grp == 0) {
#pragma unroll
    for (int e = 0; e < 8; ++e) out[c + e] = acc[e];
  }
  __syncwarp();
}

// Every (row, head) pair of the block, one warp each; rows past N get zeros.
// qcol/kcol/vcol/ocol: column offsets in `big` (pitch WB).  Ends with a
// barrier.
template <bool SELF>
__device__ void attention_phase(const Params& p, float* big, int WB, int qcol, int kcol,
                                int vcol, int ocol, float* scratch, int row0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d = p.D / p.h;
  float* sc = scratch + warp * (p.L > p.M ? p.L : p.M);
  for (int pr = warp; pr < BM * p.h; pr += WARPS) {
    const int r = pr / p.h, head = pr % p.h;
    const int n = row0 + r;
    float* row = big + r * WB;
    if (n >= p.N) {
      for (int c = lane; c < d; c += 32) row[ocol + head * d + c] = 0.f;
      continue;
    }
    attend<SELF>(p, n, head, row + qcol + head * d, row + kcol + head * d,
                 row + vcol + head * d, row + ocol + head * d, sc);
  }
  __syncthreads();
}

// Dynamic shared memory of one block, in bytes.
size_t smem_bytes(int D, int F, int L, int M) {
  const int WB = 4 * D > F ? 4 * D : F;
  return (size_t)BM * D * 4 + (size_t)BM * WB * 4 + (size_t)3 * BM * LDA * 2 +
         (size_t)BK * LDW * 2 + (size_t)WARPS * (L > M ? L : M) * 4;
}

__global__ void __launch_bounds__(THREADS) kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = p.D, F = p.F;
  const int WB = 4 * D > F ? 4 * D : F;
  float* xs = reinterpret_cast<float*>(smem);               // (BM, D) the residual stream
  float* big = xs + BM * D;                                 // (BM, WB) products and attention
  bf16* ast = reinterpret_cast<bf16*>(big + BM * WB);       // (3, BM, LDA)
  bf16* wst = ast + 3 * BM * LDA;                           // (BK, LDW)
  float* scratch = reinterpret_cast<float*>(wst + BK * LDW);  // (WARPS, max(L, M))
  const int row0 = blockIdx.x * BM;

  for (int e = threadIdx.x; e < BM * D; e += THREADS) {
    const int r = e / D, c = e % D;
    xs[e] = row0 + r < p.N ? __bfloat162float(p.x[(size_t)(row0 + r) * D + c]) : 0.f;
  }
  __syncthreads();

  // self-attention: q | k_new | v_new at columns [0, 3D), output at [3D, 4D)
  block_gemm(xs, D, D, p.wqkv, 3 * D, big, WB, ast, wst);
  add_bias(big, WB, 3 * D, p.bqkv, false);
  attention_phase<true>(p, big, WB, 0, D, 2 * D, 3 * D, scratch, row0);
  for (int e = threadIdx.x; e < BM * D; e += THREADS) {
    const int r = e / D, c = e % D;
    const int n = row0 + r;
    if (n >= p.N) continue;
    const size_t at = ((size_t)n * p.L + p.t) * D + c;
    p.out_k[at] = __float2bfloat16_rn(big[r * WB + D + c]);
    p.out_v[at] = __float2bfloat16_rn(big[r * WB + 2 * D + c]);
  }
  block_gemm(big + 3 * D, WB, D, p.wo, D, big, WB, ast, wst);
  layer_norm(xs, big, WB, p.bo, p.ln[0], p.ln[1], D, nullptr, row0, p.N);

  // cross-attention: q at [0, D), output at [D, 2D)
  block_gemm(xs, D, D, p.wqc, D, big, WB, ast, wst);
  add_bias(big, WB, D, p.bqc, false);
  attention_phase<false>(p, big, WB, 0, 0, 0, D, scratch, row0);
  block_gemm(big + D, WB, D, p.woc, D, big, WB, ast, wst);
  layer_norm(xs, big, WB, p.boc, p.ln[2], p.ln[3], D, nullptr, row0, p.N);

  // FFN: hidden at [0, F), then its product back over [0, D)
  block_gemm(xs, D, D, p.w1, F, big, WB, ast, wst);
  add_bias(big, WB, F, p.b1, true);
  block_gemm(big, WB, F, p.w2, D, big, WB, ast, wst);
  layer_norm(xs, big, WB, p.b2, p.ln[4], p.ln[5], D, p.y, row0, p.N);
}

cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.D, p.F, p.L, p.M);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(p.N + BM - 1) / BM, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace fused

// ======================================================== resident:: step
namespace resident {

constexpr int CWARPS = 16;               // consumer warps
constexpr int CTHREADS = 32 * CWARPS;
constexpr int THREADS = CTHREADS + 32;   // and one producer warp
constexpr int PASS_N = 16 * CWARPS;      // output columns per pass, 16 per consumer warp
constexpr int BK = 32;                   // weight rows per ring stage
constexpr int STAGES = 3;
constexpr int R = 8;                     // rounds of positions whose loads issue together
constexpr int BOX = 64;                  // columns per TMA box: one 128-byte swizzled row
constexpr int STAGE_BYTES = BK * PASS_N * 2;  // a stage: PASS_N / BOX boxes of BK x BOX bf16
constexpr int MAX_CLUSTER = 2;
// CTAs per cluster where the shape splits evenly.  The port builds with 2; a
// measurement build may pass -DOPENVIIC_RESIDENT_CLUSTER=1 to time tiles of
// one CTA (scripts/torch_resident_step_phases.py).
#ifdef OPENVIIC_RESIDENT_CLUSTER
constexpr int RESIDENT_CLUSTER = OPENVIIC_RESIDENT_CLUSTER;
#else
constexpr int RESIDENT_CLUSTER = 2;
#endif
static_assert(RESIDENT_CLUSTER == 1 || RESIDENT_CLUSTER == 2, "clusters of 1 or 2 CTAs");

// Phase marks: built with -DOPENVIIC_PHASES, the first consumer thread of
// each CTA reads the global timer at each meeting of the consumers into
// phase_clock (openviic_phase_clock copies it out); otherwise they compile
// to nothing.
constexpr int PHASE_SLOTS = 16, PHASE_CTAS = 1024;
#ifdef OPENVIIC_PHASES
__device__ unsigned long long phase_clock[PHASE_CTAS * PHASE_SLOTS];
__device__ __forceinline__ void phase_mark(int k) {
  if (threadIdx.x == 0 && blockIdx.x < PHASE_CTAS) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    phase_clock[blockIdx.x * PHASE_SLOTS + k] = t;
  }
}
#else
__device__ __forceinline__ void phase_mark(int) {}
#endif
constexpr long long WAIT_LIMIT = 1ll << 35;  // clocks (~17 s): a broken protocol traps, never hangs

// L2 policies: the weights stay (every CTA reads them), the caches stream.
__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(pol));
  return pol;
}

// A 16-byte read of the K/V caches, through L2 with the evict-first policy.
__device__ __forceinline__ uint4 load_stream(const void* p, uint64_t pol) {
  uint4 r;
  asm volatile("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;\n"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w) : "l"(p), "l"(pol));
  return r;
}

// sum over 8 elements of bf16(k * q): the product of two bf16 values is exact
// in f32, so the bf16 multiply rounds exactly as bf16(f32(k) * f32(q)) does
__device__ __forceinline__ float dot8_bf16(const uint4& k, const uint4& q) {
  const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&k);
  const __nv_bfloat162* q2 = reinterpret_cast<const __nv_bfloat162*>(&q);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(__hmul2(k2[i], q2[i]));
    s += f.x;
    s += f.y;
  }
  return s;
}

// How a cluster of C CTAs shares one tile of rows: CTA `rank` owns the
// output columns [rank * Dc, (rank + 1) * Dc) of every D-wide product, the
// heads [rank * hc, ...), the hidden columns [rank * Fc, ...) and, for the
// FFN's second product, its rows [rank * Fc, ...): a split depth whose
// partial sums the cluster adds.
struct Split {
  int C, rank, Dc, hc, Fc;
};

// Byte offsets of the dynamic shared memory of a CTA of BM rows.
struct Layout {
  int ring, xs, xa, work, recv, sc, src, cdead, ln, bars, total;
};

__host__ __device__ inline int align16(int v) { return (v + 15) & ~15; }

__host__ __device__ inline Layout layout(int BM, int C, int D, int F, int L, int M) {
  const int Dc = D / C, Fc = F / C;
  const int qkv = BM * Dc * (2 + 2 + 4), hidden = BM * (Fc + 8) * 2;
  Layout l;
  l.ring = 0;                                            // STAGES stages, 1024-byte aligned
  l.xs = l.ring + STAGES * STAGE_BYTES + 1024;           // BM x Dc f32: own residual columns
  l.xa = l.xs + BM * Dc * 4;                             // BM x (D + 8) bf16: A operand, all columns
  l.work = l.xa + align16(BM * (D + 8) * 2);             // own q, k (bf16), v (f32); or own hidden
  l.recv = l.work + align16(qkv > hidden ? qkv : hidden);  // BM x Dc f32: the peer's partial sums
  l.sc = l.recv + (C > 1 ? BM * Dc * 4 : 0);             // CWARPS x max(L, M) f32
  l.src = l.sc + align16(CWARPS * (L > M ? L : M) * 4);  // BM x L int
  l.cdead = l.src + align16(BM * L * 4);                 // BM x M bytes
  l.ln = l.cdead + align16(BM * M);                      // 2 x C x BM f32: LayerNorm partial sums
  l.bars = l.ln + 2 * C * BM * 4;                        // full, empty (STAGES each), 2 exchange
  l.total = l.bars + (2 * STAGES + 2) * 8;
  return l;
}

// ---- mbarriers, bulk copies and the cluster
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void consumer_sync() {  // the 16 consumer warps only
  asm volatile("bar.sync 1, %0;\n" ::"n"(CTHREADS) : "memory");
}

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Wait until the barrier's phase `parity` has completed.  Cluster scope
// for the exchange barriers, which the other CTA's consumers arrive on.
template <bool CLUSTER>
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    if (CLUSTER) {
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    } else {
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    }
    if (done) return;
    if (clock64() - t0 > WAIT_LIMIT) __trap();
  }
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// One arrival on the barrier at the same offset in CTA `cta` of the cluster.
__device__ __forceinline__ void bar_arrive_remote(uint32_t bar, uint32_t cta) {
  asm volatile(
      "{\n .reg .b32 ra;\n"
      " mapa.shared::cluster.u32 ra, %0, %1;\n"
      " mbarrier.arrive.release.cluster.shared::cluster.b64 _, [ra];\n}\n"
      ::"r"(bar), "r"(cta) : "memory");
}

__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

// One TMA box (BK rows x BOX columns of a weight, from column x, row y)
// into shared memory at `dst`, 128-byte swizzled, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int x, int y,
                                         uint32_t bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1, {%2, %3}], [%4], %5;\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar), "l"(policy)
      : "memory");
}

// The consumers of every CTA of the cluster meet: what each wrote before,
// also into the other CTAs' shared memory, is visible to all after.  Two
// barriers alternate, so an early arrival for the next meeting can never
// count towards this one.
struct Exchange {
  uint32_t bars;  // two mbarriers, C x CWARPS arrivals each
  int count;      // meetings so far
  __device__ void step(const Split& s) {
    if (s.C == 1) {
      consumer_sync();
      return;
    }
    const uint32_t bar = bars + 8 * (count & 1);
    asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
    __syncwarp();
    const int lane = threadIdx.x & 31;
    if (lane < s.C) bar_arrive_remote(bar, lane);
    bar_wait<true>(bar, (count >> 1) & 1);
    ++count;
  }
};

// One pass of a product: `width` (<= PASS_N) output columns from column
// `col` of its weight, over K rows from row k0.  own: where the columns go
// among this CTA's own columns (for the split-depth product, among the
// owner's); owner: the CTA whose columns they are.
struct Pass {
  const bf16* bias;
  int k0, K, col, width, own, owner;
};

// Pass i of product g (0 qkv, 1 wo, 2 wqc, 3 woc, 4 w1, 5 w2) for this CTA;
// false past the last.
__device__ bool pass_of(const Params& p, const Split& s, int g, int i, Pass& ps) {
  const int D = p.D;
  const int per_d = (s.Dc + PASS_N - 1) / PASS_N;  // passes over Dc columns
  int j0;
  switch (g) {
    case 0: {  // the own columns of each of q, k, v
      if (i >= 3 * per_d) return false;
      const int third = i / per_d;
      j0 = (i % per_d) * PASS_N;
      ps = Pass{p.bqkv, 0, D, third * D + s.rank * s.Dc + j0, min(PASS_N, s.Dc - j0),
                third * s.Dc + j0, s.rank};
      return true;
    }
    case 1:
    case 2:
    case 3: {
      if (i >= per_d) return false;
      j0 = i * PASS_N;
      const bf16* b = g == 1 ? p.bo : g == 2 ? p.bqc : p.boc;
      ps = Pass{b, 0, D, s.rank * s.Dc + j0, min(PASS_N, s.Dc - j0), j0, s.rank};
      return true;
    }
    case 4: {
      const int per_f = (s.Fc + PASS_N - 1) / PASS_N;
      if (i >= per_f) return false;
      j0 = i * PASS_N;
      ps = Pass{p.b1, 0, D, s.rank * s.Fc + j0, min(PASS_N, s.Fc - j0), j0, s.rank};
      return true;
    }
    default: {  // own depth, every column: the other CTAs' columns first, this one's last
      if (i >= s.C * per_d) return false;
      const int owner = (s.rank + 1 + i / per_d) % s.C;
      j0 = (i % per_d) * PASS_N;
      ps = Pass{p.b2, s.rank * s.Fc, s.Fc, owner * s.Dc + j0, min(PASS_N, s.Dc - j0), j0,
                owner};
      return true;
    }
  }
}

// The producer warp: every weight tile of the six products, in the order
// the consumers use them, into the ring; lane b loads the tile's box b.
__device__ void produce(const Params& p, const Split& s, uint32_t ring, uint32_t full,
                        uint32_t empty) {
  const int lane = threadIdx.x & 31;
  const uint64_t keep = evict_last_policy();
  int slice = 0;
  Pass ps;
  for (int g = 0; g < 6; ++g) {
    for (int i = 0; pass_of(p, s, g, i, ps); ++i) {
      for (int k = 0; k < ps.K; k += BK, ++slice) {
        const int st = slice % STAGES;
        if (slice >= STAGES) bar_wait<false>(empty + 8 * st, ((slice / STAGES) - 1) & 1);
        if (lane == 0) bar_expect(full + 8 * st, BK * ps.width * 2);
        __syncwarp();
        if (lane < ps.width / BOX) {
          tma_load(ring + st * STAGE_BYTES + lane * BK * BOX * 2, &p.maps[g],
                   ps.col + lane * BOX, ps.k0 + k, full + 8 * st, keep);
        }
      }
    }
  }
}

// acc += A[0:16 MT, 0:K] @ (the K x 16 columns of this warp in the ring's
// tiles), the tiles consumed in order from `slice`.  A bf16 in shared
// memory, pitch lda.
template <int MT>
__device__ __forceinline__ void mma_pass(const bf16* A, int lda, int K, bool on,
                                         const unsigned char* ring,
                                         uint32_t full, uint32_t empty, int& slice,
                                         float (&acc)[MT][2][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mtx = lane >> 3;
  // lane's ldmatrix rows: A rows (mtx & 1) * 8 + lane % 8 at k + (mtx >> 1) * 8;
  // tile row kr = (mtx & 1) * 8 + lane % 8 at column n = 16 * warp + (mtx >> 1) * 8,
  // which the 128-byte swizzle keeps in box n / BOX, row kr, 16-byte chunk
  // ((n % BOX) / 8) ^ (kr % 8): the 8 rows of a matrix hit 8 different banks
  const bf16* arow = A + ((mtx & 1) * 8 + (lane & 7)) * lda + (mtx >> 1) * 8;
  const int kr = (mtx & 1) * 8 + (lane & 7), n = warp * 16 + (mtx >> 1) * 8;
  const int woff = (n / BOX) * BK * BOX * 2 + kr * BOX * 2 + ((((n % BOX) / 8) ^ (kr & 7)) << 4);
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
    }
  }
  for (int k0 = 0; k0 < K; k0 += BK, ++slice) {
    const int st = slice % STAGES;
    bar_wait<false>(full + 8 * st, (slice / STAGES) & 1);
    if (on) {
      const unsigned char* wt = ring + st * STAGE_BYTES + woff;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t b[4];
        hopper::ldmatrix_x4_trans(b, wt + kk * BOX * 2);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          uint32_t a[4];
          hopper::ldmatrix_x4(a, arow + m * 16 * lda + k0 + kk);
          hopper::mma_bf16(acc[m][0], a, b[0], b[1]);
          hopper::mma_bf16(acc[m][1], a, b[2], b[3]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) bar_arrive(empty + 8 * st);  // this warp is done with the stage
  }
}

// Every pass of product g; epi(pass, r, c, v0, v1) receives the pass's
// columns c and c + 1 of row r.
template <int MT, class Epi>
__device__ void gemm(const Params& p, const Split& s, int g, const bf16* A, int lda,
                     const unsigned char* ring, uint32_t full, uint32_t empty, int& slice, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Pass ps;
  for (int i = 0; pass_of(p, s, g, i, ps); ++i) {
    const bool on = warp * 16 < ps.width;
    float acc[MT][2][4];
    mma_pass<MT>(A, lda, ps.K, on, ring, full, empty, slice, acc);
    if (!on) continue;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = 16 * m + (lane >> 2), c = warp * 16 + 8 * j + 2 * (lane & 3);
        epi(ps, r, c, acc[m][j][0], acc[m][j][1]);
        epi(ps, r + 8, c, acc[m][j][2], acc[m][j][3]);
      }
    }
  }
}

__device__ __forceinline__ void store2(bf16* at, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(at) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float bias_at(const Pass& ps, int c) {
  return __bfloat162float(ps.bias[ps.col + c]);
}

// q * scale and k_new rounded to bf16, v_new in f32 (the JAX kernel's uses)
struct QKV {
  bf16 *q, *k;
  float* v;
  int Dc, rows;
  float scale;
  __device__ void operator()(const Pass& ps, int r, int c, float a, float b) const {
    if (r >= rows) return;
    a += bias_at(ps, c);
    b += bias_at(ps, c + 1);
    const int o = ps.own + c, third = o / Dc, j = o - third * Dc;
    if (third == 0) {
      store2(q + r * Dc + j, a * scale, b * scale);
    } else if (third == 1) {
      store2(k + r * Dc + j, a, b);
    } else {
      v[r * Dc + j] = a;
      v[r * Dc + j + 1] = b;
    }
  }
};

// the cross-attention query: (x Wqc + b) * scale rounded to bf16
struct Query {
  bf16* q;
  int Dc, rows;
  float scale;
  __device__ void operator()(const Pass& ps, int r, int c, float a, float b) const {
    if (r >= rows) return;
    store2(q + r * Dc + ps.own + c, (a + bias_at(ps, c)) * scale, (b + bias_at(ps, c + 1)) * scale);
  }
};

// the residual sum in f32: xs + (product + bias), as the JAX kernel adds
struct Residual {
  float* xs;
  int Dc, rows;
  __device__ void operator()(const Pass& ps, int r, int c, float a, float b) const {
    if (r >= rows) return;
    float* at = xs + r * Dc + ps.own + c;
    at[0] = at[0] + (a + bias_at(ps, c));
    at[1] = at[1] + (b + bias_at(ps, c + 1));
  }
};

// the FFN hidden layer relu(x W1 + b1), rounded to bf16 for the next product
struct Hidden {
  bf16* h;
  int ld;
  __device__ void operator()(const Pass& ps, int r, int c, float a, float b) const {
    store2(h + r * ld + ps.own + c, fmaxf(a + bias_at(ps, c), 0.f),
           fmaxf(b + bias_at(ps, c + 1), 0.f));
  }
};

// The FFN's second product over this CTA's share of the depth (the hidden
// columns it owns): the partial sums of the other CTAs' columns go into
// their `recv`; this CTA's own stay in `own` (the last pass).
template <int MT>
__device__ void gemm_split(const Params& p, const Split& s, const bf16* A, int lda,
                           const unsigned char* ring, uint32_t full, uint32_t empty, int& slice,
                           float* const* recv_all, int rows, float (&own)[MT][2][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Pass ps;
  for (int i = 0; pass_of(p, s, 5, i, ps); ++i) {
    const bool on = warp * 16 < ps.width;
    mma_pass<MT>(A, lda, ps.K, on, ring, full, empty, slice, own);
    if (!on || ps.owner == s.rank) continue;
    float* recv = recv_all[ps.owner];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = 16 * m + (lane >> 2), c = ps.own + warp * 16 + 8 * j + 2 * (lane & 3);
        if (r < rows) *reinterpret_cast<float2*>(recv + r * s.Dc + c) =
            make_float2(own[m][j][0], own[m][j][1]);
        if (r + 8 < rows) *reinterpret_cast<float2*>(recv + (r + 8) * s.Dc + c) =
            make_float2(own[m][j][2], own[m][j][3]);
      }
    }
  }
}

// LayerNorm of the cluster's rows (the JAX _ln over all D columns) when
// each CTA holds its own columns of xs: row sums and squared deviations are
// added over the cluster through `ln`.  The result goes back into xs and,
// rounded, into every CTA's xa (own columns); or, for the last one, to y
// in device memory, zeroed where the input token is <pad>.  One warp per row.
__device__ void layer_norm(const Params& p, const Split& s, Exchange& ex, float* xs,
                           bf16* const* xa_all, float* const* ln_all, const bf16* scale,
                           const bf16* shift, bool last, int row0, int rows, int BM) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int D = p.D, Dc = s.Dc;
  float* sums = ln_all[s.rank];  // [2][C][BM]
  for (int r = warp; r < rows; r += CWARPS) {
    float part = 0.f;
    for (int c = lane; c < Dc; c += 32) part += xs[r * Dc + c];
    part = warp_sum(part);
    if (lane < s.C) ln_all[lane][s.rank * BM + r] = part;
  }
  ex.step(s);
  for (int r = warp; r < rows; r += CWARPS) {
    float total = 0.f;
    for (int q = 0; q < s.C; ++q) total += sums[q * BM + r];
    const float mean = total / D;
    float part = 0.f;
    for (int c = lane; c < Dc; c += 32) {
      const float v = xs[r * Dc + c] - mean;
      part += v * v;
    }
    part = warp_sum(part);
    if (lane < s.C) ln_all[lane][(s.C + s.rank) * BM + r] = part;
  }
  ex.step(s);
  for (int r = warp; r < rows; r += CWARPS) {
    float total = 0.f, sq = 0.f;
    for (int q = 0; q < s.C; ++q) {
      total += sums[q * BM + r];
      sq += sums[(s.C + q) * BM + r];
    }
    const float mean = total / D;
    const float inv = 1.f / sqrtf(sq / D + LN_EPS);
    const int n = row0 + r;
    const float keep = last ? 1.f - (float)p.is_pad[n] : 1.f;
    for (int c = lane; c < Dc; c += 32) {
      const int col = s.rank * Dc + c;
      const float o = (xs[r * Dc + c] - mean) * inv * __bfloat162float(scale[col]) +
                      __bfloat162float(shift[col]);
      if (last) {
        p.y[(size_t)n * D + col] = __float2bfloat16_rn(o * keep);
      } else {
        xs[r * Dc + c] = o;
        const bf16 ob = __float2bfloat16_rn(o);
        for (int q = 0; q < s.C; ++q) xa_all[q][r * (D + 8) + col] = ob;
      }
    }
  }
}

// Attention of this CTA's heads for every row of the cluster's tile, one
// warp per (row, head), into every CTA's xa (the next product's A operand,
// rounded to bf16 as the JAX _mm rounds it).  q (BM, Dc) bf16: q * scale,
// rounded, own heads.  Self-attention: kn (BM, Dc) bf16 and vn (BM, Dc) f32
// are this step's K/V, own heads; src (BM, L) the cache row of each
// position, ~row where the position is masked.  Cross-attention: cdead
// (BM, M) 1 where the region is masked.  d/8 lanes hold one position's 8
// elements (one 16-byte load); a warp issues the K loads of up to 8 rounds
// of positions before it reduces a score, then the V loads of a batch.
template <bool SELF>
__device__ void attention(const Params& p, const Split& s, const bf16* q, const bf16* kn,
                          const float* vn, const int* src, const uint8_t* cdead, float* scratch,
                          bf16* const* xa_all, int row0, int rows) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int D = p.D, d = D / p.h, Dc = s.Dc;
  const int G = d / 8;   // lanes per position (a power of two <= 32)
  const int P = 32 / G;  // positions per round
  const int grp = lane / G;
  const int c = (lane % G) * 8;
  const int S = SELF ? p.L : p.M;
  float* sc = scratch + warp * (p.L > p.M ? p.L : p.M);
  const bf16* kbase = SELF ? p.k_cache : p.cross_k;
  const bf16* vbase = SELF ? p.v_cache : p.cross_v;
  uint64_t stream;  // the caches pass through L2 once: evict them first
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(stream));

  for (int pr = warp; pr < rows * s.hc; pr += CWARPS) {
    const int r = pr / s.hc, lh = pr - r * s.hc;
    const int head = s.rank * s.hc + lh;
    const int n = row0 + r;
    const int img = n / p.beam;
    const int hoff = head * d + c;  // in the caches and in xa
    const int loff = r * Dc + lh * d + c;  // in this CTA's own q, k, v
    const uint4 qv = *reinterpret_cast<const uint4*>(q + loff);
    // the cache (or cross) row of position j, and whether j is masked
    auto where = [&](int j, bool& dead) -> int {
      if (SELF) {
        const int code = src[r * p.L + j];
        dead = code < 0;
        return dead ? ~code : code;
      }
      dead = cdead[r * p.M + j] != 0;
      return img;
    };

    // this step's column (self-attention), from the unrounded qkv
    float s_new = NEG;
    if (SELF) {
      float part = dot8_bf16(*reinterpret_cast<const uint4*>(kn + loff), qv);
      for (int o = G / 2; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
      s_new = p.is_pad[n] ? part + NEG : part;
    }

    // scores: a batch's K loads are all issued before the first reduction
    for (int j0 = 0; j0 < S; j0 += P * R) {
      uint4 raw[R];
      bool live[R];
#pragma unroll
      for (int u = 0; u < R; ++u) {
        const int j = j0 + u * P + grp;
        bool dead = true;
        const int row = j < S ? where(j, dead) : 0;
        live[u] = j < S && !dead;
        raw[u] = live[u] ? load_stream(kbase + ((size_t)row * S + j) * D + hoff, stream)
                         : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < R; ++u) {
        float part = dot8_bf16(raw[u], qv);
        for (int o = G / 2; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
        const int j = j0 + u * P + grp;
        if (j < S && lane % G == 0) sc[j] = live[u] ? part : NEG;
      }
    }
    __syncwarp();

    // the final max, then exp(s - m) with it (two passes, as the JAX kernel)
    float m = s_new;
    for (int j = lane; j < S; j += 32) m = fmaxf(m, sc[j]);
    m = warp_max(m);
    float part = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float e = expf(sc[j] - m);
      sc[j] = e;
      part += e;
    }
    const float e_new = SELF ? expf(s_new - m) : 0.f;
    const float denom = e_new + warp_sum(part);
    __syncwarp();

    float acc[8];
    float vv[8];
    if (SELF && grp == 0) {
      const float w = round_bf16(e_new);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = w * vn[loff + e];
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = 0.f;
    }
    for (int j0 = 0; j0 < S; j0 += P * R) {
      uint4 raw[R];
      float w[R];
#pragma unroll
      for (int u = 0; u < R; ++u) {
        const int j = j0 + u * P + grp;
        bool dead;
        const int row = j < S ? where(j, dead) : 0;
        w[u] = j < S ? round_bf16(sc[j]) : 0.f;
        raw[u] = w[u] != 0.f ? load_stream(vbase + ((size_t)row * S + j) * D + hoff, stream)
                             : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < R; ++u) {
        unpack8(raw[u], vv);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] += w[u] * vv[e];
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      for (int o = G; o < 32; o <<= 1) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
    }
    if (grp == 0) {
      alignas(16) bf16 out[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) out[e] = __float2bfloat16_rn(acc[e] / denom);
      for (int t = 0; t < s.C; ++t) {
        *reinterpret_cast<uint4*>(xa_all[t] + r * (D + 8) + hoff) =
            *reinterpret_cast<const uint4*>(out);
      }
    }
    __syncwarp();  // the next pair overwrites the scores
  }
}

// Bytes from the start of shared memory to the ring's 1024-byte aligned
// start (the 128-byte swizzle repeats every 1024 bytes).
__device__ __forceinline__ int ring_align(const unsigned char* smem) {
  return (int)((1024u - (hopper::smem_addr(smem) & 1023u)) & 1023u);
}

template <int MT>
__device__ void consume(const Params& p, const Split& s, unsigned char* smem, const Layout& lay,
                        uint32_t full, uint32_t empty, uint32_t xbars, int row0, int rows) {
  constexpr int BM = 16 * MT;
  const int D = p.D, L = p.L, M = p.M, Dc = s.Dc, Fc = s.Fc;
  const int tid = threadIdx.x;
  namespace cg = cooperative_groups;
  const cg::cluster_group cluster = cg::this_cluster();
  const unsigned char* ring = smem + lay.ring + ring_align(smem);
  float* xs = reinterpret_cast<float*>(smem + lay.xs);
  bf16* xa = reinterpret_cast<bf16*>(smem + lay.xa);
  bf16* hid = reinterpret_cast<bf16*>(smem + lay.work);  // (BM, Fc + 8), or:
  bf16* qo = hid;                                        // (BM, Dc) own q
  bf16* ko = qo + BM * Dc;                               // (BM, Dc) own k_new
  float* vo = reinterpret_cast<float*>(ko + BM * Dc);    // (BM, Dc) own v_new
  float* scratch = reinterpret_cast<float*>(smem + lay.sc);
  int* src = reinterpret_cast<int*>(smem + lay.src);
  uint8_t* cdead = smem + lay.cdead;
  bf16* xa_all[MAX_CLUSTER];
  float* recv_all[MAX_CLUSTER];
  float* ln_all[MAX_CLUSTER];
  for (int t = 0; t < s.C; ++t) {
    xa_all[t] = s.C > 1 ? cluster.map_shared_rank(xa, t) : xa;
    recv_all[t] = s.C > 1 ? cluster.map_shared_rank(reinterpret_cast<float*>(smem + lay.recv), t)
                          : nullptr;
    ln_all[t] = s.C > 1 ? cluster.map_shared_rank(reinterpret_cast<float*>(smem + lay.ln), t)
                        : reinterpret_cast<float*>(smem + lay.ln);
  }
  Exchange ex{xbars, 0};
  phase_mark(0);

  // x: all columns rounded (the A operand), own columns in f32 (the
  // residual), zero past the tile's rows; the source row of every self
  // position with its mask folded in; the cross masks
  for (int e = tid; e < BM * D; e += CTHREADS) {
    const int r = e / D, c = e - (e / D) * D;
    const float v = r < rows ? __bfloat162float(p.x[(size_t)(row0 + r) * D + c]) : 0.f;
    xa[r * (D + 8) + c] = __float2bfloat16_rn(v);
    const int j = c - s.rank * Dc;
    if (j >= 0 && j < Dc) xs[r * Dc + j] = v;
  }
  for (int e = tid; e < rows * L; e += CTHREADS) {
    const int r = e / L, j = e - (e / L) * L;
    const int n = row0 + r;
    const int from = (n / p.beam) * p.beam + (int)p.anc[(size_t)n * L + j];
    const bool dead = j == p.t || p.smask[(size_t)from * L + j] != 0;  // column t is stale
    src[e] = dead ? ~from : from;
  }
  for (int e = tid; e < rows * M; e += CTHREADS) {
    const int r = e / M, j = e - (e / M) * M;
    cdead[e] = p.cmask[(size_t)((row0 + r) / p.beam) * M + j];
  }
  consumer_sync();
  phase_mark(1);  // inputs staged

  int slice = 0;
  gemm<MT>(p, s, 0, xa, D + 8, ring, full, empty, slice, QKV{qo, ko, vo, Dc, rows, p.scale});
  ex.step(s);  // every CTA is done with x as an operand before attention overwrites xa
  phase_mark(2);  // qkv product
  for (int e = tid; e < rows * (Dc / 8); e += CTHREADS) {  // this step's K/V rows out
    const int r = e / (Dc / 8), c = (e - r * (Dc / 8)) * 8;
    const size_t at = (size_t)(row0 + r) * D + s.rank * Dc + c;
    *reinterpret_cast<uint4*>(p.out_k + at) = *reinterpret_cast<const uint4*>(ko + r * Dc + c);
    alignas(16) bf16 v8[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v8[i] = __float2bfloat16_rn(vo[r * Dc + c + i]);
    *reinterpret_cast<uint4*>(p.out_v + at) = *reinterpret_cast<const uint4*>(v8);
  }
  attention<true>(p, s, qo, ko, vo, src, cdead, scratch, xa_all, row0, rows);
  ex.step(s);
  phase_mark(3);  // self-attention
  gemm<MT>(p, s, 1, xa, D + 8, ring, full, empty, slice, Residual{xs, Dc, rows});
  layer_norm(p, s, ex, xs, xa_all, ln_all, p.ln[0], p.ln[1], false, row0, rows, BM);
  ex.step(s);
  phase_mark(4);  // wo product + LN1

  gemm<MT>(p, s, 2, xa, D + 8, ring, full, empty, slice, Query{qo, Dc, rows, p.scale});
  ex.step(s);
  phase_mark(5);  // wqc product
  attention<false>(p, s, qo, nullptr, nullptr, src, cdead, scratch, xa_all, row0, rows);
  ex.step(s);
  phase_mark(6);  // cross-attention
  gemm<MT>(p, s, 3, xa, D + 8, ring, full, empty, slice, Residual{xs, Dc, rows});
  layer_norm(p, s, ex, xs, xa_all, ln_all, p.ln[2], p.ln[3], false, row0, rows, BM);
  ex.step(s);
  phase_mark(7);  // woc product + LN2

  gemm<MT>(p, s, 4, xa, D + 8, ring, full, empty, slice, Hidden{hid, Fc + 8});
  consumer_sync();
  phase_mark(8);  // w1 product
  if (s.C == 1) {
    gemm<MT>(p, s, 5, hid, Fc + 8, ring, full, empty, slice, Residual{xs, Dc, rows});
  } else {
    // each CTA sums its share of the depth; Dc <= PASS_N, so its own
    // columns are one pass, the last, whose sums stay in registers
    float own[MT][2][4];
    gemm_split<MT>(p, s, hid, Fc + 8, ring, full, empty, slice, recv_all, rows, own);
    ex.step(s);  // the other CTAs' partial sums of this CTA's columns have arrived
    const int warp = tid >> 5, lane = tid & 31;
    const float* recv = reinterpret_cast<const float*>(smem + lay.recv);
    if (warp * 16 < Dc) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * m + (lane >> 2) + 8 * h;
            const int c = warp * 16 + 8 * j + 2 * (lane & 3);
            if (r >= rows) continue;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float sum = own[m][j][2 * h + e] + recv[r * Dc + c + e];
              xs[r * Dc + c + e] =
                  xs[r * Dc + c + e] + (sum + __bfloat162float(p.b2[s.rank * Dc + c + e]));
            }
          }
        }
      }
    }
  }
  consumer_sync();
  phase_mark(9);  // w2 product and the cluster's sum
  layer_norm(p, s, ex, xs, xa_all, ln_all, p.ln[4], p.ln[5], true, row0, rows, BM);
  phase_mark(10);  // LN3
}

template <int MT>
__global__ void __launch_bounds__(THREADS, 1) kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = p.cluster;
  const Split s{C, C > 1 ? (int)cluster_rank() : 0, p.D / C, p.h / C, p.F / C};
  const Layout lay = layout(16 * MT, C, p.D, p.F, p.L, p.M);
  const uint32_t base = hopper::smem_addr(smem);
  const uint32_t full = base + lay.bars, empty = full + 8 * STAGES, xbars = empty + 8 * STAGES;
  const int row0 = (blockIdx.x / C) * p.rows;  // the cluster's tile of rows
  const int rows = max(0, min(p.rows, p.N - row0));

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      bar_init(full + 8 * i, 1);
      bar_init(empty + 8 * i, CWARPS);
    }
    bar_init(xbars, C * CWARPS);
    bar_init(xbars + 8, C * CWARPS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (C > 1) cluster_sync(); else __syncthreads();  // the peer's barriers exist before use

  if (threadIdx.x >= CTHREADS) {
    produce(p, s, base + lay.ring + ring_align(smem), full, empty);
  } else {
    consume<MT>(p, s, smem, lay, full, empty, xbars, row0, rows);
  }
  // no CTA leaves while its peer may still write into its shared memory
  if (C > 1) cluster_sync();
}

// The cluster size the shape allows: 2 where the heads split evenly and
// half of D and of F are multiples of 64 (the TMA box), else 1.
int cluster_for(const Params& p) {
  const bool even = p.h % 2 == 0 && (p.D / 2) % 64 == 0 && (p.F / 2) % 64 == 0;
  return RESIDENT_CLUSTER == 2 && even ? 2 : 1;
}

// CTAs that are resident at once, cached per cluster size and shared memory.
int resident_ctas(int C, size_t smem) {
  static int cached[MAX_CLUSTER + 1] = {0};
  static size_t cached_smem[MAX_CLUSTER + 1] = {0};
  if (cached[C] > 0 && cached_smem[C] == smem) return cached[C];
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(C * 256);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  const cudaError_t err = C == 2 ? cudaOccupancyMaxActiveClusters(&clusters, kernel<2>, &cfg)
                                 : cudaOccupancyMaxActiveClusters(&clusters, kernel<1>, &cfg);
  if (err != cudaSuccess || clusters < 1) {
    cudaGetLastError();
    clusters = 1;
  }
  cached[C] = clusters * C;
  cached_smem[C] = smem;
  return cached[C];
}

// The launch shape: the cluster size, rows per cluster tile (so that the
// grid fills the CTAs resident at once) and the grid.
cudaError_t prepare(Params& p, int& grid, size_t& smem) {
  p.cluster = cluster_for(p);
  const int C = p.cluster, BM = 16 * C;  // two row tiles of MMA when the cluster splits
  smem = (size_t)layout(BM, C, p.D, p.F, p.L, p.M).total;
  cudaError_t err = C == 2 ? cudaFuncSetAttribute(kernel<2>,
                                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                  (int)smem)
                           : cudaFuncSetAttribute(kernel<1>,
                                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                  (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = resident_ctas(C, smem) / C;
  int rows = (p.N + tiles - 1) / tiles;
  p.rows = rows < 1 ? 1 : (rows > BM ? BM : rows);
  grid = (p.N + p.rows - 1) / p.rows * C;
  return cudaSuccess;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver (the library links the runtime only).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* entry = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &entry, cudaEnableDefault, &status) ==
            cudaSuccess && status == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(entry);
    }
  }
  return fn;
}

// The TMA map of a (K, Nout) row-major bf16 weight: boxes of BK rows x BOX
// columns, 128-byte swizzled.
cudaError_t weight_map(CUtensorMap* map, const bf16* W, int K, int Nout) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)Nout, (cuuint64_t)K};
  const cuuint64_t strides[1] = {(cuuint64_t)Nout * sizeof(bf16)};
  const cuuint32_t box[2] = {BOX, BK};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(W), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

cudaError_t launch(Params p, cudaStream_t stream) {
  int grid;
  size_t smem;
  cudaError_t err = prepare(p, grid, smem);
  if (err != cudaSuccess) return err;
  const bf16* W[6] = {p.wqkv, p.wo, p.wqc, p.woc, p.w1, p.w2};
  const int K[6] = {p.D, p.D, p.D, p.D, p.D, p.F};
  const int Nout[6] = {3 * p.D, p.D, p.D, p.D, p.F, p.D};
  for (int g = 0; g < 6; ++g) {
    err = weight_map(&p.maps[g], W[g], K[g], Nout[g]);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = p.cluster == 2 ? cudaLaunchKernelEx(&cfg, kernel<2>, p)
                       : cudaLaunchKernelEx(&cfg, kernel<1>, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace resident

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs (resident: at the
// cluster size the shape allows with an even number of heads).
long long openviic_layer_step_smem(int resident, int D, int F, int L, int M) {
  if (!resident) return (long long)fused::smem_bytes(D, F, L, M);
  Params p = {};
  p.D = D; p.F = F; p.L = L; p.M = M; p.h = 2;
  const int C = resident::cluster_for(p);
  return (long long)resident::layout(16 * C, C, D, F, L, M).total;
}

// What the resident instance runs with at N rows and h heads: out = {CTAs
// per SM, CTAs resident at once, cluster size, rows per cluster tile, grid,
// registers per thread, local (spill) bytes per thread, shared bytes per
// CTA}.  Returns a CUDA error code.
int openviic_layer_step_occupancy(int N, int D, int F, int L, int M, int h, int* out) {
  Params p = {};
  p.N = N; p.D = D; p.F = F; p.L = L; p.M = M; p.h = h;
  int grid;
  size_t smem;
  cudaError_t err = resident::prepare(p, grid, smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  cudaFuncAttributes attr;
  if (p.cluster == 2) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, resident::kernel<2>,
                                                        resident::THREADS, smem);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, resident::kernel<2>);
  } else {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, resident::kernel<1>,
                                                        resident::THREADS, smem);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, resident::kernel<1>);
  }
  if (err != cudaSuccess) return (int)err;
  out[0] = per_sm;
  out[1] = resident::resident_ctas(p.cluster, smem);
  out[2] = p.cluster;
  out[3] = p.rows;
  out[4] = grid;
  out[5] = attr.numRegs;
  out[6] = (int)attr.localSizeBytes;
  out[7] = (int)smem;
  return 0;
}

#ifdef OPENVIIC_PHASES
// Copy the phase marks of the last launch (PHASE_CTAS x PHASE_SLOTS
// nanosecond reads of %globaltimer) to `host`; returns a CUDA error code.
int openviic_phase_clock(unsigned long long* host) {
  return (int)cudaMemcpyFromSymbol(host, resident::phase_clock,
                                   sizeof(resident::phase_clock));
}
#endif

// Launch one layer step on `stream`; returns cudaGetLastError().
// ptrs: x, k_cache, v_cache, cross_k, cross_v, anc, smask, cmask, is_pad,
// wqkv, bqkv, wo, bo, wqc, bqc, woc, boc, w1, b1, w2, b2, ln1s, ln1b, ln2s,
// ln2b, ln3s, ln3b, y, out_k, out_v (30).  dims: N, L, M, D, F, h, beam,
// t.  The caller guarantees bf16 contiguous 16-byte aligned tensors, D <= 512, D
// and F multiples of 64, d = D / h with d / 8 a power of two <= 32, and
// (resident) 0 <= ancestry < beam.
int openviic_layer_step(int resident, const void* const* ptrs, const int* dims, float scale,
                        void* stream) {
  Params p = {};
  int i = 0;
  p.x = static_cast<const bf16*>(ptrs[i++]);
  p.k_cache = static_cast<const bf16*>(ptrs[i++]);
  p.v_cache = static_cast<const bf16*>(ptrs[i++]);
  p.cross_k = static_cast<const bf16*>(ptrs[i++]);
  p.cross_v = static_cast<const bf16*>(ptrs[i++]);
  p.anc = static_cast<const int64_t*>(ptrs[i++]);
  p.smask = static_cast<const uint8_t*>(ptrs[i++]);
  p.cmask = static_cast<const uint8_t*>(ptrs[i++]);
  p.is_pad = static_cast<const uint8_t*>(ptrs[i++]);
  const bf16** w[] = {&p.wqkv, &p.bqkv, &p.wo, &p.bo, &p.wqc, &p.bqc,
                      &p.woc, &p.boc, &p.w1, &p.b1, &p.w2, &p.b2};
  for (const bf16** slot : w) *slot = static_cast<const bf16*>(ptrs[i++]);
  for (int j = 0; j < 6; ++j) p.ln[j] = static_cast<const bf16*>(ptrs[i++]);
  p.y = static_cast<bf16*>(const_cast<void*>(ptrs[i++]));
  p.out_k = static_cast<bf16*>(const_cast<void*>(ptrs[i++]));
  p.out_v = static_cast<bf16*>(const_cast<void*>(ptrs[i++]));
  p.N = dims[0]; p.L = dims[1]; p.M = dims[2]; p.D = dims[3];
  p.F = dims[4]; p.h = dims[5]; p.beam = dims[6]; p.t = dims[7];
  p.scale = scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return resident ? resident::launch(p, st) : fused::launch(p, st);
}

}  // extern "C"
