// One decoder layer's decode step as one kernel, for Hopper (sm_90a), in two
// instances of one template:
//
//  - RESIDENT = true replaces the Pallas kernel
//    openviic_tpu/ops/resident_layer_step.py::resident_layer_step (the
//    beam-resident step: caches never reordered, positions resolved through
//    the ancestry table, this step's K/V an extra column, cross K/V at image
//    granularity, output zeroed where the input token is <pad>; it returns
//    this step's K/V rows and leaves the caches alone);
//  - RESIDENT = false replaces the Pallas kernel
//    openviic_tpu/ops/fused_decoder_step.py::fused_layer_step (the
//    non-resident step: no ancestry, cross K/V per row, f32 throughout; it
//    writes row t of the caches in place).
//
// Per row: qkv = x Wqkv + b; self-attention; x1 = LN1(x + (att Wo + bo));
// cross-attention; x2 = LN2(x1 + (att Woc + boc)); x3 = LN3(x2 + FFN(x2)).
// The rounding points are those of each TPU kernel:
//  - resident: every product's operands are rounded to bf16 and accumulate
//    in f32 (the JAX _mm), the q.k element products are rounded to bf16,
//    the softmax weights are rounded to bf16 before PV, this step's v enters
//    PV unrounded, masks are additive -1e30;
//  - fused: f32 activations times the (bf16-valued) weights, accumulated in
//    f32; -1e30 additive masks and a max(sum, 1e-30) softmax guard.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s dense bf16): at the
// flagship step (N = 1600 rows, L = 25, M = 50, D = 512, h = 8, F = 2048,
// bf16) the products are ~11.7 GFLOP, ~12 us on the tensor cores, while the
// bytes are 82 MB of self K/V (at t = L - 1), 7.3 MB of weights, 6.6 MB in
// and out, plus the cross K/V: 33 MB at image granularity (resident), 164 MB
// per row (fused).  Both are bound by bytes: ~38 us (resident) and ~78 us
// (fused).  The fused step's f32 products would take ~175 us at the card's
// 67 TFLOP/s non-tensor f32 rate; they go to the tensor cores instead, with
// the f32 activation split into three bf16 terms (hi + mid + lo holds its 24
// significand bits), each multiplied exactly by the bf16 weight and summed
// in f32: f32-accurate at 3x the bf16 work (~35 GFLOP, ~36 us), still under
// the byte bound.
//
// Design (simple first, fast later): a block owns BM = 16 rows at the full
// model width, so the LayerNorms, the attention and the residuals stay in
// shared memory; only x, the caches, the cross K/V, the weights and the
// outputs touch device memory.  The six products run on the tensor cores
// through WMMA 16x16x16 bf16 fragments, the weights staged through shared
// memory in 32-deep slices (every block streams all weights, mostly from
// L2).  Attention runs one warp per (row, head): d/8 lanes hold one
// position's 8 elements (one 16-byte load), so a warp works 32/(d/8)
// positions at once; ancestry is resolved by indexed loads (the TPU kernel's
// one-hot product existed only because Mosaic has no gather).  Masked
// positions skip their loads: their score is -1e30 exactly, as the additive
// mask gives for any finite score, and rows whose softmax weight is exactly
// 0 add nothing.  wgmma, TMA, weight multicast across a cluster and a
// persistent step kernel are left for later.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math_constants.h>

#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int BM = 16;                    // rows per block
constexpr int WARPS = 16;
constexpr int THREADS = 32 * WARPS;
constexpr int FRAGS = 2;                  // 16x16 output fragments per warp and pass
constexpr int PASS_N = WARPS * FRAGS * 16;  // output columns per pass (512)
constexpr int BK = 32;                    // depth of one staged slice
constexpr int LDA = BK + 8;               // bf16 pitch of the staged A slice
constexpr int LDW = PASS_N + 8;           // bf16 pitch of the staged W slice
constexpr int UNROLL = 2;                 // positions per lane group per round
constexpr float NEG = -1e30f;
constexpr float LN_EPS = 1e-5f;
constexpr int MAX_D = 512;                // one pass covers the model width

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
  float scale;          // d ** -0.5
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void load8(const bf16* p, float (&out)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// C[0:BM, 0:Nout] = A[0:BM, 0:K] @ W (W (K, Nout) bf16 row-major in device
// memory, A and C f32 in shared memory).  A is rounded to SPLIT bf16 terms
// (1: bf16(A), as the JAX _mm; 3: hi + mid + lo, f32-accurate).  C is
// written after the whole depth is consumed, so C may overlap A when Nout
// fits one pass.  Ends with a barrier.
template <int SPLIT>
__device__ void block_gemm(const float* A, int lda, int K, const bf16* __restrict__ W,
                           int Nout, float* C, int ldc, bf16* ast, bf16* wst) {
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
        ast[r * LDA + c] = hi;
        if (SPLIT > 1) {
          const float rem = a - __bfloat162float(hi);
          const bf16 mid = __float2bfloat16_rn(rem);
          ast[BM * LDA + r * LDA + c] = mid;
          if (SPLIT > 2) {
            ast[2 * BM * LDA + r * LDA + c] = __float2bfloat16_rn(rem - __bfloat162float(mid));
          }
        }
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
// memory (zeroed where the input token is <pad> when pad is given).  One
// warp per row; ends with a barrier.
__device__ void layer_norm(float* xs, const float* add, int ldadd, const bf16* __restrict__ bias,
                           const bf16* __restrict__ s, const bf16* __restrict__ b, int D,
                           bf16* y, const uint8_t* pad, int row0, int N) {
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
    const float keep = (y != nullptr && pad != nullptr && n < N) ? 1.f - (float)pad[n] : 1.f;
#pragma unroll
    for (int i = 0; i < MAX_D / 32; ++i) {
      const int c = lane + 32 * i;
      if (c < D) {
        const float o = (v[i] - mean) * inv * __bfloat162float(s[c]) + __bfloat162float(b[c]);
        if (y == nullptr) {
          xs[r * D + c] = o;
        } else if (n < N) {
          y[(size_t)n * D + c] = __float2bfloat16_rn(o * keep);
        }
      }
    }
  }
  __syncthreads();
}

// One warp's attention for row n (block row r), head `head`.  q: the f32
// query of the head in shared memory; knew/vnew: this step's f32 K/V of the
// head (self-attention only); out: where the head's f32 output goes.  The
// d/8 lanes of a group hold one position's 8 elements.
template <bool RESIDENT, bool SELF>
__device__ void attend(const Params& p, int n, int head, const float* q, const float* knew,
                       const float* vnew, float* out, float* sc) {
  const int lane = threadIdx.x & 31;
  const int d = p.D / p.h;
  const int G = d / 8;        // lanes per position (a power of two <= 32)
  const int P = 32 / G;       // positions per round
  const int grp = lane / G;
  const int c = (lane % G) * 8;
  const int S = SELF ? p.L : p.M;
  const int img = n / p.beam;
  const int base = img * p.beam;
  const size_t hoff = (size_t)head * d + c;

  float qv[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) qv[e] = RESIDENT ? round_bf16(q[c + e] * p.scale) : q[c + e];

  // the cache row (position j) this row reads, and whether j is masked
  auto row_of = [&](int j) -> size_t {
    if (SELF) {
      const int src = RESIDENT ? base + (int)p.anc[(size_t)n * p.L + j] : n;
      return (size_t)src * p.L + j;
    }
    return (size_t)(RESIDENT ? img : n) * p.M + j;
  };
  auto dead = [&](int j) -> bool {
    if (SELF) {
      if (RESIDENT) {
        const int src = base + (int)p.anc[(size_t)n * p.L + j];
        return j == p.t || p.smask[(size_t)src * p.L + j] != 0;  // column t is stale
      }
      return p.smask[(size_t)n * p.L + j] != 0;
    }
    return p.cmask[(size_t)(RESIDENT ? img : n) * p.M + j] != 0;
  };
  const bf16* kbase = SELF ? p.k_cache : p.cross_k;
  const bf16* vbase = SELF ? p.v_cache : p.cross_v;

  // resident self-attention: this step's column, from the unrounded qkv
  float s_new = NEG;
  if (RESIDENT && SELF) {
    float part = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) part += round_bf16(round_bf16(knew[c + e]) * qv[e]);
    for (int o = G / 2; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
    s_new = p.is_pad[n] ? part + NEG : part;
  }

  // pass 1: scores
  for (int j0 = 0; j0 < S; j0 += P * UNROLL) {
    float part[UNROLL];
    bool live[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + u * P + grp;
      part[u] = 0.f;
      live[u] = j < S && !dead(j);
      if (live[u]) {
        float kv[8];
        if (!RESIDENT && SELF && j == p.t) {
#pragma unroll
          for (int e = 0; e < 8; ++e) kv[e] = knew[c + e];
        } else {
          load8(kbase + row_of(j) * p.D + hoff, kv);
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) part[u] += RESIDENT ? round_bf16(kv[e] * qv[e]) : kv[e] * qv[e];
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      for (int o = G / 2; o > 0; o >>= 1) part[u] += __shfl_xor_sync(0xffffffffu, part[u], o);
      const int j = j0 + u * P + grp;
      if (j < S && lane % G == 0) sc[j] = live[u] ? (RESIDENT ? part[u] : part[u] * p.scale) : NEG;
    }
  }
  __syncwarp();

  // pass 2: softmax and the weighted sum of V
  float m = RESIDENT ? (SELF ? s_new : NEG) : -CUDART_INF_F;
  for (int j = 0; j < S; ++j) m = fmaxf(m, sc[j]);
  float denom = (RESIDENT && SELF) ? expf(s_new - m) : 0.f;
  for (int j = 0; j < S; ++j) denom += expf(sc[j] - m);
  if (!RESIDENT) denom = fmaxf(denom, 1e-30f);

  float acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    acc[e] = (RESIDENT && SELF && grp == 0) ? round_bf16(expf(s_new - m)) * vnew[c + e] : 0.f;
  }
  for (int j0 = 0; j0 < S; j0 += P * UNROLL) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + u * P + grp;
      if (j < S) {
        const float e_j = expf(sc[j] - m);
        const float w = RESIDENT ? round_bf16(e_j) : e_j / denom;
        if (w != 0.f) {
          float vv[8];
          if (!RESIDENT && SELF && j == p.t) {
#pragma unroll
            for (int e = 0; e < 8; ++e) vv[e] = vnew[c + e];
          } else {
            load8(vbase + row_of(j) * p.D + hoff, vv);
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
    for (int e = 0; e < 8; ++e) out[c + e] = RESIDENT ? acc[e] / denom : acc[e];
  }
  __syncwarp();
}

// Every (row, head) pair of the block, one warp each; rows past N get zeros.
// qcol/kcol/vcol/ocol: column offsets in `big` (pitch WB).  Ends with a
// barrier.
template <bool RESIDENT, bool SELF>
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
    attend<RESIDENT, SELF>(p, n, head, row + qcol + head * d, row + kcol + head * d,
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

template <bool RESIDENT>
__global__ void __launch_bounds__(THREADS) layer_step_kernel(const Params p) {
  constexpr int SPLIT = RESIDENT ? 1 : 3;
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
  block_gemm<SPLIT>(xs, D, D, p.wqkv, 3 * D, big, WB, ast, wst);
  add_bias(big, WB, 3 * D, p.bqkv, false);
  attention_phase<RESIDENT, true>(p, big, WB, 0, D, 2 * D, 3 * D, scratch, row0);
  for (int e = threadIdx.x; e < BM * D; e += THREADS) {
    const int r = e / D, c = e % D;
    const int n = row0 + r;
    if (n >= p.N) continue;
    const size_t at = RESIDENT ? (size_t)n * D + c : ((size_t)n * p.L + p.t) * D + c;
    p.out_k[at] = __float2bfloat16_rn(big[r * WB + D + c]);
    p.out_v[at] = __float2bfloat16_rn(big[r * WB + 2 * D + c]);
  }
  block_gemm<SPLIT>(big + 3 * D, WB, D, p.wo, D, big, WB, ast, wst);
  layer_norm(xs, big, WB, p.bo, p.ln[0], p.ln[1], D, nullptr, nullptr, row0, p.N);

  // cross-attention: q at [0, D), output at [D, 2D)
  block_gemm<SPLIT>(xs, D, D, p.wqc, D, big, WB, ast, wst);
  add_bias(big, WB, D, p.bqc, false);
  attention_phase<RESIDENT, false>(p, big, WB, 0, 0, 0, D, scratch, row0);
  block_gemm<SPLIT>(big + D, WB, D, p.woc, D, big, WB, ast, wst);
  layer_norm(xs, big, WB, p.boc, p.ln[2], p.ln[3], D, nullptr, nullptr, row0, p.N);

  // FFN: hidden at [0, F), then its product back over [0, D)
  block_gemm<SPLIT>(xs, D, D, p.w1, F, big, WB, ast, wst);
  add_bias(big, WB, F, p.b1, true);
  block_gemm<SPLIT>(big, WB, F, p.w2, D, big, WB, ast, wst);
  layer_norm(xs, big, WB, p.b2, p.ln[4], p.ln[5], D, p.y, RESIDENT ? p.is_pad : nullptr,
             row0, p.N);
}

template <bool RESIDENT>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.D, p.F, p.L, p.M);
  cudaError_t err = cudaFuncSetAttribute(layer_step_kernel<RESIDENT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  layer_step_kernel<RESIDENT><<<(p.N + BM - 1) / BM, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs.
long long openviic_layer_step_smem(int D, int F, int L, int M) {
  return (long long)smem_bytes(D, F, L, M);
}

// Launch one layer step on `stream`; returns cudaGetLastError().
// ptrs: x, k_cache, v_cache, cross_k, cross_v, anc, smask, cmask, is_pad,
// wqkv, bqkv, wo, bo, wqc, bqc, woc, boc, w1, b1, w2, b2, ln1s, ln1b, ln2s,
// ln2b, ln3s, ln3b, y, out_k, out_v (30).  dims: N, L, M, D, F, h, beam, t.
// The caller guarantees bf16 contiguous 16-byte aligned tensors, D <= 512,
// D and F multiples of 64, d = D / h with d / 8 a power of two <= 32, and
// (resident) 0 <= ancestry < beam.
int openviic_layer_step(int resident, const void* const* ptrs, const int* dims, float scale,
                        void* stream) {
  Params p;
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
  return resident ? launch<true>(p, st) : launch<false>(p, st);
}

}  // extern "C"
