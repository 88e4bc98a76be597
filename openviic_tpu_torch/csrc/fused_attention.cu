// Multi-head attention with an additive f32 bias, for Hopper (sm_90a).
//
// Replaces the Pallas kernel openviic_tpu/ops/pallas_attention.py::
// fused_attention (its pallas_call in _fused_attention_padded).  For
// q (B, nq, h, d), k (B, nk, h, d), v (B, nk, h, dv) in f32 or bf16 (any
// strides over batch, position and head; the last axis contiguous) and an
// optional f32 bias that broadcasts to (B, h, nq, nk) (strides may be 0),
// it computes what the JAX kernel computes in f32:
//   s   = (q . k) * scale + bias
//   out = softmax(s) @ v                     (B, nq, h, dv), f32
// The running max starts at -1e30, as the JAX kernel's does, so a row whose
// every key carries the -1e30 mask bias is uniform over its nk keys, not
// NaN; keys past nk are never loaded.
//
// What bounds it on an H100 SXM: at the flagship encoder shape (B = 320,
// nq = nk = 56, h = 8, d = 64, bf16 in, f32 out) 55 MB of bf16 q/k/v and
// 37 MB of f32 output, ~27 us at 3.35 TB/s, against 1.03 GFLOP for each
// product; at the non-resident decode step (1600 rows, nq = 1, nk = 25 or
// 56) the K/V bytes alone.  Bytes bound both.
//
// The host picks one of three tiles (ops/fused_attention.py::choose_tile):
//
//  - DECODE, for few queries (nq <= the measured crossover): one warp per
//    (batch, query, head), eight warps per block, so a block takes one
//    row's eight heads and reads the row's mask once.  d/8 lanes (rounded
//    up to a power of two) hold one key's 8 elements from one 16-byte load;
//    a warp issues the loads of up to 8 rounds of keys before it reduces any
//    score, keeps the scores of up to 256 keys in shared memory and takes
//    the exact max before any exponent (two passes; beyond 256 keys the
//    chunks combine online), then runs p . v in f32 on the CUDA cores with
//    the V loads of a batch issued together.  Keys past nk are never loaded.
//  - MMA, for bf16 with more queries (the encoder): one block of four warps
//    per (batch, head, 64 queries), so the flagship's 56 padded queries share
//    one staging of K and V.  Q, K and V are staged as bf16 with 16-byte
//    cp.async (a second K/V buffer loads the next 64-key tile while this one
//    is used), S = Q K^T runs on mma.sync m16n8k16 with bf16 operands and f32
//    sums (exact products, as the f32 reference's), and the online softmax
//    stays in the accumulator registers (quad shuffles).  P . V must be
//    f32-accurate (the bar is 2e-5 absolute), so each f32 weight is split
//    into three bf16 terms, hi + mid + lo (24 significand bits), and each
//    term is multiplied exactly by the bf16 V with f32 sums: three products
//    on the tensor cores instead of one on the CUDA cores.  Two terms would
//    leave up to 2^-18 |p| per weight.  Operands that are not 16-byte
//    aligned (base, strides or widths not multiples of 8 elements) are
//    staged by plain loads into the same layout.
//  - SIMT, for f32 q/k/v with more queries, which the bf16 model never
//    passes: the CUDA-core kernel of the first port, one block per (batch,
//    head, 32 queries), every product in f32 from shared memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr float NEG = -1e30f;  // the JAX kernels' additive mask and initial max
enum Tile { SIMT = 0, MMA = 1, DECODE = 2 };

struct Strides {
  long long b, n, h;  // elements between batch entries, positions and heads
};


// =================================================================== SIMT
namespace simt {

constexpr int BQ = 32;        // queries per block
constexpr int BKT = 64;       // keys per tile
constexpr int THREADS = 128;  // 4 threads per query row of the softmax
constexpr int SP = BKT + 1;   // f32 pitch of the score tile

static_assert(THREADS == 4 * BQ, "four softmax threads per query row");
static_assert(BKT == 4 * 16, "each softmax thread folds 16 keys");

// Stage `rows` rows (from position n0) x `cols` columns of one head of a
// (B, n, h, cols) tensor into shared memory as f32 with pitch `pitch`,
// zero-filling rows past `n`.
__device__ __forceinline__ void stage(float* dst, int pitch, const float* src, Strides st,
                                      int b, int head, int n0, int rows, int n, int cols) {
  const float* base = src + b * st.b + head * st.h;
  for (int i = threadIdx.x; i < rows * cols; i += THREADS) {
    const int r = i / cols;
    const int c = i - r * cols;
    float val = 0.f;
    if (n0 + r < n) val = base[(long long)(n0 + r) * st.n + c];
    dst[r * pitch + c] = val;
  }
}

// Grid (B * h, ceil(nq / BQ)).  DM is the largest of d and dv the instance
// takes (64 or 128).
template <int DM>
__global__ void __launch_bounds__(THREADS)
simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ bias,
            float* __restrict__ out, int H, int nq, int nk, int d, int dv, Strides sq,
            Strides sk, Strides sv, Strides sbias, float scale) {
  constexpr int P = DM + 1;  // pitch of the q and k tiles (conflict-free column reads)
  constexpr int NC = DM / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;             // BQ x P
  float* ks = qs + BQ * P;      // BKT x P
  float* vs = ks + BKT * P;     // BKT x DM
  float* ss = vs + BKT * DM;    // BQ x SP: scores, then probabilities
  float* alpha_s = ss + BQ * SP;  // BQ: this tile's rescale of each row
  float* l_s = alpha_s + BQ;      // BQ: each row's final sum

  const int b = blockIdx.x / H;
  const int head = blockIdx.x - b * H;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  // score patch / output patch: rows 4*qg .. 4*qg+3, key or column cl + 16*j
  const int qg = tid >> 4;
  const int cl = tid & 15;
  // softmax: row srow, keys 16*spart .. 16*spart+15 of the tile
  const int srow = tid >> 2;
  const int spart = tid & 3;

  stage(qs, P, q, sq, b, head, q0, BQ, nq, d);

  float m_run = NEG;  // the same in the four threads of a row
  float l_run = 0.f;
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
  }
  const float* brow = bias == nullptr ? nullptr : bias + b * sbias.b + head * sbias.h;

  for (int k0 = 0; k0 < nk; k0 += BKT) {
    __syncthreads();  // the previous tile's k, v and probabilities are consumed
    stage(ks, P, k, sk, b, head, k0, BKT, nk, d);
    stage(vs, DM, v, sv, b, head, k0, BKT, nk, dv);
    __syncthreads();

    float sacc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) sacc[i][j] = 0.f;
    }
    for (int c = 0; c < d; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(4 * qg + i) * P + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(cl + 16 * j) * P + c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) sacc[i][j] = fmaf(qv[i], kv[j], sacc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = 4 * qg + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + cl + 16 * j;
        float s = -CUDART_INF_F;  // past nk: excluded exactly
        if (key < nk) {
          s = sacc[i][j] * scale;
          if (brow != nullptr && q0 + row < nq) {
            s += brow[(long long)(q0 + row) * sbias.n + key];
          }
        }
        ss[row * SP + cl + 16 * j] = s;
      }
    }
    __syncthreads();

    // fold the tile into each row's running max and sum
    float* srow_p = ss + srow * SP + 16 * spart;
    float mloc = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < 16; ++j) mloc = fmaxf(mloc, srow_p[j]);
    mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 1));
    mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 2));
    const float m_new = fmaxf(m_run, mloc);
    float lsum = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float p = expf(srow_p[j] - m_new);
      srow_p[j] = p;
      lsum += p;
    }
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    const float alpha = expf(m_run - m_new);
    l_run = alpha * l_run + lsum;
    m_run = m_new;
    if (spart == 0) alpha_s[srow] = alpha;
    __syncthreads();

    // rescale the output patch, then add this tile's P @ V
    const int live = min(BKT, nk - k0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = alpha_s[4 * qg + i];
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= a;
    }
    for (int kk = 0; kk < live; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ss[(4 * qg + i) * SP + kk];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float vv = vs[kk * DM + cl + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

  if (spart == 0) l_s[srow] = l_run;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * qg + i;
    if (row >= nq) continue;
    const float l = fmaxf(l_s[4 * qg + i], 1e-30f);
    float* orow = out + (((long long)b * nq + row) * H + head) * dv;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = cl + 16 * j;
      if (c < dv) orow[c] = acc[i][j] / l;
    }
  }
}

template <int DM>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (DM + 1) + BKT * (DM + 1) + BKT * DM + BQ * SP + 2 * BQ);
}

template <int DM>
cudaError_t launch(const float* q, const float* k, const float* v, const float* bias, float* out,
                   int B, int H, int nq, int nk, int d, int dv, Strides sq, Strides sk,
                   Strides sv, Strides sb, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DM>();
  cudaError_t err = cudaFuncSetAttribute(simt_kernel<DM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (nq + BQ - 1) / BQ);
  simt_kernel<DM><<<grid, THREADS, smem, stream>>>(q, k, v, bias, out, H, nq, nk, d, dv, sq, sk,
                                                    sv, sb, scale);
  return cudaGetLastError();
}

}  // namespace simt

// ==================================================================== MMA
namespace mma {

constexpr int MQ = 64;  // queries per block, 16 per warp
constexpr int MK = 64;  // keys per tile
constexpr int THREADS = 128;

// Stage rows [n0, n0 + 64) x columns [0, colsp) of one head of a
// (B, n, h, cols) bf16 tensor into shared memory (pitch `pitch`), zeros past
// n and past cols.  aligned: base, strides and cols are multiples of 8
// elements, so each 8-element chunk is one 16-byte cp.async.
__device__ __forceinline__ void stage(bf16* dst, int pitch, const bf16* base, long long sn,
                                      int n0, int n, int cols, int colsp, bool aligned) {
  const int chunks = colsp / 8;
  for (int e = threadIdx.x; e < MK * chunks; e += THREADS) {
    const int r = e / chunks;
    const int c = (e - r * chunks) * 8;
    bf16* to = dst + r * pitch + c;
    if (n0 + r < n && c < cols) {
      const bf16* from = base + (long long)(n0 + r) * sn + c;
      if (aligned) {
        hopper::cp_async16(to, from);
        continue;
      }
      alignas(16) bf16 tmp[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) tmp[i] = c + i < cols ? from[i] : __float2bfloat16_rn(0.f);
      *reinterpret_cast<uint4*>(to) = *reinterpret_cast<const uint4*>(tmp);
    } else {
      *reinterpret_cast<uint4*>(to) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Grid (B * h, ceil(nq / 64)).  DM (64 or 128) is the largest of d and dv
// the instance takes.
template <int DM>
__global__ void __launch_bounds__(THREADS)
kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
       const float* __restrict__ bias, float* __restrict__ out, int H, int nq, int nk, int d,
       int dv, Strides sq, Strides sk, Strides sv, Strides sb, float scale, int aligned) {
  constexpr int PITCH = DM + 8;  // bf16; 16 bytes of padding: conflict-free fragment reads
  constexpr int KS = DM / 16;    // k16 steps of Q K^T; 16-column pairs of P V
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // MQ x PITCH
  bf16* ks = qs + MQ * PITCH;                    // 2 x MK x PITCH
  bf16* vs = ks + 2 * MK * PITCH;                // 2 x MK x PITCH

  const int b = blockIdx.x / H;
  const int head = blockIdx.x - b * H;
  const int q0 = blockIdx.y * MQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int dp = (d + 15) & ~15, dvp = (dv + 15) & ~15;
  const bool al = aligned != 0;
  const bf16* qb = q + b * sq.b + head * sq.h;
  const bf16* kb = k + b * sk.b + head * sk.h;
  const bf16* vb = v + b * sv.b + head * sv.h;

  stage(qs, PITCH, qb, sq.n, q0, nq, d, dp, al);
  stage(ks, PITCH, kb, sk.n, 0, nk, d, dp, al);
  stage(vs, PITCH, vb, sv.n, 0, nk, dv, dvp, al);
  hopper::cp_async_commit();

  const int ra = q0 + warp * 16 + g;  // the thread's two query rows
  const int rb = ra + 8;
  const bool live = q0 + warp * 16 < nq;
  const float* brow = bias == nullptr ? nullptr : bias + b * sb.b + head * sb.h;

  uint32_t qf[KS][4];
  float o[2 * KS][4];
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  }
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;

  const int ntiles = (nk + MK - 1) / MK;
  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * MK;
    const int buf = it & 1;
    if (it + 1 < ntiles) {  // the next tile loads while this one is used
      stage(ks + (buf ^ 1) * MK * PITCH, PITCH, kb, sk.n, k0 + MK, nk, d, dp, al);
      stage(vs + (buf ^ 1) * MK * PITCH, PITCH, vb, sv.n, k0 + MK, nk, dv, dvp, al);
    }
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();
    __syncthreads();

    if (live) {
      if (it == 0) {
        const bf16* qr = qs + (warp * 16 + g) * PITCH + 2 * tq;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          qf[kk][0] = *reinterpret_cast<const uint32_t*>(qr + kk * 16);
          qf[kk][1] = *reinterpret_cast<const uint32_t*>(qr + 8 * PITCH + kk * 16);
          qf[kk][2] = *reinterpret_cast<const uint32_t*>(qr + kk * 16 + 8);
          qf[kk][3] = *reinterpret_cast<const uint32_t*>(qr + 8 * PITCH + kk * 16 + 8);
        }
      }
      const bf16* kt = ks + buf * MK * PITCH;
      const bf16* vt = vs + buf * MK * PITCH;

      // S = Q K^T for this warp's 16 queries x 64 keys
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        if (kk * 16 < dp) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const bf16* kr = kt + (8 * j + g) * PITCH + kk * 16 + 2 * tq;
            hopper::mma_bf16(s[j], qf[kk], *reinterpret_cast<const uint32_t*>(kr),
                             *reinterpret_cast<const uint32_t*>(kr + 8));
          }
        }
      }

      // scale, bias, keys past nk excluded; the online softmax in registers
      float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * tq + (e & 1);
          const int row = e < 2 ? ra : rb;
          float val = -CUDART_INF_F;
          if (key < nk) {
            val = s[j][e] * scale;
            if (brow != nullptr && row < nq) val += brow[(long long)row * sb.n + key];
          }
          s[j][e] = val;
          if (e < 2) mx0 = fmaxf(mx0, val); else mx1 = fmaxf(mx1, val);
        }
      }
      const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
      const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(s[j][e] - (e < 2 ? m0 : m1));
          s[j][e] = p;
          if (e < 2) ls0 += p; else ls1 += p;
        }
      }
      l0 = l0 * a0 + ls0;  // per-thread partial sums; the quad's add up at the end
      l1 = l1 * a1 + ls1;
#pragma unroll
      for (int n = 0; n < 2 * KS; ++n) {
        o[n][0] *= a0;
        o[n][1] *= a0;
        o[n][2] *= a1;
        o[n][3] *= a1;
      }

      // O += P V, P in three bf16 terms, each exact against the bf16 V
      const int mtx = lane >> 3;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (k0 + kk * 16 < nk) {
          uint32_t hi[4], mid[4], lo[4];
          hopper::split3(s[2 * kk][0], s[2 * kk][1], hi[0], mid[0], lo[0]);
          hopper::split3(s[2 * kk][2], s[2 * kk][3], hi[1], mid[1], lo[1]);
          hopper::split3(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], mid[2], lo[2]);
          hopper::split3(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], mid[3], lo[3]);
          const bf16* vr = vt + (kk * 16 + (mtx & 1) * 8 + (lane & 7)) * PITCH + (mtx >> 1) * 8;
#pragma unroll
          for (int np = 0; np < KS; ++np) {
            if (np * 16 < dvp) {
              uint32_t bv[4];
              hopper::ldmatrix_x4_trans(bv, vr + np * 16);
              hopper::mma_bf16(o[2 * np], hi, bv[0], bv[1]);
              hopper::mma_bf16(o[2 * np], mid, bv[0], bv[1]);
              hopper::mma_bf16(o[2 * np], lo, bv[0], bv[1]);
              hopper::mma_bf16(o[2 * np + 1], hi, bv[2], bv[3]);
              hopper::mma_bf16(o[2 * np + 1], mid, bv[2], bv[3]);
              hopper::mma_bf16(o[2 * np + 1], lo, bv[2], bv[3]);
            }
          }
        }
      }
    }
    __syncthreads();  // this buffer is free for the tile after next
  }
  if (!live) return;

  const float inv0 = 1.f / fmaxf(quad_sum(l0), 1e-30f);
  const float inv1 = 1.f / fmaxf(quad_sum(l1), 1e-30f);
  float* oa = out + (((long long)b * nq + ra) * H + head) * dv;
  float* ob = out + (((long long)b * nq + rb) * H + head) * dv;
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n) {
    const int col = 8 * n + 2 * tq;
    if (col >= dv) continue;
    const bool two = col + 1 < dv;
    if (ra < nq) {
      oa[col] = o[n][0] * inv0;
      if (two) oa[col + 1] = o[n][1] * inv0;
    }
    if (rb < nq) {
      ob[col] = o[n][2] * inv1;
      if (two) ob[col + 1] = o[n][3] * inv1;
    }
  }
}

template <int DM>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, const float* bias, float* out,
                   int B, int H, int nq, int nk, int d, int dv, Strides sq, Strides sk,
                   Strides sv, Strides sb, float scale, int aligned, cudaStream_t stream) {
  constexpr size_t smem = sizeof(bf16) * (MQ + 4 * MK) * (DM + 8);
  cudaError_t err = cudaFuncSetAttribute(kernel<DM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (nq + MQ - 1) / MQ);
  kernel<DM><<<grid, THREADS, smem, stream>>>(q, k, v, bias, out, H, nq, nk, d, dv, sq, sk, sv,
                                              sb, scale, aligned);
  return cudaGetLastError();
}

}  // namespace mma

// ================================================================= DECODE
namespace decode {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int CHUNK = 256;  // keys whose scores a warp keeps in shared memory
constexpr int R = 8;        // rounds of bf16 keys whose loads are issued together (f32: 4)
constexpr int BLOCKS = 3;   // blocks per SM: 24 warps hide the loads; 85 registers each

// A key's 8 elements as raw 16-byte words (one for bf16, two for f32), so
// that a batch of loads holds few registers until it is used.
template <typename T>
struct Raw {
  static constexpr int WORDS = sizeof(T) / 2;
  uint4 w[WORDS];
};

// `valid` (<= 0 .. 8) elements from p, zeros after; one 16-byte load per
// word when aligned and whole.
template <typename T>
__device__ __forceinline__ Raw<T> load8(const T* p, int valid, bool aligned) {
  Raw<T> r;
  if (aligned && valid >= 8) {
#pragma unroll
    for (int i = 0; i < Raw<T>::WORDS; ++i) r.w[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
    return r;
  }
  T* e = reinterpret_cast<T*>(r.w);
#pragma unroll
  for (int i = 0; i < 8; ++i) e[i] = i < valid ? p[i] : T(0.f);
  return r;
}

__device__ __forceinline__ void widen8(const Raw<bf16>& r, float (&out)[8]) {
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(r.w);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void widen8(const Raw<float>& r, float (&out)[8]) {
  const float* f = reinterpret_cast<const float*>(r.w);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = f[i];
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One warp per (batch, query, head); `pairs` = B * nq * h of them.
template <typename T>
__global__ void __launch_bounds__(THREADS, BLOCKS)
kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
       const float* __restrict__ bias, float* __restrict__ out, int H, int nq, int nk, int d,
       int dv, Strides sq, Strides sk, Strides sv, Strides sb, float scale, int aligned,
       int pairs) {
  constexpr int RT = R * 2 / (int)sizeof(T);
  __shared__ float scores[WARPS][CHUNK];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pair = blockIdx.x * WARPS + warp;
  if (pair >= pairs) return;  // the kernel has no block-wide barrier
  const int head = pair % H;
  const int i = (pair / H) % nq;
  const int b = pair / (H * nq);
  const int width = (max(d, dv) + 7) / 8;
  int G = 1;  // lanes per key: a power of two holding 8 elements each
  while (G < width) G <<= 1;
  const int P = 32 / G;  // keys per round
  const int grp = lane / G;
  const int c = (lane % G) * 8;
  const bool al = aligned != 0;

  float qv[8];
  widen8(load8(q + b * sq.b + i * sq.n + head * sq.h + c, d - c, al), qv);
  const T* kb = k + b * sk.b + head * sk.h + c;
  const T* vb = v + b * sv.b + head * sv.h + c;
  const float* brow = bias == nullptr ? nullptr : bias + b * sb.b + head * sb.h + i * sb.n;
  float* sc = scores[warp];

  float m = NEG, l = 0.f, acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;
  for (int ch = 0; ch < nk; ch += CHUNK) {
    const int n = min(CHUNK, nk - ch);
    // scores: every load of a batch is issued before the first reduction
    for (int j0 = 0; j0 < n; j0 += P * RT) {
      Raw<T> kr[RT];
#pragma unroll
      for (int u = 0; u < RT; ++u) {
        const int j = j0 + u * P + grp;
        kr[u] = load8(kb + (long long)(ch + j) * sk.n, j < n ? d - c : 0, al);
      }
#pragma unroll
      for (int u = 0; u < RT; ++u) {
        float kv[8];
        widen8(kr[u], kv);
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) part = fmaf(qv[e], kv[e], part);
        for (int o = G / 2; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
        const int j = j0 + u * P + grp;
        if (j < n && lane % G == 0) {
          sc[j] = part * scale + (brow != nullptr ? brow[ch + j] : 0.f);
        }
      }
    }
    __syncwarp();
    // the exact max of the chunk before any exponent, then its weights
    float cmax = -CUDART_INF_F;
    for (int j = lane; j < n; j += 32) cmax = fmaxf(cmax, sc[j]);
    const float mn = fmaxf(m, warp_max(cmax));
    const float alpha = expf(m - mn);
    float ls = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = expf(sc[j] - mn);
      sc[j] = p;
      ls += p;
    }
    l = l * alpha + warp_sum(ls);
    m = mn;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] *= alpha;
    __syncwarp();
    // p . v in f32; keys of weight 0 are not loaded
    for (int j0 = 0; j0 < n; j0 += P * RT) {
      Raw<T> vr[RT];
      float w[RT];
#pragma unroll
      for (int u = 0; u < RT; ++u) {
        const int j = j0 + u * P + grp;
        w[u] = j < n ? sc[j] : 0.f;
        vr[u] = load8(vb + (long long)(ch + j) * sv.n, w[u] != 0.f ? dv - c : 0, al);
      }
#pragma unroll
      for (int u = 0; u < RT; ++u) {
        float vv[8];
        widen8(vr[u], vv);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] = fmaf(w[u], vv[e], acc[e]);
      }
    }
    __syncwarp();  // the next chunk overwrites the scores
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    for (int o = G; o < 32; o <<= 1) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  }
  if (grp == 0) {
    float* orow = out + (((long long)b * nq + i) * H + head) * dv;
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (c + e < dv) orow[c + e] = acc[e] * inv;
    }
  }
}

template <typename T>
cudaError_t launch(const T* q, const T* k, const T* v, const float* bias, float* out, int B,
                   int H, int nq, int nk, int d, int dv, Strides sq, Strides sk, Strides sv,
                   Strides sb, float scale, int aligned, cudaStream_t stream) {
  const int pairs = B * nq * H;
  kernel<T><<<(pairs + WARPS - 1) / WARPS, THREADS, 0, stream>>>(
      q, k, v, bias, out, H, nq, nk, d, dv, sq, sk, sv, sb, scale, aligned, pairs);
  return cudaGetLastError();
}

}  // namespace decode

}  // namespace

extern "C" {

// Largest d and dv the kernel takes.
int openviic_fused_attention_max_head_dim(void) { return 128; }

// Launch on `stream`; returns cudaGetLastError(), or cudaErrorInvalidValue
// for a tile the dtype or the grid does not allow.  Strides are in
// elements, (batch, position, head) for q, k, v and (batch, head, query)
// for the bias (null for none; its key axis contiguous).  tile: 0 SIMT (f32
// only), 1 MMA (bf16 only), 2 DECODE; aligned: the q/k/v bases and strides
// and d, dv are multiples of 8 elements (16-byte loads; the caller checks
// the bases are 16-byte aligned).  The caller guarantees 1 <= d, dv <= 128,
// B * h * nq < 2^31 and an f32 output (B, nq, h, dv), contiguous.
int openviic_fused_attention(const void* q, const void* k, const void* v, const void* bias,
                             void* out, int B, int H, int nq, int nk, int d, int dv,
                             long long sqb, long long sqn, long long sqh,
                             long long skb, long long skn, long long skh,
                             long long svb, long long svn, long long svh,
                             long long sbb, long long sbh, long long sbq,
                             int is_bf16, int tile, int aligned, float scale, void* stream) {
  const Strides sq{sqb, sqn, sqh}, sk{skb, skn, skh}, sv{svb, svn, svh}, sb{sbb, sbq, sbh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  float* o = static_cast<float*>(out);
  const bool wide = d > 64 || dv > 64;
  if (tile == DECODE) {
    if (is_bf16) {
      const bf16 *qq = static_cast<const bf16*>(q), *kk = static_cast<const bf16*>(k),
                 *vv = static_cast<const bf16*>(v);
      return decode::launch(qq, kk, vv, b, o, B, H, nq, nk, d, dv, sq, sk, sv, sb, scale,
                            aligned, st);
    }
    const float *qq = static_cast<const float*>(q), *kk = static_cast<const float*>(k),
                *vv = static_cast<const float*>(v);
    return decode::launch(qq, kk, vv, b, o, B, H, nq, nk, d, dv, sq, sk, sv, sb, scale, aligned,
                          st);
  }
  if (tile == MMA && is_bf16 && (nq + mma::MQ - 1) / mma::MQ < 65536) {
    const bf16 *qq = static_cast<const bf16*>(q), *kk = static_cast<const bf16*>(k),
               *vv = static_cast<const bf16*>(v);
    return wide ? mma::launch<128>(qq, kk, vv, b, o, B, H, nq, nk, d, dv, sq, sk, sv, sb, scale,
                                   aligned, st)
                : mma::launch<64>(qq, kk, vv, b, o, B, H, nq, nk, d, dv, sq, sk, sv, sb, scale,
                                  aligned, st);
  }
  if (tile == SIMT && !is_bf16 && (nq + simt::BQ - 1) / simt::BQ < 65536) {
    const float *qq = static_cast<const float*>(q), *kk = static_cast<const float*>(k),
                *vv = static_cast<const float*>(v);
    return wide ? simt::launch<128>(qq, kk, vv, b, o, B, H, nq, nk, d, dv, sq, sk, sv, sb, scale,
                                    st)
                : simt::launch<64>(qq, kk, vv, b, o, B, H, nq, nk, d, dv, sq, sk, sv, sb, scale,
                                   st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
