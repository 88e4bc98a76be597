// Flash-style multi-head attention with an additive f32 bias, for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel openviic_tpu/ops/pallas_attention.py::
// fused_attention (its pallas_call in _fused_attention_padded).  For
// q (B, nq, h, d), k (B, nk, h, d), v (B, nk, h, dv) in f32 or bf16 (any
// strides over batch, position and head; the last axis contiguous) and an
// optional f32 bias that broadcasts to (B, h, nq, nk) (strides may be 0),
// it computes, in f32 throughout,
//   s   = (q . k) * scale + bias
//   out = softmax(s) @ v                     (B, nq, h, dv), f32
// with an online softmax over k tiles.  The running max starts at -1e30, as
// the JAX kernel's does, so a row whose every key carries the -1e30 mask
// bias is uniform over its nk keys, not NaN; keys past nk in the last tile
// are excluded exactly.  bf16 inputs are exact in f32: they are widened as
// they are staged, and the wrapper makes no f32 copy.
//
// What bounds it on an H100 SXM: at the flagship encoder shape (B = 320,
// nq = nk = 56, h = 8, d = 64, bf16 in, f32 out) q . k is 1.03 GFLOP of
// bf16 operands (~1 us at the tensor cores' 989 TFLOP/s) and p . v 1.03
// GFLOP with the f32 p (~15 us at 67 TFLOP/s outside the tensor cores),
// against 55 MB of bf16 q/k/v and 37 MB of f32 output, ~27 us at 3.35 TB/s;
// so the bytes bound it, as they do at the non-resident decode step (1600
// rows, nq = 1, nk = 25 or 56).
//
// Design (simple first): one block of 128 threads per (batch, head, 32-query
// tile).  Per 64-key tile it stages K and V in shared memory as f32, each
// thread computes a 4 x 4 patch of the 32 x 64 score tile from shared
// memory, four threads per query row fold the tile into the row's running
// (max, sum) with warp shuffles, and each thread accumulates a 4-row x
// dv/16-column patch of the output in registers.  Tensor cores, a pipelined
// tile ring and a tile shape for nq = 1 are left for a later change.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int BQ = 32;        // queries per block
constexpr int BKT = 64;       // keys per tile
constexpr int THREADS = 128;  // 4 threads per query row of the softmax
constexpr int SP = BKT + 1;   // f32 pitch of the score tile
constexpr float NEG = -1e30f; // the JAX kernels' additive mask and initial max

static_assert(THREADS == 4 * BQ, "four softmax threads per query row");
static_assert(BKT == 4 * 16, "each softmax thread folds 16 keys");

struct Strides {
  long long b, n, h;  // elements between batch entries, positions and heads
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

// Stage `rows` rows (from position n0) x `cols` columns of one head of a
// (B, n, h, cols) tensor into shared memory as f32 with pitch `pitch`,
// zero-filling rows past `n`.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int pitch, const T* src, Strides st,
                                      int b, int head, int n0, int rows, int n, int cols) {
  const T* base = src + b * st.b + head * st.h;
  for (int i = threadIdx.x; i < rows * cols; i += THREADS) {
    const int r = i / cols;
    const int c = i - r * cols;
    float val = 0.f;
    if (n0 + r < n) val = widen(base[(long long)(n0 + r) * st.n + c]);
    dst[r * pitch + c] = val;
  }
}

// Grid (B * h, ceil(nq / BQ)).  DM is the largest of d and dv the instance
// takes (64 or 128).
template <typename T, int DM>
__global__ void __launch_bounds__(THREADS)
fused_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const float* __restrict__ bias,
                       float* __restrict__ out, int H, int nq, int nk, int d, int dv,
                       Strides sq, Strides sk, Strides sv, Strides sbias, float scale) {
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

template <typename T, int DM>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias, void* out,
                   int B, int H, int nq, int nk, int d, int dv, Strides sq, Strides sk,
                   Strides sv, Strides sb, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DM>();
  cudaError_t err = cudaFuncSetAttribute(fused_attention_kernel<T, DM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (nq + BQ - 1) / BQ);
  fused_attention_kernel<T, DM><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<float*>(out), H, nq, nk, d, dv,
      sq, sk, sv, sb, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest d and dv the kernel takes.
int openviic_fused_attention_max_head_dim(void) { return 128; }

// Launch on `stream`; returns cudaGetLastError().  Strides are in elements,
// (batch, position, head) for q, k, v and (batch, head, query) for the bias
// (null for none; its key axis contiguous).  The caller guarantees
// 1 <= d, dv <= 128, B * h < 2^31, nq / 32 < 65536 and an f32 output
// (B, nq, h, dv), contiguous.
int openviic_fused_attention(const void* q, const void* k, const void* v, const void* bias,
                             void* out, int B, int H, int nq, int nk, int d, int dv,
                             long long sqb, long long sqn, long long sqh,
                             long long skb, long long skn, long long skh,
                             long long svb, long long svn, long long svh,
                             long long sbb, long long sbh, long long sbq,
                             int bf16, float scale, void* stream) {
  const Strides sq{sqb, sqn, sqh}, sk{skb, skn, skh}, sv{svb, svn, svh}, sb{sbb, sbq, sbh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = d > 64 || dv > 64;
  if (bf16) {
    return wide ? launch<__nv_bfloat16, 128>(q, k, v, bias, out, B, H, nq, nk, d, dv, sq, sk,
                                             sv, sb, scale, st)
                : launch<__nv_bfloat16, 64>(q, k, v, bias, out, B, H, nq, nk, d, dv, sq, sk,
                                            sv, sb, scale, st);
  }
  return wide ? launch<float, 128>(q, k, v, bias, out, B, H, nq, nk, d, dv, sq, sk, sv, sb,
                                   scale, st)
              : launch<float, 64>(q, k, v, bias, out, B, H, nq, nk, d, dv, sq, sk, sv, sb,
                                  scale, st);
}

}  // extern "C"
