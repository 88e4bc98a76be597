// Beam-resident self-attention of one decode step, for Hopper (sm_90a).
//
// Replaces the Pallas kernel
// openviic_tpu/ops/beam_select_attention.py::beam_select_attention.  For
// q (N, h, dk), the append-only caches k (N, L, h, dk) and v (N, L, h, dv)
// (N = bs * beam rows, never reordered), the ancestry (N, L) (the slot, within
// the row's image, of position l of the row's prefix) and the mask (N, L)
// (1 = masked; read at the row itself, or at the ancestor's row when the mask
// is the raw per-slot one), it computes per row and head
//   s_l   = (q . k[src_l, l]) * scale, or -1e30 where position l is masked
//   out   = sum_l softmax(s)_l * v[src_l, l]          (f32, then bf16)
// with src_l = (n / beam) * beam + ancestry[n, l].
//
// What bounds it on an H100 SXM (3.35 TB/s; the arithmetic is ~2 FLOP per
// byte read): the bytes.  At the flagship decode step (N = 1600, L = 25,
// h = 8, dk = dv = 64, bf16) a full cache is 2 x 41 MB, about 25 us at
// 3.35 TB/s; at step t only the t + 1 live positions of each prefix are read.
//
// Design: the TPU kernel selected each ancestor's rows by a one-hot product
// over the image's beam slots, because Mosaic has no gather.  Here each
// block owns one row and loads only the ancestor's rows, by index: one warp
// per head, each lane holding two elements of the head's q, so a position's
// key is one coalesced 128-byte load per warp and the dot is a warp
// shuffle-reduction.  Masked positions skip their K load (their score is
// -1e30 exactly, as the additive mask gives for any finite score), and V
// rows whose softmax weight is exactly 0 are not loaded.  The scores of the
// row's positions wait in shared memory between the two softmax passes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
constexpr int MAXC = 8;  // element pairs per lane: head dims up to 2 * 32 * 8 = 512

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Grid (N), block (h * 32): warp `head` of block n.  Dynamic shared memory:
// h * L floats of scores.
__global__ void beam_select_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int64_t* __restrict__ anc,
    const uint8_t* __restrict__ pmask, __nv_bfloat16* __restrict__ out,
    int L, int h, int dk, int dv, int beam, int mask_on_slot, float scale) {
  extern __shared__ float scores[];
  const int n = blockIdx.x;
  const int head = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* s = scores + head * L;
  const int base = (n / beam) * beam;
  const size_t krow = (size_t)h * dk;
  const size_t vrow = (size_t)h * dv;

  float qv[MAXC][2];
  const __nv_bfloat16* qp = q + (size_t)n * krow + (size_t)head * dk;
#pragma unroll
  for (int i = 0; i < MAXC; ++i) {
    const int c = 2 * lane + 64 * i;
    float2 f = make_float2(0.f, 0.f);
    if (c < dk) f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qp + c));
    qv[i][0] = f.x;
    qv[i][1] = f.y;
  }

  // pass 1: scores and their max
  float m = -CUDART_INF_F;
  for (int j = 0; j < L; ++j) {
    const int src = base + (int)anc[(size_t)n * L + j];
    const bool dead = pmask[(size_t)(mask_on_slot ? src : n) * L + j] != 0;
    float sj = NEG;
    if (!dead) {
      const __nv_bfloat16* kp = k + ((size_t)src * L + j) * krow + (size_t)head * dk;
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < MAXC; ++i) {
        const int c = 2 * lane + 64 * i;
        if (c < dk) {
          const float2 kk = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(kp + c));
          acc += kk.x * qv[i][0] + kk.y * qv[i][1];
        }
      }
      sj = warp_sum(acc) * scale;
    }
    if (lane == 0) s[j] = sj;
    m = fmaxf(m, sj);
  }
  __syncwarp();

  // pass 2: the softmax's denominator, then the weighted sum of V
  float denom = 0.f;
  for (int j = 0; j < L; ++j) denom += expf(s[j] - m);
  float o[MAXC][2];
#pragma unroll
  for (int i = 0; i < MAXC; ++i) o[i][0] = o[i][1] = 0.f;
  for (int j = 0; j < L; ++j) {
    const float a = expf(s[j] - m) / denom;
    if (a == 0.f) continue;
    const int src = base + (int)anc[(size_t)n * L + j];
    const __nv_bfloat16* vp = v + ((size_t)src * L + j) * vrow + (size_t)head * dv;
#pragma unroll
    for (int i = 0; i < MAXC; ++i) {
      const int c = 2 * lane + 64 * i;
      if (c < dv) {
        const float2 vv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(vp + c));
        o[i][0] += vv.x * a;
        o[i][1] += vv.y * a;
      }
    }
  }
  __nv_bfloat16* op = out + (size_t)n * vrow + (size_t)head * dv;
#pragma unroll
  for (int i = 0; i < MAXC; ++i) {
    const int c = 2 * lane + 64 * i;
    if (c < dv) {
      *reinterpret_cast<__nv_bfloat162*>(op + c) = __floats2bfloat162_rn(o[i][0], o[i][1]);
    }
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError().  The caller guarantees
// contiguous tensors, h <= 32, even dk and dv <= 512, and
// 0 <= ancestry < beam.
int openviic_beam_select_attention(const void* q, const void* k, const void* v,
                                   const void* anc, const void* pmask, void* out,
                                   int N, int L, int h, int dk, int dv, int beam,
                                   int mask_on_slot, float scale, void* stream) {
  const size_t smem = (size_t)h * L * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        beam_select_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  beam_select_attention_kernel<<<N, h * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int64_t*>(anc),
      static_cast<const uint8_t*>(pmask), static_cast<__nv_bfloat16*>(out),
      L, h, dk, dv, beam, mask_on_slot, scale);
  return cudaGetLastError();
}

}  // extern "C"
