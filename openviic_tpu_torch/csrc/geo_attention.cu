// Object Relation Transformer attention with its geometric bias built in the
// kernel from the boxes, for Hopper (sm_90a).
//
// Replaces the Pallas kernel openviic_tpu/ops/geo_attention.py::
// geo_fused_attention.  For q, k, v (bs, n, h, dk) bf16, contiguous, the
// per-box geometry rows geo (bs, 4, n) f32 (centre x, centre y, log(w + 1),
// log(h + 1)), the padding mask (bs, n) f32 (1 = masked) and the fc_g weights
// split into their sin and cos halves ((4, dim_g/8, h) each, f32) with bias
// (h,), it computes per (image, query i, key j):
//   disp  = log(max(|dcx / w_i|, 1e-3)), log(max(|dcy / h_i|, 1e-3)),
//           log w_i - log w_j, log h_i - log h_j        (w_i = exp(log w_i))
//   g_h   = sum_{s, f} wsin[s, f, h] sin(disp_s * omega_f)
//                    + wcos[s, f, h] cos(disp_s * omega_f)
//   bias  = log(max(relu(g_h + b_h), 1e-6)) - 1e30 * mask_j
//   s     = (q_i . k_j) * scale + bias                     (f32)
//   p     = softmax_j(s), rounded to bf16
//   out   = p @ v, f32 accumulation, written in the output's dtype
// never writing the (bs, h, n, n) bias or the (bs, n, n, dim_g) embedding to
// device memory.  The rounding points are the JAX kernel's.  sin and cos
// are the accurate sincosf: the arguments reach |100 * 6.9| ~ 690 rad, where
// the fast intrinsics (__sinf, --use_fast_math) are wrong.
//
// What bounds it on an H100 SXM: at the ORT encoder shape (bs = 320, n = 56,
// h = 8, dk = 64, dim_g = 64) the scores and PV are 2.06 GFLOP of bf16
// operands with f32 accumulation (~2 us at the tensor cores' 989 TFLOP/s),
// the per-head f32 fold of the 64 sin/cos planes 1.03 GFLOP (~15 us at 67
// TFLOP/s), and the 64 sin/cos per box pair 64 M (~15 us at the
// special-function rate), against 73 MB of bf16 q/k/v/out, ~22 us at
// 3.35 TB/s: the bytes bound it.
//
// Design (simple first): one block of 256 threads per (image, 8-query tile).
// It builds the tile's bias planes for every head once (one box pair per
// thread at a time, its h sums in registers) into shared memory, then per
// head stages K and V of the image as f32, computes the 8 x n scores, runs
// one warp per query row through the full-row softmax, and writes the
// 8 x dk outputs.  K and V are read again by each of the image's query
// tiles (from L2); tensor cores and a larger query tile are left for later.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

namespace {

constexpr int TQ = 8;          // queries per block: one softmax warp each
constexpr int THREADS = 256;
constexpr int MAXH = 16;       // heads the per-pair registers hold
constexpr float NEG = -1e30f;  // the JAX kernels' additive mask

static_assert(THREADS == 32 * TQ, "one warp per query row");

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// Grid (bs, ceil(n / TQ)).
template <typename OutT>
__global__ void __launch_bounds__(THREADS)
geo_attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const float* __restrict__ geo,
                     const float* __restrict__ mask, const float* __restrict__ wsin,
                     const float* __restrict__ wcos, const float* __restrict__ fbias,
                     const float* __restrict__ omega, OutT* __restrict__ out, int n, int H,
                     int dk, int nf, float scale) {
  extern __shared__ float smem[];
  const int KP = dk + 1;               // pitch of the k tile
  float* bias_s = smem;                // H x TQ x n
  float* ks = bias_s + H * TQ * n;     // n x KP
  float* vs = ks + n * KP;             // n x dk
  float* qs = vs + n * dk;             // TQ x dk
  float* ps = qs + TQ * dk;            // TQ x n: scores, then probabilities
  float* geo_s = ps + TQ * n;          // 4 x n
  float* mask_s = geo_s + 4 * n;       // n
  float* w_s = mask_s + n;             // 2 x (4 nf H): sin half, then cos half
  float* fb_s = w_s + 8 * nf * H;      // H
  float* om_s = fb_s + H;              // nf

  const int b = blockIdx.x;
  const int q0 = blockIdx.y * TQ;
  const int tid = threadIdx.x;
  const int nw = 4 * nf * H;
  for (int i = tid; i < 4 * n; i += THREADS) geo_s[i] = geo[(long long)b * 4 * n + i];
  for (int i = tid; i < n; i += THREADS) mask_s[i] = mask[(long long)b * n + i];
  for (int i = tid; i < nw; i += THREADS) {
    w_s[i] = wsin[i];
    w_s[nw + i] = wcos[i];
  }
  for (int i = tid; i < H; i += THREADS) fb_s[i] = fbias[i];
  for (int i = tid; i < nf; i += THREADS) om_s[i] = omega[i];
  __syncthreads();

  // the tile's geometric bias, every head, one box pair at a time
  for (int pair = tid; pair < TQ * n; pair += THREADS) {
    const int qi = pair / n;
    const int kj = pair - qi * n;
    const int iq = q0 + qi;
    if (iq >= n) continue;
    const float lwq = geo_s[2 * n + iq], lhq = geo_s[3 * n + iq];
    const float wq = expf(lwq), hq = expf(lhq);
    float disp[4];
    disp[0] = logf(fmaxf(fabsf((geo_s[iq] - geo_s[kj]) / wq), 1e-3f));
    disp[1] = logf(fmaxf(fabsf((geo_s[n + iq] - geo_s[n + kj]) / hq), 1e-3f));
    disp[2] = lwq - geo_s[2 * n + kj];
    disp[3] = lhq - geo_s[3 * n + kj];
    float acc[MAXH];
#pragma unroll
    for (int hh = 0; hh < MAXH; ++hh) acc[hh] = 0.f;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      for (int f = 0; f < nf; ++f) {
        float sn, cs;
        sincosf(disp[s] * om_s[f], &sn, &cs);
        const float* ws = w_s + (s * nf + f) * H;
        const float* wc = ws + nw;
#pragma unroll
        for (int hh = 0; hh < MAXH; ++hh) {
          if (hh < H) acc[hh] = acc[hh] + ws[hh] * sn + wc[hh] * cs;
        }
      }
    }
    const float masked = mask_s[kj] * NEG;
#pragma unroll
    for (int hh = 0; hh < MAXH; ++hh) {
      if (hh < H) {
        const float g = fmaxf(fmaxf(acc[hh] + fb_s[hh], 0.f), 1e-6f);
        bias_s[(hh * TQ + qi) * n + kj] = logf(g) + masked;
      }
    }
  }

  const int warp = tid >> 5;
  const int lane = tid & 31;
  for (int hh = 0; hh < H; ++hh) {
    __syncthreads();  // the bias is built; the previous head's tiles are consumed
    const long long head_off = (long long)b * n * H * dk + (long long)hh * dk;
    for (int i = tid; i < n * dk; i += THREADS) {
      const int r = i / dk;
      const int c = i - r * dk;
      const long long src = head_off + (long long)r * H * dk + c;
      ks[r * KP + c] = __bfloat162float(k[src]);
      vs[r * dk + c] = __bfloat162float(v[src]);
    }
    for (int i = tid; i < TQ * dk; i += THREADS) {
      const int r = i / dk;
      const int c = i - r * dk;
      qs[i] = q0 + r < n ? __bfloat162float(q[head_off + (long long)(q0 + r) * H * dk + c]) : 0.f;
    }
    __syncthreads();

    for (int pair = tid; pair < TQ * n; pair += THREADS) {
      const int qi = pair / n;
      const int kj = pair - qi * n;
      float dot = 0.f;
      for (int c = 0; c < dk; ++c) dot = fmaf(qs[qi * dk + c], ks[kj * KP + c], dot);
      ps[qi * n + kj] = dot * scale + bias_s[(hh * TQ + qi) * n + kj];
    }
    __syncthreads();

    // full-row softmax, one warp per query row; probabilities round to bf16
    if (q0 + warp < n) {
      float* row = ps + warp * n;
      float mx = -CUDART_INF_F;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, row[j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      float sum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float e = expf(row[j] - mx);
        row[j] = e;
        sum += e;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      for (int j = lane; j < n; j += 32) {
        row[j] = __bfloat162float(__float2bfloat16_rn(row[j] / sum));
      }
    }
    __syncthreads();

    for (int i = tid; i < TQ * dk; i += THREADS) {
      const int r = i / dk;
      const int c = i - r * dk;
      if (q0 + r >= n) continue;
      const float* p = ps + r * n;
      float o = 0.f;
      for (int j = 0; j < n; ++j) o = fmaf(p[j], vs[j * dk + c], o);
      store(out + head_off + (long long)(q0 + r) * H * dk + c, o);
    }
  }
}

// Bytes of shared memory a block needs (ops/geo_attention.py counts the same
// to refuse more than the card gives one block).
size_t smem_bytes(int n, int H, int dk, int nf) {
  return sizeof(float) *
         ((size_t)H * TQ * n + (size_t)n * (dk + 1) + (size_t)n * dk + TQ * dk + TQ * n +
          5 * (size_t)n + 8 * (size_t)nf * H + H + nf);
}

template <typename OutT>
cudaError_t launch(const void* q, const void* k, const void* v, const void* geo,
                   const void* mask, const void* wsin, const void* wcos, const void* fbias,
                   const void* omega, void* out, int bs, int n, int H, int dk, int nf,
                   float scale, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(geo_attention_kernel<OutT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bs, (n + TQ - 1) / TQ);
  geo_attention_kernel<OutT><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(geo),
      static_cast<const float*>(mask), static_cast<const float*>(wsin),
      static_cast<const float*>(wcos), static_cast<const float*>(fbias),
      static_cast<const float*>(omega), static_cast<OutT*>(out), n, H, dk, nf, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest number of heads the kernel takes.
int openviic_geo_attention_max_heads(void) { return MAXH; }

// Launch on `stream`; returns cudaGetLastError().  The caller guarantees
// contiguous tensors of the shapes above, 1 <= H <= 16, bs < 2^31,
// n / 8 < 65536, and out_bf16 = 1 for a bf16 output, 0 for f32.
int openviic_geo_attention(const void* q, const void* k, const void* v, const void* geo,
                           const void* mask, const void* wsin, const void* wcos,
                           const void* fbias, const void* omega, void* out, int bs, int n,
                           int H, int dk, int nf, float scale, int out_bf16, void* stream) {
  const size_t smem = smem_bytes(n, H, dk, nf);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_bf16) {
    return launch<__nv_bfloat16>(q, k, v, geo, mask, wsin, wcos, fbias, omega, out, bs, n, H,
                                 dk, nf, scale, smem, st);
  }
  return launch<float>(q, k, v, geo, mask, wsin, wcos, fbias, omega, out, bs, n, H, dk, nf,
                       scale, smem, st);
}

}  // extern "C"
