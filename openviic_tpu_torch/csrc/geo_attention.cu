// Object Relation Transformer attention with its geometric bias built in the
// kernel from the boxes, for Hopper (sm_90a).
//
// Replaces the Pallas kernel openviic_tpu/ops/geo_attention.py::
// geo_fused_attention.  For q, k, v (bs, n, h, dk) bf16, contiguous, the
// boxes (bs, n, 4) (x_min, y_min, x_max, y_max; f32, bf16 or f16), the
// padding mask (bs, n) (bytes, 1 = masked), the fc_g kernel (dim_g, h) at
// any strides with its bias (h,) (f32, bf16 or f16) and the frequencies
// omega (dim_g / 8,) f32, it computes per (image, query i, key j):
//   cx, cy = (min + max) * 0.5, lw, lh = log((max - min) + 1)
//                                    (each op rounded in the boxes' dtype)
//   disp  = log(max(|dcx / w_i|, 1e-3)), log(max(|dcy / h_i|, 1e-3)),
//           lw_i - lw_j, lh_i - lh_j                  (w_i = exp(lw_i), f32)
//   g_h   = sum_{s, f} wsin[s, f, h] sin(disp_s * omega_f)
//                    + wcos[s, f, h] cos(disp_s * omega_f)
//   bias  = log(max(relu(g_h + b_h), 1e-6)) - 1e30 * mask_j
//   s     = (q_i . k_j) * scale + bias                     (f32)
//   p     = softmax_j(s), rounded to bf16 (MMA kernel: e_j * (1 / sum))
//   out   = p @ v, f32 accumulation, written in the output's dtype
// never writing the (bs, h, n, n) bias or the (bs, n, n, dim_g) embedding to
// device memory.  The rounding points are the JAX kernel's.  sin and cos
// are accurate to about 1 f32 ulp (sincos_reduced): the arguments reach
// |100 * 6.9| ~ 690 rad for boxes in pixels, where the fast intrinsics
// (__sinf, --use_fast_math) are wrong.
//
// What bounds it on an H100 SXM: at the ORT encoder shape (bs = 320, n = 56,
// h = 8, dk = 64, dim_g = 64) the scores and PV are 2.06 GFLOP of bf16
// operands with f32 accumulation (~2 us at the tensor cores' 989 TFLOP/s),
// the per-head f32 fold of the 64 sin/cos planes 1.03 GFLOP (~15 us at 67
// TFLOP/s), and the 64 sin/cos per box pair 64 M (~15 us at the
// special-function rate), against 73 MB of bf16 q/k/v/out, ~22 us at
// 3.35 TB/s: the bytes bound it.  In practice the bias is the work: each
// accurate sin/cos is a range reduction and two polynomials on the FMA
// pipes, 32 of them per box pair before the fold.
//
// Design (the MMA kernel, dk = 64, n <= 128): one persistent block per SM,
// 16 warps (8 for n > 64), over a contiguous share of all images' 16-row
// query slabs, so that 320 images keep 132 SMs evenly busy.  When a slab of
// a new image comes, the block stages that image's K and V of every head as
// bf16 with 16-byte cp.async.  It walks its slabs in phases of two (one
// where shared memory is short): all threads build the phase's bias planes
// for every head (one box pair per thread at a time, the 32 sin/cos pairs
// shared by the heads, branch-free so that the compiler overlaps them, the
// weights read as float4, the sums in registers) into shared memory while
// the phase's Q lands by cp.async; then each warp takes a (slab, head):
// Q K^T on mma.sync m16n8k16 (bf16 operands from ldmatrix, f32
// accumulation), scale and bias, the full-row softmax in registers (rows
// across a lane quad, one reciprocal per row), p rounded to bf16 straight
// into the A fragments of P V, one bf16 product with V from
// ldmatrix.trans.  Shapes it does not take (another head dim, longer rows,
// too little shared memory) run the SIMT kernel: one block per (image,
// 8-query tile), K and V restaged per head in f32, scalar products.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math_constants.h>

#include "hopper.cuh"

// Measurement builds (scripts/torch_geo_phases.py) leave one phase of the
// MMA kernel out: -DOPENVIIC_GEO_SKIP=1 the bias build, =2 the attention.
// The port's own build takes no define.
#ifndef OPENVIIC_GEO_SKIP
#define OPENVIIC_GEO_SKIP 0
#endif

namespace {

using bf16 = __nv_bfloat16;

constexpr int MAXH = 16;       // heads the per-pair registers hold
constexpr float NEG = -1e30f;  // the JAX kernels' additive mask
constexpr unsigned FULL = 0xffffffffu;

// dtype codes of the side inputs (ops/geo_attention.py DTYPE_CODES): 0 is f32
constexpr int BF16 = 1, F16 = 2;

__device__ __forceinline__ float load_as_float(const void* p, int code, long long i) {
  if (code == BF16) return __bfloat162float(static_cast<const bf16*>(p)[i]);
  if (code == F16) return __half2float(static_cast<const __half*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

// x rounded to the dtype `code`: torch computes each op of the boxes in
// f32 and rounds the result to their dtype
__device__ __forceinline__ float round_to(float x, int code) {
  if (code == BF16) return __bfloat162float(__float2bfloat16_rn(x));
  if (code == F16) return __half2float(__float2half_rn(x));
  return x;
}

struct Side {
  const void* boxes;
  const uint8_t* mask;
  const void* w;         // fc_g kernel (dim_g, h), strides w_s0, w_s1
  const void* fbias;     // (h,), stride fb_s
  const float* omega;    // (nf,)
  long long w_s0, w_s1, fb_s;
  int box_code, w_code, fb_code;
};

// Floats of shared memory the side inputs take (ops/geo_attention.py counts
// the same): the sin and cos halves of fc_g (8 nf hp, hp >= h heads a row),
// its bias (hp), omega (nf), and per box the geometry rows cx, cy, lw, lh
// and the mask term (5 n).
__host__ __device__ __forceinline__ size_t side_floats(int n, int hp, int nf) {
  return 8 * (size_t)nf * hp + hp + nf + 5 * (size_t)n;
}

struct SideView {
  float* w;     // 2 x (4 nf) rows of hp: sin half, then cos half (heads >= h zero)
  float* fb;    // hp
  float* om;    // nf
  float* geo;   // 4 x n
  float* mask;  // n: 0 or -1e30
};

__device__ __forceinline__ SideView side_view(float* side_s, int n, int hp, int nf) {
  SideView v;
  v.w = side_s;
  v.fb = v.w + 8 * nf * hp;
  v.om = v.fb + hp;
  v.geo = v.om + nf;
  v.mask = v.geo + 4 * n;
  return v;
}

// The side inputs of image b into shared memory (plain loads and stores).
__device__ void load_side(const Side& sd, float* side_s, int b, int n, int H, int hp, int nf) {
  const SideView sv = side_view(side_s, n, hp, nf);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const long long o = ((long long)b * n + i) * 4;
    const int c = sd.box_code;
    const float x0 = load_as_float(sd.boxes, c, o), y0 = load_as_float(sd.boxes, c, o + 1);
    const float x1 = load_as_float(sd.boxes, c, o + 2), y1 = load_as_float(sd.boxes, c, o + 3);
    sv.geo[i] = round_to(round_to(x0 + x1, c) * 0.5f, c);
    sv.geo[n + i] = round_to(round_to(y0 + y1, c) * 0.5f, c);
    sv.geo[2 * n + i] = round_to(logf(round_to(round_to(x1 - x0, c) + 1.0f, c)), c);
    sv.geo[3 * n + i] = round_to(logf(round_to(round_to(y1 - y0, c) + 1.0f, c)), c);
    sv.mask[i] = sd.mask[(long long)b * n + i] ? NEG : 0.f;
  }
  const int rows = 8 * nf;  // fc_g's rows: (s, f) of the sin half, then of the cos half
  for (int i = threadIdx.x; i < rows * hp; i += blockDim.x) {
    const int row = i / hp;
    const int hh = i - row * hp;
    sv.w[i] = hh < H ? load_as_float(sd.w, sd.w_code, row * sd.w_s0 + hh * sd.w_s1) : 0.f;
  }
  for (int i = threadIdx.x; i < hp; i += blockDim.x) {
    sv.fb[i] = i < H ? load_as_float(sd.fbias, sd.fb_code, i * sd.fb_s) : 0.f;
  }
  for (int i = threadIdx.x; i < nf; i += blockDim.x) sv.om[i] = sd.omega[i];
}

// sin and cos of x, branch-free, for |x| <= 1e5: the three-constant
// Cody-Waite reduction by pi/2 in FMAs that sincosf takes below 105615,
// then minimax polynomials on [-pi/4, pi/4] (about 1 f32 ulp).  Here
// |x| <= 100 |disp| <= 100 * 88.8 for any finite boxes (disp is a log of
// an f32 value, or a difference of two logs of at most 88.8 each), so
// sincosf's Payne-Hanek branch is never taken; being a branch, it kept
// the compiler from overlapping the 32 calls of a box pair.  Not the
// special-function unit's __sinf/__cosf, which are wrong this far out.
__device__ __forceinline__ void sincos_reduced(float x, float& sn, float& cs) {
  const float j = rintf(x * 0.636619772f);
  float t = fmaf(j, -1.5707962512969971e+00f, x);
  t = fmaf(j, -7.5497894158615964e-08f, t);
  t = fmaf(j, -5.3903029534742384e-15f, t);
  const float t2 = t * t;
  float ps = fmaf(-1.95152959e-4f, t2, 8.33216087e-3f);
  ps = fmaf(ps, t2, -1.66666546e-1f);
  ps = fmaf(ps * t2, t, t);
  float pc = fmaf(2.44331571e-5f, t2, -1.38873163e-3f);
  pc = fmaf(pc, t2, 4.16666457e-2f);
  pc = fmaf(pc, t2, -0.5f);
  pc = fmaf(pc, t2, 1.0f);
  const int q = (int)j;  // x = t + q pi / 2
  const float s0 = (q & 1) ? pc : ps;
  const float c0 = (q & 1) ? ps : pc;
  sn = (q & 2) ? -s0 : s0;
  cs = ((q + 1) & 2) ? -c0 : c0;
}

// The bias planes of query rows [r0, r0 + rows) for every head:
// bias[hh * hstride + qi * rstride + kj], one box pair per thread at a time
// (two or four, sharing the weights' loads, measured slower), the h sums in
// registers (HB >= H of them).  VEC: the weights lie HB to a row (hp ==
// HB, a multiple of 4, heads >= H zero), read as float4; otherwise hp = H
// to a row, read one by one.
template <int HB, bool VEC>
__device__ void build_bias(float* side_s, float* bias, int r0, int rows, int n, int H, int hp,
                           int nf, int hstride, int rstride) {
  const SideView sv = side_view(side_s, n, hp, nf);
  const float* geo = sv.geo;
  const int nw = 4 * nf * hp;
  for (int pair = threadIdx.x; pair < rows * n; pair += blockDim.x) {
    const int qi = pair / n;
    const int kj = pair - qi * n;
    const int iq = r0 + qi;
    const float lwq = geo[2 * n + iq], lhq = geo[3 * n + iq];
    float disp[4];
    disp[0] = logf(fmaxf(fabsf((geo[iq] - geo[kj]) / expf(lwq)), 1e-3f));
    disp[1] = logf(fmaxf(fabsf((geo[n + iq] - geo[n + kj]) / expf(lhq)), 1e-3f));
    disp[2] = lwq - geo[2 * n + kj];
    disp[3] = lhq - geo[3 * n + kj];
    float acc[HB];
#pragma unroll
    for (int hh = 0; hh < HB; ++hh) acc[hh] = 0.f;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
#pragma unroll 4
      for (int f = 0; f < nf; ++f) {
        float sn, cs;
        sincos_reduced(disp[s] * sv.om[f], sn, cs);
        const float* ws = sv.w + (s * nf + f) * hp;
        const float* wc = ws + nw;
        if (VEC) {
#pragma unroll
          for (int h4 = 0; h4 < HB / 4; ++h4) {
            const float4 a = reinterpret_cast<const float4*>(ws)[h4];
            const float4 c = reinterpret_cast<const float4*>(wc)[h4];
            acc[4 * h4] = acc[4 * h4] + a.x * sn + c.x * cs;
            acc[4 * h4 + 1] = acc[4 * h4 + 1] + a.y * sn + c.y * cs;
            acc[4 * h4 + 2] = acc[4 * h4 + 2] + a.z * sn + c.z * cs;
            acc[4 * h4 + 3] = acc[4 * h4 + 3] + a.w * sn + c.w * cs;
          }
        } else {
#pragma unroll
          for (int hh = 0; hh < HB; ++hh) {
            if (hh < H) acc[hh] = acc[hh] + ws[hh] * sn + wc[hh] * cs;
          }
        }
      }
    }
    const float masked = sv.mask[kj];
#pragma unroll
    for (int hh = 0; hh < HB; ++hh) {
      if (hh < H) {
        const float g = fmaxf(fmaxf(acc[hh] + sv.fb[hh], 0.f), 1e-6f);
        bias[hh * hstride + qi * rstride + kj] = logf(g) + masked;
      }
    }
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// =================================================================== MMA
namespace mma {

constexpr int DK = 64;    // the head dim this kernel takes
constexpr int SLAB = 16;  // query rows per slab: one m16 tile
constexpr int MAXKT = 8;  // 16-key tiles: n <= 128

constexpr size_t SMEM_LIMIT = 232448;  // bytes of shared memory a block may use

// Threads per block: 16 warps where the registers allow (n <= 64), so that
// the bias build, which is most of the work, hides its latencies.
template <int KT>
__host__ __device__ constexpr int threads() { return KT == 4 ? 512 : 256; }

// Heads the bias build unrolls and the weights' row: 8 or 16.
__host__ __device__ __forceinline__ int heads_padded(int H) { return H <= 8 ? 8 : 16; }

struct Plan {
  int pitch;  // bf16 elements per staged row of K, V and Q: h * dk, 16 bytes more
  int nkp;    // key rows staged: n rounded up to 16 (zeros past n)
  int nkb;    // floats per bias row: >= n, 8 mod 16 (conflict-free float2 reads)
  int ns;     // slabs of an image
  int sp;     // slabs per phase: 2 where shared memory allows, else 1
};

__host__ __device__ __forceinline__ size_t smem_bytes(const Plan& p, int n, int H, int nf) {
  return sizeof(bf16) * ((size_t)2 * p.nkp + p.sp * SLAB) * p.pitch +
         sizeof(float) * ((size_t)H * p.sp * SLAB * p.nkb + side_floats(n, heads_padded(H), nf));
}

__host__ __device__ __forceinline__ Plan plan(int n, int H, int nf) {
  Plan p;
  p.pitch = H * DK + 8;
  p.nkp = (n + 15) / 16 * 16;
  p.nkb = n + ((8 - n % 16) + 16) % 16;
  p.ns = (n + SLAB - 1) / SLAB;
  p.sp = 2;
  if (smem_bytes(p, n, H, nf) > SMEM_LIMIT) p.sp = 1;
  return p;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
  return fmaxf(x, __shfl_xor_sync(FULL, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  return x + __shfl_xor_sync(FULL, x, 2);
}

// One warp, one head, the slab's 16 query rows against all n keys.
template <int KT, typename OutT>
__device__ __forceinline__ void attend(const bf16* qs, const bf16* ks, const bf16* vs,
                                       const float* bias_h, OutT* out, const Plan& p, int r0,
                                       int n, int H, int head, float scale) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int col = head * DK;
  const int nkt = (n + 15) / 16;

  uint32_t qf[DK / 16][4];
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk) {
    hopper::ldmatrix_x4(qf[kk], qs + (lane & 15) * p.pitch + col + kk * 16 + (lane >> 4) * 8);
  }

  // S = Q K^T: 16 rows x 16 KT keys
  float s[2 * KT][4];
#pragma unroll
  for (int t = 0; t < 2 * KT; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
  }
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    if (kt < nkt) {
      const bf16* kr = ks + (kt * 16 + (lane & 7) + (lane >> 4) * 8) * p.pitch + col +
                       ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk) {
        uint32_t kb[4];
        hopper::ldmatrix_x4(kb, kr + kk * 16);
        hopper::mma_bf16(s[2 * kt], qf[kk], kb[0], kb[1]);
        hopper::mma_bf16(s[2 * kt + 1], qf[kk], kb[2], kb[3]);
      }
    }
  }

  // scale and bias, keys past n excluded; the full-row softmax
  float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
  for (int t = 0; t < 2 * KT; ++t) {
    const int key = 8 * t + 2 * c;
    if (key < n) {
      const float2 b0 = *reinterpret_cast<const float2*>(bias_h + g * p.nkb + key);
      const float2 b1 = *reinterpret_cast<const float2*>(bias_h + (g + 8) * p.nkb + key);
      s[t][0] = s[t][0] * scale + b0.x;
      s[t][2] = s[t][2] * scale + b1.x;
      s[t][1] = key + 1 < n ? s[t][1] * scale + b0.y : -CUDART_INF_F;
      s[t][3] = key + 1 < n ? s[t][3] * scale + b1.y : -CUDART_INF_F;
    } else {
      s[t][0] = s[t][1] = s[t][2] = s[t][3] = -CUDART_INF_F;
    }
    mx0 = fmaxf(mx0, fmaxf(s[t][0], s[t][1]));
    mx1 = fmaxf(mx1, fmaxf(s[t][2], s[t][3]));
  }
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int t = 0; t < 2 * KT; ++t) {
    s[t][0] = expf(s[t][0] - mx0);
    s[t][1] = expf(s[t][1] - mx0);
    s[t][2] = expf(s[t][2] - mx1);
    s[t][3] = expf(s[t][3] - mx1);
    l0 += s[t][0] + s[t][1];
    l1 += s[t][2] + s[t][3];
  }
  // one reciprocal per row: 32 divisions, each with its slow-path branch,
  // would keep the compiler from overlapping them
  const float i0 = 1.f / quad_sum(l0), i1 = 1.f / quad_sum(l1);

  // p rounded to bf16, as the A fragments of P V
  uint32_t pf[KT][4];
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    pf[kt][0] = hopper::pack_bf16(s[2 * kt][0] * i0, s[2 * kt][1] * i0);
    pf[kt][1] = hopper::pack_bf16(s[2 * kt][2] * i1, s[2 * kt][3] * i1);
    pf[kt][2] = hopper::pack_bf16(s[2 * kt + 1][0] * i0, s[2 * kt + 1][1] * i0);
    pf[kt][3] = hopper::pack_bf16(s[2 * kt + 1][2] * i1, s[2 * kt + 1][3] * i1);
  }

  // O = P V: 16 rows x 64 dims
  float o[DK / 8][4];
#pragma unroll
  for (int t = 0; t < DK / 8; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[t][e] = 0.f;
  }
  const int mtx = lane >> 3;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    if (kt < nkt) {
      const bf16* vr = vs + (kt * 16 + (mtx & 1) * 8 + (lane & 7)) * p.pitch + col +
                       (mtx >> 1) * 8;
#pragma unroll
      for (int np = 0; np < DK / 16; ++np) {
        uint32_t vb[4];
        hopper::ldmatrix_x4_trans(vb, vr + np * 16);
        hopper::mma_bf16(o[2 * np], pf[kt], vb[0], vb[1]);
        hopper::mma_bf16(o[2 * np + 1], pf[kt], vb[2], vb[3]);
      }
    }
  }

  const int ra = r0 + g, rb = ra + 8;
  OutT* oa = out + ((long long)ra * H + head) * DK + 2 * c;
  OutT* ob = out + ((long long)rb * H + head) * DK + 2 * c;
#pragma unroll
  for (int t = 0; t < DK / 8; ++t) {
    if (ra < n) store2(oa + 8 * t, o[t][0], o[t][1]);
    if (rb < n) store2(ob + 8 * t, o[t][2], o[t][3]);
  }
}

// Grid (G), each block persistent over a contiguous share of the bs * ns
// slabs of all images, in phases of up to sp slabs of one image; an
// image's K and V are staged when its first slab comes.  KT: 16-key tiles
// the registers hold (n <= 16 KT); HB: heads the bias build unrolls
// (H <= HB).
template <int KT, int HB, typename OutT>
__global__ void __launch_bounds__(threads<KT>())
geo_attention_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, Side side, OutT* __restrict__ out, int bs, int n,
                  int H, int nf, float scale) {
  constexpr int NT = threads<KT>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Plan p = plan(n, H, nf);
  const int rows_p = p.sp * SLAB;                   // query rows of a phase
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);     // nkp x pitch
  bf16* vs = ks + p.nkp * p.pitch;                  // nkp x pitch
  bf16* qs = vs + p.nkp * p.pitch;                  // rows_p x pitch
  float* bias_s = reinterpret_cast<float*>(qs + rows_p * p.pitch);  // H x rows_p x nkb
  float* side_s = bias_s + H * rows_p * p.nkb;

  const int warp = threadIdx.x >> 5;
  const int row = H * DK;         // elements per box of q, k, v
  const int chunks = row / 8;     // 16-byte chunks per box
  const long long total = (long long)bs * p.ns;
  const long long end = (blockIdx.x + 1) * total / gridDim.x;
  int staged = -1;                // the image whose K and V are in shared memory

  for (long long sl = blockIdx.x * total / gridDim.x; sl < end;) {
    const int b = (int)(sl / p.ns);
    const int first = (int)(sl - (long long)b * p.ns);
    const int count = (int)min((long long)min(p.sp, p.ns - first), end - sl);
    const int r0 = first * SLAB;
    const long long img = (long long)b * n * row;
    __syncthreads();  // the last phase's K, V, Q and bias are consumed
    if (b != staged) {  // K and V of every head; rows past n zeroed
      for (int e = threadIdx.x; e < p.nkp * chunks; e += NT) {
        const int r = e / chunks;
        const int cc = (e - r * chunks) * 8;
        bf16* kt = ks + r * p.pitch + cc;
        bf16* vt = vs + r * p.pitch + cc;
        if (r < n) {
          hopper::cp_async16(kt, k + img + (long long)r * row + cc);
          hopper::cp_async16(vt, v + img + (long long)r * row + cc);
        } else {
          *reinterpret_cast<uint4*>(kt) = make_uint4(0u, 0u, 0u, 0u);
          *reinterpret_cast<uint4*>(vt) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
      load_side(side, side_s, b, n, H, HB, nf);
      staged = b;
      __syncthreads();
    }
    for (int e = threadIdx.x; e < count * SLAB * chunks; e += NT) {
      const int r = e / chunks;
      const int cc = (e - r * chunks) * 8;
      bf16* qt = qs + r * p.pitch + cc;
      if (r0 + r < n) {
        hopper::cp_async16(qt, q + img + (long long)(r0 + r) * row + cc);
      } else {
        *reinterpret_cast<uint4*>(qt) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    hopper::cp_async_commit();
    if (OPENVIIC_GEO_SKIP != 1) {
      build_bias<HB, true>(side_s, bias_s, r0, min(count * SLAB, n - r0), n, H, HB, nf,
                           rows_p * p.nkb, p.nkb);
    }
    hopper::cp_async_wait<0>();
    __syncthreads();
    for (int u = warp; u < (OPENVIIC_GEO_SKIP == 2 ? 0 : count * H); u += NT / 32) {
      const int slab = u / H;
      const int head = u - slab * H;
      attend<KT>(qs + slab * SLAB * p.pitch, ks, vs,
                 bias_s + (head * rows_p + slab * SLAB) * p.nkb, out + img, p,
                 r0 + slab * SLAB, n, H, head, scale);
    }
    sl += count;
  }
}

// Streaming multiprocessors of the current device (cached per device).
inline int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0) {
    int c = 0;
    cudaDeviceGetAttribute(&c, cudaDevAttrMultiProcessorCount, dev);
    counts[dev] = c > 0 ? c : 132;
  }
  return counts[dev];
}

template <int KT, int HB, typename OutT>
cudaError_t launch(const void* q, const void* k, const void* v, const Side& side, void* out,
                   int bs, int n, int H, int nf, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(plan(n, H, nf), n, H, nf);
  cudaError_t err = cudaFuncSetAttribute(geo_attention_mma<KT, HB, OutT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // one block per SM (the shared memory allows no more), none without a slab
  const long long total = (long long)bs * plan(n, H, nf).ns;
  const int grid = (int)(total < sm_count() ? total : sm_count());
  geo_attention_mma<KT, HB, OutT><<<grid, threads<KT>(), smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      side, static_cast<OutT*>(out), bs, n, H, nf, scale);
  return cudaGetLastError();
}

// How the kernel for n and H runs on the current card: out = {CTAs per SM,
// threads per CTA, registers per thread, local (spill) bytes per thread,
// shared bytes per CTA, slabs per phase, grid (blocks) at bs images}.
template <int KT, int HB>
int occupancy_of(int bs, int n, int H, int nf, int* out) {
  const Plan p = plan(n, H, nf);
  const size_t smem = smem_bytes(p, n, H, nf);
  auto kernel = geo_attention_mma<KT, HB, bf16>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  int per_sm = 0;
  cudaFuncAttributes attr;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads<KT>(), smem);
  }
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)bs * p.ns;
  out[0] = per_sm;
  out[1] = threads<KT>();
  out[2] = attr.numRegs;
  out[3] = (int)attr.localSizeBytes;
  out[4] = (int)smem;
  out[5] = p.sp;
  out[6] = (int)(total < sm_count() ? total : sm_count());
  return 0;
}

template <typename OutT>
cudaError_t dispatch(const void* q, const void* k, const void* v, const Side& side, void* out,
                     int bs, int n, int H, int nf, float scale, cudaStream_t stream) {
  const bool h8 = heads_padded(H) == 8;
  if (n <= 64) {
    return h8 ? launch<4, 8, OutT>(q, k, v, side, out, bs, n, H, nf, scale, stream)
              : launch<4, 16, OutT>(q, k, v, side, out, bs, n, H, nf, scale, stream);
  }
  return h8 ? launch<MAXKT, 8, OutT>(q, k, v, side, out, bs, n, H, nf, scale, stream)
            : launch<MAXKT, 16, OutT>(q, k, v, side, out, bs, n, H, nf, scale, stream);
}

}  // namespace mma

// ================================================================== SIMT
namespace simt {

constexpr int TQ = 8;  // queries per block: one softmax warp each
constexpr int THREADS = 256;
static_assert(THREADS == 32 * TQ, "one warp per query row");

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16_rn(x); }

size_t smem_bytes(int n, int H, int dk, int nf) {
  return sizeof(float) * ((size_t)H * TQ * n + (size_t)n * (dk + 1) + (size_t)n * dk + TQ * dk +
                          TQ * n + side_floats(n, H, nf));
}

// Grid (bs, ceil(n / TQ)).
template <typename OutT>
__global__ void __launch_bounds__(THREADS)
geo_attention_simt(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, Side side, OutT* __restrict__ out, int n, int H,
                   int dk, int nf, float scale) {
  extern __shared__ float smem[];
  const int KP = dk + 1;               // pitch of the k tile
  float* bias_s = smem;                // H x TQ x n
  float* ks = bias_s + H * TQ * n;     // n x KP
  float* vs = ks + n * KP;             // n x dk
  float* qs = vs + n * dk;             // TQ x dk
  float* ps = qs + TQ * dk;            // TQ x n: scores, then probabilities
  float* side_s = ps + TQ * n;

  const int b = blockIdx.x;
  const int q0 = blockIdx.y * TQ;
  const int tid = threadIdx.x;
  load_side(side, side_s, b, n, H, H, nf);
  __syncthreads();
  build_bias<MAXH, false>(side_s, bias_s, q0, min(TQ, n - q0), n, H, H, nf, TQ * n, n);

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
      if (q0 + qi >= n) continue;
      float dot = 0.f;
      for (int c = 0; c < dk; ++c) dot = fmaf(qs[qi * dk + c], ks[kj * KP + c], dot);
      ps[qi * n + kj] = dot * scale + bias_s[(hh * TQ + qi) * n + kj];
    }
    __syncthreads();

    // full-row softmax, one warp per query row; probabilities round to bf16
    if (q0 + warp < n) {
      float* prow = ps + warp * n;
      float mx = -CUDART_INF_F;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, prow[j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
      float sum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float e = expf(prow[j] - mx);
        prow[j] = e;
        sum += e;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
      __syncwarp();
      for (int j = lane; j < n; j += 32) {
        prow[j] = __bfloat162float(__float2bfloat16_rn(prow[j] / sum));
      }
    }
    __syncthreads();

    for (int i = tid; i < TQ * dk; i += THREADS) {
      const int r = i / dk;
      const int c = i - r * dk;
      if (q0 + r >= n) continue;
      const float* pr = ps + r * n;
      float o = 0.f;
      for (int j = 0; j < n; ++j) o = fmaf(pr[j], vs[j * dk + c], o);
      store(out + head_off + (long long)(q0 + r) * H * dk + c, o);
    }
  }
}

template <typename OutT>
cudaError_t launch(const void* q, const void* k, const void* v, const Side& side, void* out,
                   int bs, int n, int H, int dk, int nf, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(n, H, dk, nf);
  cudaError_t err = cudaFuncSetAttribute(geo_attention_simt<OutT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bs, (n + TQ - 1) / TQ);
  geo_attention_simt<OutT><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      side, static_cast<OutT*>(out), n, H, dk, nf, scale);
  return cudaGetLastError();
}

}  // namespace simt

}  // namespace

extern "C" {

// Largest number of heads the kernels take.
int openviic_geo_attention_max_heads(void) { return MAXH; }

// mma::occupancy_of for the MMA kernel at bs, n, H and nf (n <= 128);
// returns a CUDA error code.
int openviic_geo_attention_occupancy(int bs, int n, int H, int nf, int* out) {
  const bool h8 = mma::heads_padded(H) == 8;
  if (n <= 64) {
    return h8 ? mma::occupancy_of<4, 8>(bs, n, H, nf, out)
              : mma::occupancy_of<4, 16>(bs, n, H, nf, out);
  }
  return h8 ? mma::occupancy_of<mma::MAXKT, 8>(bs, n, H, nf, out)
            : mma::occupancy_of<mma::MAXKT, 16>(bs, n, H, nf, out);
}

// Launch on `stream`; returns cudaGetLastError().  route 1: the MMA kernel
// (dk = 64, n <= 128), route 0: the SIMT kernel.  The caller guarantees
// contiguous bf16 q, k, v (16-byte aligned for the MMA kernel) of the
// shapes above, contiguous boxes (box_code: 0 f32, 1 bf16, 2 f16) and
// mask bytes, fc_g and its bias at the strides given (w_code, fb_code),
// 1 <= H <= 16, bs < 2^31, n / 8 < 65536, a shared-memory need within one
// block's, and out_bf16 = 1 for a bf16 output, 0 for f32.
int openviic_geo_attention(const void* q, const void* k, const void* v, const void* boxes,
                           int box_code, const void* mask, const void* w, long long w_s0,
                           long long w_s1, int w_code, const void* fbias, long long fb_s,
                           int fb_code, const void* omega, void* out, int bs, int n, int H,
                           int dk, int nf, float scale, int out_bf16, int route, void* stream) {
  Side side;
  side.boxes = boxes;
  side.mask = static_cast<const uint8_t*>(mask);
  side.w = w;
  side.fbias = fbias;
  side.omega = static_cast<const float*>(omega);
  side.w_s0 = w_s0;
  side.w_s1 = w_s1;
  side.fb_s = fb_s;
  side.box_code = box_code;
  side.w_code = w_code;
  side.fb_code = fb_code;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    return out_bf16 ? mma::dispatch<bf16>(q, k, v, side, out, bs, n, H, nf, scale, st)
                    : mma::dispatch<float>(q, k, v, side, out, bs, n, H, nf, scale, st);
  }
  return out_bf16 ? simt::launch<bf16>(q, k, v, side, out, bs, n, H, dk, nf, scale, st)
                  : simt::launch<float>(q, k, v, side, out, bs, n, H, dk, nf, scale, st);
}

}  // extern "C"
