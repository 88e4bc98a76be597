// Beam-resident self-attention of one decode step, for Hopper (sm_90a).
//
// Replaces the Pallas kernel
// openviic_tpu/ops/beam_select_attention.py::beam_select_attention.  For
// q (N, h, dk) (rows `q_stride` elements apart), the append-only caches
// k (N, L, h, dk) and v (N, L, h, dv) (N = bs * beam rows, never reordered),
// the ancestry (N, L) (the slot, within the row's image, of position l of the
// row's prefix) and the mask (N, L) (1 = masked; read at the row itself, or
// at the ancestor's row when the mask is the raw per-slot one), it computes
// per row and head
//   s_l   = (q . k[src_l, l]) * scale, or -1e30 where position l is masked
//   out   = sum_l softmax(s)_l * v[src_l, l]          (f32, then bf16)
// with src_l = (n / beam) * beam + ancestry[n, l].
//
// What bounds it on an H100 SXM (3.35 TB/s; the arithmetic is ~2 FLOP per
// byte read): the bytes.  At the flagship decode step (N = 1600, L = 25,
// h = 8, dk = dv = 64, bf16) a full cache is 2 x 41 MB, about 25 us at
// 3.35 TB/s; at step t only the t + 1 live positions of each prefix are read.
// Its first design was latency-bound instead: one warp walked the
// positions one after another, each an ancestry load, a mask load and a
// K row load in a dependent chain.
//
// Design (the fast kernel): one block per image, one warp per beam row,
// covering every head: a row's K (and V) at one position is h * dk = 512
// contiguous bf16, two 16-byte loads per lane, so lane l holds 16 elements
// of head l / 4 (at dk = 64) of every K, V, q and output row.  The warp
// loads its row's ancestry and mask once, coalesced (lane j: position j,
// in chunks of 32); a ballot gives the live positions, taken in order in
// batches of 4, every K and V row of a batch loaded before any
// arithmetic, each one's cache row from the lane that loaded its ancestry.
// A position's dot is summed over the head's 4 lanes (two shuffles); the
// scores stay in registers, the batch max and the softmax's denominator
// are kept online, PV accumulates in f32 in the lanes that hold the output,
// so nothing is reduced across lanes at the end.  The beam rows of an
// image share ancestors, and so read the same K and V rows, on one SM.
// Masked positions are neither loaded nor summed: their weight is exactly 0
// whenever one position of the row is live.  A row with no live position is
// uniform over all L positions, as the additive -1e30 mask gives: then
// every position is read, with equal scores.  Shapes the fast kernel does
// not take (h * dk other than 256, 512 or 1024, dk != dv, pointers off
// 16-byte alignment) run the general kernel: one block per row, one warp
// per head, the positions in sequence.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void unpack8(const uint4& raw, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(p[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// ================================================================== fast
namespace fast {

constexpr int MAX_WARPS = 16;  // warps per block; beam rows past it wrap

// Fetch position j0 + lane of row n: its cache row (of the whole cache)
// and whether it is masked; lanes past L see a masked position.
__device__ __forceinline__ bool load_position(const int64_t* __restrict__ anc,
                                              const uint8_t* __restrict__ pmask, int n, int base,
                                              int j, int L, int mask_on_slot, int& src) {
  if (j >= L) {
    src = base;
    return true;
  }
  src = base + (int)anc[(size_t)n * L + j];
  return pmask[(size_t)(mask_on_slot ? src : n) * L + j] != 0;
}

// Grid (bs), block (32 * min(beam, MAX_WARPS)): warp w takes the image's
// beam rows w, w + MAX_WARPS, ...  A row's heads span W = h * dk = 256 CK
// elements; lane l holds elements [8 CK l, 8 CK l + 8 CK) of every K, V, q
// and output row, so that its head's dot is summed over dk / (8 CK) lanes
// (`lph`, a power of two).  A batch of 8 / CK positions is 64 registers of
// K and V loads per lane.
template <int CK>
__global__ void __launch_bounds__(32 * MAX_WARPS)
beam_select_fast(const __nv_bfloat16* __restrict__ q, long long q_stride,
       const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
       const int64_t* __restrict__ anc, const uint8_t* __restrict__ pmask,
       __nv_bfloat16* __restrict__ out, int L, int dk, int beam, int mask_on_slot,
       float scale) {
  constexpr int E = 8 * CK;  // elements per lane
  constexpr int P = 8 / CK;  // positions per batch
  const int W = 32 * E;
  const int lane = threadIdx.x & 31;
  const int lph = dk / E;
  const int base = blockIdx.x * beam;

  for (int r = threadIdx.x >> 5; r < beam; r += blockDim.x >> 5) {
    const int n = base + r;
    const int e0 = lane * E;
    // q stays packed until the first batch's K and V loads are issued
    uint4 qraw[CK];
#pragma unroll
    for (int c = 0; c < CK; ++c) {
      qraw[c] = __ldg(reinterpret_cast<const uint4*>(q + n * q_stride + e0 + 8 * c));
    }

    // the row's first 32 positions, one per lane; a row with no live
    // position at all is uniform over every position (equal scores)
    int src;
    bool dead = load_position(anc, pmask, n, base, lane, L, mask_on_slot, src);
    bool uniform = __ballot_sync(FULL, !dead) == 0u;
    for (int j0 = 32; uniform && j0 < L; j0 += 32) {
      int other;
      uniform = __ballot_sync(FULL, !load_position(anc, pmask, n, base, j0 + lane, L,
                                                   mask_on_slot, other)) == 0u;
    }

    float acc[E];
#pragma unroll
    for (int i = 0; i < E; ++i) acc[i] = 0.f;
    float m = -CUDART_INF_F, den = 0.f;
    for (int j0 = 0; j0 < L; j0 += 32) {
      if (j0 > 0) dead = load_position(anc, pmask, n, base, j0 + lane, L, mask_on_slot, src);
      unsigned sel = __ballot_sync(FULL, j0 + lane < L && (uniform || !dead));
      while (sel != 0u) {  // batches of P positions, in order
        int p[P];
        uint4 kr[P][CK], vr[P][CK];
#pragma unroll
        for (int i = 0; i < P; ++i) {
          p[i] = sel != 0u ? __ffs(sel) - 1 : -1;
          sel &= sel - 1u;
          const int row = __shfl_sync(FULL, src, p[i] < 0 ? 0 : p[i]);
          const size_t cell = ((size_t)row * L + j0 + (p[i] < 0 ? 0 : p[i])) * W + e0;
#pragma unroll
          for (int c = 0; c < CK; ++c) {
            const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
            kr[i][c] = p[i] < 0 ? zero : __ldg(reinterpret_cast<const uint4*>(k + cell + 8 * c));
            vr[i][c] = p[i] < 0 ? zero : __ldg(reinterpret_cast<const uint4*>(v + cell + 8 * c));
          }
        }
        // scores: the lane's products in sequence, then its head's lanes
        float s[P];
#pragma unroll
        for (int i = 0; i < P; ++i) {
          float d = 0.f;
#pragma unroll
          for (int c = 0; c < CK; ++c) {
            float kf[8], qf[8];
            unpack8(kr[i][c], kf);
            unpack8(qraw[c], qf);
#pragma unroll
            for (int e = 0; e < 8; ++e) d = fmaf(kf[e], qf[e], d);
          }
          for (int o = 1; o < lph; o <<= 1) d += __shfl_xor_sync(FULL, d, o);
          s[i] = p[i] < 0 ? -CUDART_INF_F : (uniform ? 0.f : d * scale);
        }
        // the online softmax: the batch's max, the rescale, then PV
        float mb = s[0];
#pragma unroll
        for (int i = 1; i < P; ++i) mb = fmaxf(mb, s[i]);
        const float mn = fmaxf(m, mb);
        const float alpha = expf(m - mn);
        m = mn;
        float e[P], es = 0.f;
#pragma unroll
        for (int i = 0; i < P; ++i) {
          e[i] = expf(s[i] - m);
          es += e[i];
        }
        den = den * alpha + es;
#pragma unroll
        for (int i = 0; i < E; ++i) acc[i] *= alpha;
#pragma unroll
        for (int i = 0; i < P; ++i) {
#pragma unroll
          for (int c = 0; c < CK; ++c) {
            float vf[8];
            unpack8(vr[i][c], vf);
#pragma unroll
            for (int x = 0; x < 8; ++x) acc[8 * c + x] = fmaf(vf[x], e[i], acc[8 * c + x]);
          }
        }
      }
    }

#pragma unroll
    for (int c = 0; c < CK; ++c) {
      uint4 packed;
      __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        o2[i] = __floats2bfloat162_rn(acc[8 * c + 2 * i] / den, acc[8 * c + 2 * i + 1] / den);
      }
      *reinterpret_cast<uint4*>(out + (size_t)n * W + e0 + 8 * c) = packed;
    }
  }
}

template <int CK>
cudaError_t launch(const void* q, long long q_stride, const void* k, const void* v,
                   const void* anc, const void* pmask, void* out, int N, int L, int dk, int beam,
                   int mask_on_slot, float scale, cudaStream_t stream) {
  const int warps = beam < MAX_WARPS ? beam : MAX_WARPS;
  beam_select_fast<CK><<<N / beam, 32 * warps, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), q_stride, static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int64_t*>(anc),
      static_cast<const uint8_t*>(pmask), static_cast<__nv_bfloat16*>(out), L, dk, beam,
      mask_on_slot, scale);
  return cudaGetLastError();
}

}  // namespace fast

// =============================================================== general
namespace general {

constexpr int MAXC = 8;  // element pairs per lane: head dims up to 2 * 32 * 8 = 512

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Grid (N), block (h * 32): warp `head` of block n.  Dynamic shared memory:
// h * L floats of scores.
__global__ void beam_select_general(const __nv_bfloat16* __restrict__ q, long long q_stride,
                                    const __nv_bfloat16* __restrict__ k,
                                    const __nv_bfloat16* __restrict__ v,
                                    const int64_t* __restrict__ anc,
                                    const uint8_t* __restrict__ pmask,
                                    __nv_bfloat16* __restrict__ out, int L, int h, int dk, int dv,
                                    int beam, int mask_on_slot, float scale) {
  extern __shared__ float scores[];
  const int n = blockIdx.x;
  const int head = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* s = scores + head * L;
  const int base = (n / beam) * beam;
  const size_t krow = (size_t)h * dk;
  const size_t vrow = (size_t)h * dv;

  float qv[MAXC][2];
  const __nv_bfloat16* qp = q + n * q_stride + (size_t)head * dk;
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

cudaError_t launch(const void* q, long long q_stride, const void* k, const void* v,
                   const void* anc, const void* pmask, void* out, int N, int L, int h, int dk,
                   int dv, int beam, int mask_on_slot, float scale, cudaStream_t stream) {
  const size_t smem = (size_t)h * L * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        beam_select_general, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  beam_select_general<<<N, h * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), q_stride, static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int64_t*>(anc),
      static_cast<const uint8_t*>(pmask), static_cast<__nv_bfloat16*>(out), L, h, dk, dv, beam,
      mask_on_slot, scale);
  return cudaGetLastError();
}

}  // namespace general

// How a kernel runs on the current card: out = {CTAs per SM, threads per
// CTA, registers per thread, local (spill) bytes per thread, shared bytes
// per CTA}.
template <typename Kernel>
int occupancy_of(Kernel kernel, int threads, size_t smem, int* out) {
  int per_sm = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = per_sm;
  out[1] = threads;
  out[2] = attr.numRegs;
  out[3] = (int)attr.localSizeBytes;
  out[4] = (int)smem;
  return 0;
}

}  // namespace

extern "C" {

// occupancy_of for the kernel of `route` (as openviic_beam_select_attention
// takes it) at beam, h and L; returns a CUDA error code.
int openviic_beam_select_occupancy(int route, int beam, int h, int L, int* out) {
  const int warps = beam < fast::MAX_WARPS ? beam : fast::MAX_WARPS;
  switch (route) {
    case 1: return occupancy_of(fast::beam_select_fast<1>, 32 * warps, 0, out);
    case 2: return occupancy_of(fast::beam_select_fast<2>, 32 * warps, 0, out);
    case 4: return occupancy_of(fast::beam_select_fast<4>, 32 * warps, 0, out);
    default:
      return occupancy_of(general::beam_select_general, 32 * h, (size_t)h * L * sizeof(float),
                          out);
  }
}


// Launch on `stream`; returns cudaGetLastError().  route: 1, 2 or 4 for
// the fast kernel with h * dk = 256 * route, 0 for the general one.  The
// caller guarantees contiguous k, v, anc and pmask; q rows `q_stride`
// elements apart, each row's heads contiguous; h <= 32, even dk and dv <=
// 512, 4-byte aligned q, k, v; for the fast kernel dk = dv, dk / (8 *
// route) a power of two, q, k, v and q's row stride 16-byte aligned; and
// 0 <= ancestry < beam.
int openviic_beam_select_attention(const void* q, long long q_stride, const void* k,
                                   const void* v, const void* anc, const void* pmask, void* out,
                                   int N, int L, int h, int dk, int dv, int beam,
                                   int mask_on_slot, float scale, int route, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (route) {
    case 1:
      return fast::launch<1>(q, q_stride, k, v, anc, pmask, out, N, L, dk, beam, mask_on_slot,
                             scale, st);
    case 2:
      return fast::launch<2>(q, q_stride, k, v, anc, pmask, out, N, L, dk, beam, mask_on_slot,
                             scale, st);
    case 4:
      return fast::launch<4>(q, q_stride, k, v, anc, pmask, out, N, L, dk, beam, mask_on_slot,
                             scale, st);
    default:
      return general::launch(q, q_stride, k, v, anc, pmask, out, N, L, h, dk, dv, beam,
                             mask_on_slot, scale, st);
  }
}

}  // extern "C"
