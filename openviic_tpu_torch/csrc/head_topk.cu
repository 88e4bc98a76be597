// Fused vocab head + logsumexp + per-row exact top-k for Hopper (sm_90a).
//
// Replaces the Pallas kernel openviic_tpu/ops/head_topk.py::head_topk.  For
// x (N, D) bf16 and the head w (V, D) bf16 (one contiguous row per vocab id,
// the layout of a torch Linear weight) it computes, per row of x:
//   logits = round_to_bf16(x @ w^T)          (f32 accumulation, then bf16)
//   lse    = logsumexp(logits)               (f32)
//   top-k  = the k largest logits and their ids, ordered by value, ties to
//            the lowest id
// without writing the (N, V) logits to device memory.
//
// What bounds it on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s): at the
// flagship decode step (N = 320 images x 5 beams = 1600, D = 512,
// V = 10 000) the work is 2*N*D*V = 16.4 GFLOP against ~11.9 MB of reads
// (w 10.24 MB, x 1.64 MB): 1400 FLOP/byte, above the card's ~295 FLOP/byte
// ridge, so the floor is the tensor-core rate, ~17 us, not the ~3.6 us of
// memory traffic.
//
// Design (simple first, fast later): the matrix product runs on the tensor
// cores through WMMA 16x16x16 bf16 fragments.  A block owns BM rows of x and
// one contiguous split of the vocab tiles; it stages BK-deep slices of x and
// w in shared memory, keeps the BM x BN f32 tile in shared memory, and folds
// each tile into per-row running (max, sum-exp) and a per-thread sorted top-k
// held in registers.  Splitting the vocab across blocks fills the 132 SMs at
// decode batch sizes; a second small kernel merges the splits' partial
// (max, sum-exp, top-k) per row.  wgmma, TMA and a pipelined ring of tiles
// are left for a later change.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math_constants.h>

#include <climits>

namespace {

using namespace nvcuda;

constexpr int BM = 64;       // rows of x per block
constexpr int BN = 64;       // vocab columns per tile
constexpr int BK = 64;       // depth of one shared-memory stage
constexpr int LDS = BK + 8;  // bf16 pitch of the staged tiles (keeps 32-byte
                             // fragment alignment, shifts banks per row)
constexpr int LDC = BN + 4;  // f32 pitch of the accumulator tile
constexpr int THREADS = 128; // 4 warps; warp w computes rows 16w..16w+15
constexpr int VEC = 8;       // bf16 per 16-byte load

static_assert(BM == 16 * (THREADS / 32), "one 16-row strip per warp");
static_assert(2 * BM == THREADS, "two epilogue threads per row");

__device__ __forceinline__ bool better(float v1, int i1, float v2, int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

// Insert (v, i) into a list sorted by (value desc, id asc); fully unrolled so
// the list stays in registers.
template <int KM>
__device__ __forceinline__ void insert(float (&tv)[KM], int (&ti)[KM], float v, int i) {
  if (!better(v, i, tv[KM - 1], ti[KM - 1])) return;
  tv[KM - 1] = v;
  ti[KM - 1] = i;
#pragma unroll
  for (int j = KM - 1; j > 0; --j) {
    if (better(tv[j], ti[j], tv[j - 1], ti[j - 1])) {
      const float fv = tv[j]; tv[j] = tv[j - 1]; tv[j - 1] = fv;
      const int fi = ti[j]; ti[j] = ti[j - 1]; ti[j - 1] = fi;
    }
  }
}

// Stage rows [r0, r0 + BM) x depth [k0, k0 + BK) of a (rows, D) bf16 matrix
// into shared memory, zero-filling outside the matrix.  D % 8 == 0 and a
// 16-byte aligned base are checked by the host wrapper.
__device__ __forceinline__ void stage(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                      int r0, int rows, int k0, int D) {
  for (int c = threadIdx.x; c < BM * (BK / VEC); c += THREADS) {
    const int r = c / (BK / VEC);
    const int kk = (c % (BK / VEC)) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < rows && k0 + kk < D) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * D + k0 + kk);
    }
    *reinterpret_cast<uint4*>(dst + r * LDS + kk) = val;
  }
}

// Grid (ceil(N / BM), S).  Block (bx, s) covers rows [bx*BM, bx*BM + BM) and
// vocab tiles [s*tiles_per_split, (s+1)*tiles_per_split).  It writes, per
// row, the split's max, sum of exp(logit - max) and top-k to the partials
// (row-major (N, S[, k])).
template <int KM>
__global__ void __launch_bounds__(THREADS)
head_topk_partial(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                  float* __restrict__ part_val, int* __restrict__ part_idx,
                  float* __restrict__ part_max, float* __restrict__ part_sum,
                  int N, int D, int V, int k, int tiles_per_split, int S) {
  __shared__ __align__(128) __nv_bfloat16 xs[BM * LDS];
  __shared__ __align__(128) __nv_bfloat16 ws[BN * LDS];
  __shared__ __align__(128) float cs[BM * LDC];

  const int row0 = blockIdx.x * BM;
  const int split = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int n_tiles = (V + BN - 1) / BN;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);

  // epilogue ownership: row er, columns of parity eh of each tile
  const int er = threadIdx.x >> 1;
  const int eh = threadIdx.x & 1;
  float tv[KM];
  int ti[KM];
#pragma unroll
  for (int j = 0; j < KM; ++j) { tv[j] = -CUDART_INF_F; ti[j] = INT_MAX; }
  float run_max = -CUDART_INF_F;
  float run_sum = 0.f;

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int col0 = tile * BN;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BN / 16];
#pragma unroll
    for (int f = 0; f < BN / 16; ++f) wmma::fill_fragment(acc[f], 0.f);

    for (int k0 = 0; k0 < D; k0 += BK) {
      stage(xs, x, row0, N, k0, D);
      stage(ws, w, col0, V, k0, D);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::load_matrix_sync(a, xs + warp * 16 * LDS + kk, LDS);
#pragma unroll
        for (int f = 0; f < BN / 16; ++f) {
          // w staged as (BN, BK) row-major is w^T (BK, BN) column-major
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
          wmma::load_matrix_sync(b, ws + f * 16 * LDS + kk, LDS);
          wmma::mma_sync(acc[f], a, b, acc[f]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int f = 0; f < BN / 16; ++f) {
      wmma::store_matrix_sync(cs + warp * 16 * LDC + f * 16, acc[f], LDC, wmma::mem_row_major);
    }
    __syncthreads();

    // fold this tile's half-row into the thread's running state
    float vals[BN / 2];
    float cmax = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) {
      const int col = 2 * j + eh;
      // round through bf16, as the JAX path materialises the head in bf16
      float v = __bfloat162float(__float2bfloat16_rn(cs[er * LDC + col]));
      v = (col0 + col < V) ? v : -CUDART_INF_F;
      vals[j] = v;
      cmax = fmaxf(cmax, v);
    }
    if (cmax > -CUDART_INF_F) {
      const float nm = fmaxf(run_max, cmax);
      float s = run_sum * expf(run_max - nm);  // run_max = -inf gives 0 * 0
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) s += expf(vals[j] - nm);
      run_max = nm;
      run_sum = s;
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) {
        if (vals[j] > -CUDART_INF_F) insert<KM>(tv, ti, vals[j], col0 + 2 * j + eh);
      }
    }
    __syncthreads();  // cs is rewritten by the next tile
  }

  // merge the two threads of each row (adjacent lanes of one warp)
  const float om = __shfl_xor_sync(0xffffffffu, run_max, 1);
  const float os = __shfl_xor_sync(0xffffffffu, run_sum, 1);
  float ov[KM];
  int oi[KM];
#pragma unroll
  for (int j = 0; j < KM; ++j) {
    ov[j] = __shfl_xor_sync(0xffffffffu, tv[j], 1);
    oi[j] = __shfl_xor_sync(0xffffffffu, ti[j], 1);
  }
  const int row = row0 + er;
  if (eh == 0 && row < N) {
    const float nm = fmaxf(run_max, om);
    float ns = 0.f;
    if (run_max > -CUDART_INF_F) ns += run_sum * expf(run_max - nm);
    if (om > -CUDART_INF_F) ns += os * expf(om - nm);
#pragma unroll
    for (int j = 0; j < KM; ++j) {
      if (ov[j] > -CUDART_INF_F) insert<KM>(tv, ti, ov[j], oi[j]);
    }
    const size_t base = (size_t)row * S + split;
    part_max[base] = nm;
    part_sum[base] = ns;
#pragma unroll
    for (int j = 0; j < KM; ++j) {
      if (j < k) {
        part_val[base * k + j] = tv[j];
        part_idx[base * k + j] = ti[j];
      }
    }
  }
}

// One thread per row: merge the S partial (max, sum-exp, top-k) of the row.
template <int KM>
__global__ void __launch_bounds__(THREADS)
head_topk_merge(const float* __restrict__ part_val, const int* __restrict__ part_idx,
                const float* __restrict__ part_max, const float* __restrict__ part_sum,
                float* __restrict__ vals, int* __restrict__ idxs, float* __restrict__ lse,
                int N, int k, int S) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  float tv[KM];
  int ti[KM];
#pragma unroll
  for (int j = 0; j < KM; ++j) { tv[j] = -CUDART_INF_F; ti[j] = INT_MAX; }
  float m = -CUDART_INF_F;
  for (int s = 0; s < S; ++s) m = fmaxf(m, part_max[(size_t)row * S + s]);
  float sum = 0.f;
  for (int s = 0; s < S; ++s) {
    const size_t base = (size_t)row * S + s;
    const float pm = part_max[base];
    if (pm > -CUDART_INF_F) sum += part_sum[base] * expf(pm - m);
#pragma unroll
    for (int j = 0; j < KM; ++j) {
      if (j < k) insert<KM>(tv, ti, part_val[base * k + j], part_idx[base * k + j]);
    }
  }
  lse[row] = m + logf(sum);
#pragma unroll
  for (int j = 0; j < KM; ++j) {
    if (j < k) {
      vals[(size_t)row * k + j] = tv[j];
      idxs[(size_t)row * k + j] = ti[j];
    }
  }
}

template <int KM>
cudaError_t launch(const void* x, const void* w, void* part_val, void* part_idx,
                   void* part_max, void* part_sum, void* vals, void* idxs, void* lse,
                   int N, int D, int V, int k, int tiles_per_split, int S,
                   cudaStream_t stream) {
  const dim3 grid((N + BM - 1) / BM, S);
  head_topk_partial<KM><<<grid, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<float*>(part_val), static_cast<int*>(part_idx),
      static_cast<float*>(part_max), static_cast<float*>(part_sum),
      N, D, V, k, tiles_per_split, S);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  head_topk_merge<KM><<<(N + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      static_cast<const float*>(part_val), static_cast<const int*>(part_idx),
      static_cast<const float*>(part_max), static_cast<const float*>(part_sum),
      static_cast<float*>(vals), static_cast<int*>(idxs), static_cast<float*>(lse),
      N, k, S);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows of x per block, and vocab columns per tile (the unit in which the
// host splits the vocab).
int openviic_head_topk_tile_rows(void) { return BM; }
int openviic_head_topk_tile_cols(void) { return BN; }

// Largest k the kernel takes.
int openviic_head_topk_max_k(void) { return 16; }

// Launch both kernels on `stream`; returns cudaGetLastError() after them.
// Scratch: part_val (N, S, k) f32, part_idx (N, S, k) i32, part_max and
// part_sum (N, S) f32.  Outputs: vals (N, k) f32, idxs (N, k) i32, lse (N,)
// f32.  The caller guarantees 1 <= k <= min(16, V), D % 8 == 0, 16-byte
// aligned x and w, and S * tiles_per_split >= ceil(V / BN) with every split
// non-empty.
int openviic_head_topk(const void* x, const void* w, void* part_val, void* part_idx,
                       void* part_max, void* part_sum, void* vals, void* idxs, void* lse,
                       int N, int D, int V, int k, int tiles_per_split, int S,
                       void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k <= 8) {
    return launch<8>(x, w, part_val, part_idx, part_max, part_sum, vals, idxs, lse,
                     N, D, V, k, tiles_per_split, S, st);
  }
  return launch<16>(x, w, part_val, part_idx, part_max, part_sum, vals, idxs, lse,
                    N, D, V, k, tiles_per_split, S, st);
}

}  // extern "C"
