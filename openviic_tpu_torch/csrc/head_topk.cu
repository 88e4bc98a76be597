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
//
// k up to 16 keeps each thread's sorted list in registers (RegisterList).
// For 16 < k <= 128, the largest k the JAX kernel returns, a list that long
// would spill, so the same two kernels are instantiated with the lists in
// dynamic shared memory (SharedList: k x 128 entries per block), inserting
// with a loop over the list; that is correct and slower.

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

// A thread's top-k list, sorted by (value desc, id asc).  The kernels below
// are written once against this interface and instantiated for two storages:
//   RegisterList<KM>: KM entries in registers (loops fully unrolled; k <= KM);
//   SharedList: k entries in dynamic shared memory, entry j of thread t at
//     [j * blockDim.x + t] (16 < k <= 128, where registers would spill).
// size() is the list's length; pair_val/pair_idx read entry j of the list of
// the thread in lane ^ 1 (every lane of the warp calls them together; the
// odd lane's result is unused).
template <int KM>
struct RegisterList {
  float v[KM];
  int id[KM];

  __device__ __forceinline__ explicit RegisterList(int /*k*/) {
#pragma unroll
    for (int j = 0; j < KM; ++j) { v[j] = -CUDART_INF_F; id[j] = INT_MAX; }
  }
  __device__ __forceinline__ int size() const { return KM; }
  __device__ __forceinline__ float val(int j) const { return v[j]; }
  __device__ __forceinline__ int idx(int j) const { return id[j]; }
  __device__ __forceinline__ float pair_val(int j) const {
    return __shfl_xor_sync(0xffffffffu, v[j], 1);
  }
  __device__ __forceinline__ int pair_idx(int j) const {
    return __shfl_xor_sync(0xffffffffu, id[j], 1);
  }
  __device__ __forceinline__ void insert(float nv, int ni) {
    if (!better(nv, ni, v[KM - 1], id[KM - 1])) return;
    v[KM - 1] = nv;
    id[KM - 1] = ni;
#pragma unroll
    for (int j = KM - 1; j > 0; --j) {
      if (better(v[j], id[j], v[j - 1], id[j - 1])) {
        const float fv = v[j]; v[j] = v[j - 1]; v[j - 1] = fv;
        const int fi = id[j]; id[j] = id[j - 1]; id[j - 1] = fi;
      }
    }
  }
};

struct SharedList {
  float* v;
  int* id;
  int stride;
  int k;

  __device__ __forceinline__ explicit SharedList(int k_) : stride(blockDim.x), k(k_) {
    extern __shared__ float lists[];  // values, then ids, k x blockDim.x each
    v = lists + threadIdx.x;
    id = reinterpret_cast<int*>(lists + k * blockDim.x) + threadIdx.x;
    for (int j = 0; j < k; ++j) { v[j * stride] = -CUDART_INF_F; id[j * stride] = INT_MAX; }
  }
  __device__ __forceinline__ int size() const { return k; }
  __device__ __forceinline__ float val(int j) const { return v[j * stride]; }
  __device__ __forceinline__ int idx(int j) const { return id[j * stride]; }
  // the odd lane reads nothing: the even lane is rewriting its list
  __device__ __forceinline__ float pair_val(int j) const {
    return (threadIdx.x & 1) ? -CUDART_INF_F : v[j * stride + 1];
  }
  __device__ __forceinline__ int pair_idx(int j) const {
    return (threadIdx.x & 1) ? INT_MAX : id[j * stride + 1];
  }
  __device__ __forceinline__ void insert(float nv, int ni) {
    if (!better(nv, ni, v[(k - 1) * stride], id[(k - 1) * stride])) return;
    int j = k - 1;
    for (; j > 0; --j) {
      const float pv = v[(j - 1) * stride];
      const int pi = id[(j - 1) * stride];
      if (!better(nv, ni, pv, pi)) break;
      v[j * stride] = pv;
      id[j * stride] = pi;
    }
    v[j * stride] = nv;
    id[j * stride] = ni;
  }
};

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

// The f32 logits of rows [row0, row0 + BM) x vocab columns [col0, col0 + BN)
// into cs (BM x LDC), through WMMA 16x16x16 bf16 fragments; warp w computes
// rows 16w..16w+15.  Ends with a barrier, so cs is readable by every thread.
__device__ __forceinline__ void tile_logits(__nv_bfloat16* xs, __nv_bfloat16* ws, float* cs,
                                            const __nv_bfloat16* __restrict__ x,
                                            const __nv_bfloat16* __restrict__ w,
                                            int row0, int col0, int N, int D, int V) {
  const int warp = threadIdx.x / 32;
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
}

// Grid (ceil(N / BM), S).  Block (bx, s) covers rows [bx*BM, bx*BM + BM) and
// vocab tiles [s*tiles_per_split, (s+1)*tiles_per_split).  It writes, per
// row, the split's max, sum of exp(logit - max) and top-k to the partials
// (row-major (N, S[, k])).
template <class List>
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
  const int n_tiles = (V + BN - 1) / BN;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);

  // epilogue ownership: row er, columns of parity eh of each tile
  const int er = threadIdx.x >> 1;
  const int eh = threadIdx.x & 1;
  List list(k);
  float run_max = -CUDART_INF_F;
  float run_sum = 0.f;

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int col0 = tile * BN;
    tile_logits(xs, ws, cs, x, w, row0, col0, N, D, V);

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
        if (vals[j] > -CUDART_INF_F) list.insert(vals[j], col0 + 2 * j + eh);
      }
    }
    __syncthreads();  // cs is rewritten by the next tile
  }

  // the row's even thread folds in the odd thread's state and list (adjacent
  // lanes of one warp)
  const float om = __shfl_xor_sync(0xffffffffu, run_max, 1);
  const float os = __shfl_xor_sync(0xffffffffu, run_sum, 1);
  const int row = row0 + er;
  const bool owner = eh == 0 && row < N;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < list.size(); ++j) {
    const float ov = list.pair_val(j);
    const int oi = list.pair_idx(j);
    if (owner && ov > -CUDART_INF_F) list.insert(ov, oi);
  }
  if (owner) {
    const float nm = fmaxf(run_max, om);
    float ns = 0.f;
    if (run_max > -CUDART_INF_F) ns += run_sum * expf(run_max - nm);
    if (om > -CUDART_INF_F) ns += os * expf(om - nm);
    const size_t base = (size_t)row * S + split;
    part_max[base] = nm;
    part_sum[base] = ns;
#pragma unroll
    for (int j = 0; j < list.size(); ++j) {
      if (j < k) {
        part_val[base * k + j] = list.val(j);
        part_idx[base * k + j] = list.idx(j);
      }
    }
  }
}

// One thread per row: merge the S partial (max, sum-exp, top-k) of the row.
template <class List>
__global__ void __launch_bounds__(THREADS)
head_topk_merge(const float* __restrict__ part_val, const int* __restrict__ part_idx,
                const float* __restrict__ part_max, const float* __restrict__ part_sum,
                float* __restrict__ vals, int* __restrict__ idxs, float* __restrict__ lse,
                int N, int k, int S) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  List list(k);
  float m = -CUDART_INF_F;
  for (int s = 0; s < S; ++s) m = fmaxf(m, part_max[(size_t)row * S + s]);
  float sum = 0.f;
  for (int s = 0; s < S; ++s) {
    const size_t base = (size_t)row * S + s;
    const float pm = part_max[base];
    if (pm > -CUDART_INF_F) sum += part_sum[base] * expf(pm - m);
#pragma unroll
    for (int j = 0; j < list.size(); ++j) {
      if (j < k) list.insert(part_val[base * k + j], part_idx[base * k + j]);
    }
  }
  lse[row] = m + logf(sum);
#pragma unroll
  for (int j = 0; j < list.size(); ++j) {
    if (j < k) {
      vals[(size_t)row * k + j] = list.val(j);
      idxs[(size_t)row * k + j] = list.idx(j);
    }
  }
}

// list_bytes: the dynamic shared memory of one thread's list (0 for lists in
// registers); merge_threads: rows per block of the merge.
template <class List>
cudaError_t launch(const void* x, const void* w, void* part_val, void* part_idx,
                   void* part_max, void* part_sum, void* vals, void* idxs, void* lse,
                   int N, int D, int V, int k, int tiles_per_split, int S, int list_bytes,
                   int merge_threads, cudaStream_t stream) {
  const int smem = list_bytes * THREADS;
  cudaError_t err;
  if (smem > 0) {
    err = cudaFuncSetAttribute(head_topk_partial<List>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((N + BM - 1) / BM, S);
  head_topk_partial<List><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<float*>(part_val), static_cast<int*>(part_idx),
      static_cast<float*>(part_max), static_cast<float*>(part_sum),
      N, D, V, k, tiles_per_split, S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  head_topk_merge<List><<<(N + merge_threads - 1) / merge_threads, merge_threads,
                          list_bytes * merge_threads, stream>>>(
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
int openviic_head_topk_max_k(void) { return 128; }

// Launch both kernels on `stream`; returns cudaGetLastError() after them.
// Scratch: part_val (N, S, k) f32, part_idx (N, S, k) i32, part_max and
// part_sum (N, S) f32.  Outputs: vals (N, k) f32, idxs (N, k) i32, lse (N,)
// f32.  The caller guarantees 1 <= k <= min(128, V), D % 8 == 0, 16-byte
// aligned x and w, and S * tiles_per_split >= ceil(V / BN) with every split
// non-empty.
int openviic_head_topk(const void* x, const void* w, void* part_val, void* part_idx,
                       void* part_max, void* part_sum, void* vals, void* idxs, void* lse,
                       int N, int D, int V, int k, int tiles_per_split, int S,
                       void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k <= 8) {
    return launch<RegisterList<8>>(x, w, part_val, part_idx, part_max, part_sum, vals, idxs,
                                   lse, N, D, V, k, tiles_per_split, S, 0, THREADS, st);
  }
  if (k <= 16) {
    return launch<RegisterList<16>>(x, w, part_val, part_idx, part_max, part_sum, vals, idxs,
                                    lse, N, D, V, k, tiles_per_split, S, 0, THREADS, st);
  }
  // the merge's lists: 32 rows per block keep them under 48 KB at k = 128
  return launch<SharedList>(x, w, part_val, part_idx, part_max, part_sum, vals, idxs, lse,
                            N, D, V, k, tiles_per_split, S,
                            k * (int)(sizeof(float) + sizeof(int)), 32, st);
}

}  // extern "C"
