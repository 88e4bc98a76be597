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
// memory traffic.  Only wgmma reaches that rate.
//
// Design.  A block owns 64 rows of x and a contiguous split of the vocab
// tiles (128 ids each); the host picks the split count so that the grid
// fills the SMs at one block per SM (1600 rows: 25 x 5 blocks; 320 rows:
// 5 x 26), the splits' sizes differing by at most one tile.  The block's x
// rows are loaded once by TMA (64 rows x 64 columns per box, 128-byte
// swizzle) and stay resident.  A producer warp streams w's tiles (128 ids x
// 64 columns, 16 KB, one TMA copy each) through full/empty mbarriers into a
// ring of up to 8 stages (what shared memory leaves).  Consumer warpgroups
// run wgmma.mma_async m64n128k16 (bf16 operands from shared memory through
// 128-byte-swizzle descriptors, f32 sums in registers).  With k <= 16 two
// consumer warpgroups take alternate vocab tiles of the same rows, so one's
// epilogue overlaps the other's products on the tensor cores.  Each stage
// has a full barrier per warpgroup, completed by the loads of that
// warpgroup's tiles only: with one barrier, a warpgroup waiting for a
// stage's use two phases ahead would pass on the parity of an earlier one.
// The epilogue works from the registers: each thread holds 2 rows x 32
// columns of the tile; it rounds each logit to bf16 in place, folds the
// tile into its rows' running (max, sum-exp) and rejects every logit that
// is not above the thread's current k-th value for its row (a thread sees
// its columns in increasing id order, so a later equal value always loses
// the tie), is below the largest such k-th value of the row's 4 threads,
// or is below the smallest of the 4 threads' ceil(k / 4)-th largest logit
// of the tile (then k logits of the tile are at least as large).  The few
// left go through the thread's slot in shared memory into its sorted list
// of the row there, the warp's lanes inserting side by side in one loop
// (not at each of the 64 logit sites, where the warp would run an insert
// for whichever few lanes take it).  The 4 threads of a row (a quad) then
// merge their sums by shuffles and their lists into the first thread's,
// the two warpgroups through shared memory, and the block writes the
// split's partial (max, sum-exp, top-k) per row.  A second kernel, one warp
// per row, adds the splits' sums and merges their sorted lists k-way.
//
// k up to 16 keeps two lists of k per thread.  For 16 < k <= 128, the
// largest k the JAX kernel returns, one warpgroup keeps one heap of k per
// row (k + 1 entries apart; its root the row's k-th value, log k steps an
// insert, sorted once at the end), the 4 threads of a row inserting in
// turn; that is correct and slower, and off the decode path's beams.
//
// What else bounds it here: every row block reads all of w from L2 (25 x
// 10.24 MB = 256 MB at N = 1600), a floor of its own at the L2's rate.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

#include <climits>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BM = 64;        // rows of x per block (one wgmma M)
constexpr int BN = 128;       // vocab ids per tile (wgmma N)
constexpr int BKX = 64;       // columns of D per TMA box: one 128-byte swizzled row
constexpr int X_BOX = BM * BKX * 2;   // 8 KB
constexpr int W_BOX = BN * BKX * 2;   // 16 KB: one ring stage
constexpr int MAX_K = 128;

__device__ __forceinline__ bool better(float v1, int i1, float v2, int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

// ---- mbarriers, TMA and wgmma
__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Wait until the barrier's phase `parity` has completed: one PTX loop, with
// no branch in the C++ around it (a consumer's wait comes right before its
// wgmma); a wait that outlasts ~2^24 tries traps rather than hang.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred p;\n .reg .u32 n;\n mov.u32 n, 0;\n"
      "WAIT:\n mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @p bra DONE;\n add.u32 n, n, 1;\n setp.lt.u32 p, n, 16777216;\n @p bra WAIT;\n"
      " trap;\nDONE:\n}\n"
      ::"r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

// One TMA box of `map` at (column x, row y) into shared memory at `dst`,
// completing on `bar`; rows and columns outside the tensor read as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int x, int y,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

// The wgmma descriptor of a K-major operand in shared memory, 128-byte
// swizzled as TMA wrote it: rows of 128 bytes, 8-row groups 1024 bytes
// apart; `addr` may step 32 bytes at a time through a row for each k16.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  uint64_t d = (uint64_t)((addr & 0x3FFFFu) >> 4);
  d |= (uint64_t)1 << 16;             // leading byte offset (unused when swizzled)
  d |= (uint64_t)(1024 >> 4) << 32;   // stride byte offset: 8 rows x 128 bytes
  d |= (uint64_t)1 << 62;             // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N groups of this warpgroup's products are in flight;
// after N = 0 the accumulators may be read (the empty asm keeps the
// compiler's reads of them after the wait).
template <int N>
__device__ __forceinline__ void wgmma_wait(float (&d)[64]) {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
  if (N == 0) {
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
  }
}

// d (+)= A (64 x 16, K-major) * B (16 x 128, from 128 K-major rows):
// thread t of the warpgroup holds rows 16 (t / 32) + (t % 32) / 4 (+ 8) and
// columns 8 j + 2 (t % 4) (+ 1) in d[4 j + {0, 1}] ({2, 3}: row + 8).
__device__ __forceinline__ void wgmma_128(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Byte offsets of the partial kernel's dynamic shared memory (from a
// 1024-byte aligned base): x's boxes, the ring, the lists (two warpgroups:
// each thread's own two lists of k; one warpgroup: one heap of k per row,
// k + 1 entries apart), each thread's candidate slot (two warpgroups), the
// second warpgroup's sums, barriers.
struct Layout {
  int x, ring, stages, lists, cand, sums, bars, total;
};

constexpr int CAND = 33;  // words of a thread's candidate slot: 32, and one to skew the banks

constexpr int SMEM_BUDGET = 232448;  // shared memory a block may take on an H100

template <int WGS>
__host__ __device__ inline int list_entries(int k) { return WGS == 1 ? BM * (k + 1) : 256 * 2 * k; }

// The ring takes what shared memory is left, up to 8 stages (6 with one
// warpgroup), at least 2 (the host refuses a layout over its card's limit).
template <int WGS>
__host__ __device__ inline Layout layout(int D, int k) {
  Layout l;
  l.x = 0;
  l.ring = ((D + BKX - 1) / BKX) * X_BOX;
  const int cand = WGS == 2 ? 256 * CAND * 4 : 0;
  const int rest = list_entries<WGS>(k) * 8 + cand + (WGS == 2 ? BM * 2 * 4 : 0) + 256 + 1024;
  const int fit = (SMEM_BUDGET - l.ring - rest) / W_BOX;
  l.stages = fit > (WGS == 2 ? 8 : 6) ? (WGS == 2 ? 8 : 6) : (fit < 2 ? 2 : fit);
  l.lists = l.ring + l.stages * W_BOX;
  l.cand = l.lists + list_entries<WGS>(k) * 8;
  l.sums = l.cand + cand;
  l.bars = l.sums + (WGS == 2 ? BM * 2 * 4 : 0);
  // xbar, full (one per warpgroup and stage), empty (one per stage)
  l.total = l.bars + (1 + (WGS + 1) * l.stages) * 8 + 1024;  // and room to align
  return l;
}

// (m1, s1) += (m2, s2): the sums of exp against the larger max
__device__ __forceinline__ void merge_lse(float& m1, float& s1, float m2, float s2) {
  const float nm = fmaxf(m1, m2);
  float ns = 0.f;
  if (m1 > -CUDART_INF_F) ns += s1 * expf(m1 - nm);
  if (m2 > -CUDART_INF_F) ns += s2 * expf(m2 - nm);
  m1 = nm;
  s1 = ns;
}

// mbarrier arrival by the threads where `on` holds, without a branch (a
// branch here would put wgmma's warpgroup arrivals on a divergent path)
__device__ __forceinline__ void bar_arrive_if(uint32_t bar, bool on) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.u32 p, %1, 0;\n"
      " @p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n"
      ::"r"(bar), "r"((uint32_t)on) : "memory");
}

// Insert (nv, ni), known to beat the last entry, into the sorted list (v,
// id) of k entries in shared memory; returns the new k-th value.
__device__ __forceinline__ float push(float* v, int* id, int k, float nv, int ni) {
  int j = k - 1;
  for (; j > 0 && better(nv, ni, v[j - 1], id[j - 1]); --j) {
    v[j] = v[j - 1];
    id[j] = id[j - 1];
  }
  v[j] = nv;
  id[j] = ni;
  return v[k - 1];
}

// The sorted list (ov, oi) of k entries into the list (v, id).
__device__ __forceinline__ void merge_list(float* v, int* id, const float* ov, const int* oi,
                                           int k) {
  for (int j = 0; j < k && better(ov[j], oi[j], v[k - 1], id[k - 1]); ++j) {
    push(v, id, k, ov[j], oi[j]);
  }
}

// A row's list for 16 < k: a heap of k (value, id) pairs whose root is the
// worst, so that an insert costs log k steps and the root is the k-th.
// Put (nv, ni) at the root of the heap [0, n) in place of what was there,
// and sift it down.
__device__ __forceinline__ void sift_down(float* v, int* id, int n, float nv, int ni) {
  int i = 0;
  for (;;) {
    const int l = 2 * i + 1;
    if (l >= n) break;
    int c = l;  // the worse child
    if (l + 1 < n && better(v[l], id[l], v[l + 1], id[l + 1])) c = l + 1;
    if (!better(nv, ni, v[c], id[c])) break;
    v[i] = v[c];
    id[i] = id[c];
    i = c;
  }
  v[i] = nv;
  id[i] = ni;
}

// Sort a heap of k in place, best first: the root, the worst, goes last.
__device__ __forceinline__ void heap_sort(float* v, int* id, int k) {
  for (int n = k - 1; n > 0; --n) {
    const float tv = v[n];
    const int ti = id[n];
    v[n] = v[0];
    id[n] = id[0];
    sift_down(v, id, n, tv, ti);
  }
}

// The j-th largest (j <= 4) of this thread's 32 logits of row h of the tile,
// -inf past V: a sorting network keeps the largest 2 (or 4).
__device__ __forceinline__ float tile_largest(const float (&acc)[64], int h, int j) {
  float a0 = -CUDART_INF_F, a1 = -CUDART_INF_F, a2 = -CUDART_INF_F, a3 = -CUDART_INF_F;
  if (j <= 2) {
#pragma unroll
    for (int i = 0; i < BN / 4; ++i) {
      const float v = acc[4 * (i >> 1) + 2 * h + (i & 1)];
      a1 = fmaxf(a1, fminf(a0, v));
      a0 = fmaxf(a0, v);
    }
    return j == 1 ? a0 : a1;
  }
#pragma unroll
  for (int i = 0; i < BN / 4; ++i) {
    float v = acc[4 * (i >> 1) + 2 * h + (i & 1)];
    float hi = fmaxf(a0, v);
    v = fminf(a0, v);
    a0 = hi;
    hi = fmaxf(a1, v);
    v = fminf(a1, v);
    a1 = hi;
    hi = fmaxf(a2, v);
    v = fminf(a2, v);
    a2 = hi;
    a3 = fmaxf(a3, v);
  }
  return j == 3 ? a2 : a3;
}

// Four k16 products of one stage: acc (+)= x's box kb (64 x 64) times the
// stage's 128 ids x 64 columns; after the stage's wait, the warpgroup's
// arrive (wgmma.fence) and then the products, as one group.
__device__ __forceinline__ void stage_mma(float (&acc)[64], uint32_t xbox, uint32_t wbox,
                                          bool accumulate) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(acc[i])::"memory");
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BKX / 16; ++kk) {
    wgmma_128(acc, smem_desc(xbox + kk * 32), smem_desc(wbox + kk * 32), accumulate || kk > 0);
  }
  wgmma_commit();
}

// The partial kernel.  Grid (ceil(N / BM), S): block (bx, s) covers rows
// [bx BM, bx BM + BM) and the vocab tiles [s T / S, (s + 1) T / S) of the
// T = ceil(V / BN).  It writes, per row, the split's max, sum of
// exp(logit - max) and top-k to the partials (row-major (N, S[, k])).
// WGS consumer warpgroups (2: each thread's lists, alternate tiles; 1: row
// lists) and a producer warp.
template <int WGS>
__global__ void __launch_bounds__(WGS * 128 + 32, 1)
head_topk_partial(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap wmap,
                  float* __restrict__ part_val, int* __restrict__ part_idx,
                  float* __restrict__ part_max, float* __restrict__ part_sum,
                  int N, int D, int V, int k, int S) {
  extern __shared__ __align__(1024) unsigned char raw[];
  unsigned char* smem = raw + ((1024u - (hopper::smem_addr(raw) & 1023u)) & 1023u);
  const Layout lay = layout<WGS>(D, k);
  const int NS = lay.stages;
  const uint32_t base = hopper::smem_addr(smem);
  // stage i's full barrier for warpgroup g: full + 8 (g NS + i); its empty barrier: empty + 8 i
  const uint32_t xbar = base + lay.bars, full = xbar + 8, empty = full + 8 * WGS * NS;
  const int KB = (D + BKX - 1) / BKX;
  const int T = (V + BN - 1) / BN;
  const int row0 = blockIdx.x * BM, split = blockIdx.y;
  const int t0 = (int)((long long)split * T / S), t1 = (int)((long long)(split + 1) * T / S);
  const int tid = threadIdx.x;

  if (tid == 0) {
    bar_init(xbar, 1);
    for (int i = 0; i < WGS * NS; ++i) bar_init(full + 8 * i, 1);
    for (int i = 0; i < NS; ++i) bar_init(empty + 8 * i, 4);  // the 4 warps that used the stage
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  float* lv = reinterpret_cast<float*>(smem + lay.lists);
  int* li = reinterpret_cast<int*>(lv + list_entries<WGS>(k));
  for (int e = tid; e < list_entries<WGS>(k); e += blockDim.x) {
    lv[e] = -CUDART_INF_F;
    li[e] = INT_MAX;
  }
  __syncthreads();

  if (tid >= WGS * 128) {
    // the producer warp: the split's stages in order through one ring, tile
    // i's to warpgroup i % WGS, each completing on that warpgroup's full
    // barrier of the stage, so that a warpgroup's barriers count its uses only
    if (tid == WGS * 128) {
      bar_expect(xbar, KB * X_BOX);
      for (int kb = 0; kb < KB; ++kb) {
        tma_load(base + lay.x + kb * X_BOX, &xmap, kb * BKX, row0, xbar);
      }
      int q = 0;
      for (int tile = t0; tile < t1; ++tile) {
        const uint32_t owner_full = full + 8 * NS * ((tile - t0) % WGS);
        for (int kb = 0; kb < KB; ++kb, ++q) {
          const int st = q % NS;
          if (q >= NS) bar_wait(empty + 8 * st, ((q / NS) - 1) & 1);
          bar_expect(owner_full + 8 * st, W_BOX);
          tma_load(base + lay.ring + st * W_BOX, &wmap, kb * BKX, tile * BN, owner_full + 8 * st);
        }
      }
    }
    return;
  }

  const int wg = tid / 128, lane = tid & 31;
  const int r_lo = 16 * ((tid % 128) / 32) + (lane >> 2);  // this thread's rows r_lo, r_lo + 8
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, s[2] = {0.f, 0.f};
  float thr[2] = {-CUDART_INF_F, -CUDART_INF_F};  // this thread's k-th values (two warpgroups)
  float* cand = reinterpret_cast<float*>(smem + lay.cand) + tid * CAND;
  bar_wait(xbar, 0);

  const uint32_t my_full = full + 8 * NS * wg;
  uint32_t parity = 0;  // bit i: the parity of this warpgroup's next wait on stage i
  float acc[64];
  for (int tile = t0 + wg; tile < t1; tile += WGS) {
    const int q0 = (tile - t0) * KB;
    __syncwarp();  // wgmma is warp-aligned: the epilogue's branches end here
    int st = q0 % NS;
    bar_wait(my_full + 8 * st, (parity >> st) & 1u);
    parity ^= 1u << st;
    stage_mma(acc, base + lay.x, base + lay.ring + st * W_BOX, false);
    for (int kb = 1; kb < KB; ++kb) {
      const int prev = st;
      st = (q0 + kb) % NS;
      bar_wait(my_full + 8 * st, (parity >> st) & 1u);
      parity ^= 1u << st;
      stage_mma(acc, base + lay.x + kb * X_BOX, base + lay.ring + st * W_BOX, true);
      wgmma_wait<1>(acc);
      bar_arrive_if(empty + 8 * prev, lane == 0);  // the previous stage is done
    }
    wgmma_wait<0>(acc);
    bar_arrive_if(empty + 8 * st, lane == 0);

    // the tile's logits rounded to bf16, as the contract says; -inf past V
    const int c0 = tile * BN + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[4 * j + i] = c0 + 8 * j + (i & 1) < V ? round_bf16(acc[4 * j + i]) : -CUDART_INF_F;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float tmax = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        tmax = fmaxf(tmax, fmaxf(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]));
      }
      if (tmax > -CUDART_INF_F) {  // the running (max, sum-exp) of the row
        const float nm = fmaxf(m[h], tmax);
        float sum = s[h] * __expf(m[h] - nm);  // m = -inf gives 0 * 0
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          sum += __expf(acc[4 * j + 2 * h] - nm) + __expf(acc[4 * j + 2 * h + 1] - nm);
        }
        m[h] = nm;
        s[h] = sum;
      }
      if (WGS == 2) {
        // this thread's list of the row: a logit not above its k-th value is
        // rejected before any insert; the few left go through the thread's
        // slot, and the warp inserts them in one loop, lanes side by side
        // below the largest k-th value of the row's 4 threads, a logit has
        // k better ones already (in that thread's list); below the smallest
        // of the 4 threads' ceil(k / 4)-th largest logit of this tile, it
        // has k at least as large in the tile: either way it cannot be in
        // the row's top k
        float quad = fmaxf(thr[h], __shfl_xor_sync(0xffffffffu, thr[h], 1));
        quad = fmaxf(quad, __shfl_xor_sync(0xffffffffu, quad, 2));
        float tile_kth = tile_largest(acc, h, (k + 3) / 4);
        tile_kth = fminf(tile_kth, __shfl_xor_sync(0xffffffffu, tile_kth, 1));
        tile_kth = fminf(tile_kth, __shfl_xor_sync(0xffffffffu, tile_kth, 2));
        quad = fmaxf(quad, tile_kth);
        unsigned pass = 0;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v = acc[4 * j + 2 * h + e];
            if (v > thr[h] && v >= quad) pass |= 1u << (2 * j + e);
          }
        }
        if (__any_sync(0xffffffffu, pass != 0)) {
          if (pass) {
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
              cand[2 * j] = acc[4 * j + 2 * h];
              cand[2 * j + 1] = acc[4 * j + 2 * h + 1];
            }
          }
          float* tv = lv + (tid * 2 + h) * k;
          int* ti = li + (tid * 2 + h) * k;
          while (__any_sync(0xffffffffu, pass != 0)) {
            if (pass) {
              const int i = __ffs(pass) - 1;
              pass &= pass - 1;
              const float v = cand[i];
              if (v > thr[h]) thr[h] = push(tv, ti, k, v, c0 + 8 * (i >> 1) + (i & 1));
            }
          }
        }
      }
    }
    if (WGS == 1) {
      // row heaps: the 4 threads of a row insert in turn, each only where
      // its best logit reaches the row's k-th value, the heap's root
      for (int turn = 0; turn < 4; ++turn) {
        if ((lane & 3) == turn) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float* rv = lv + (r_lo + 8 * h) * (k + 1);
            int* ri = li + (r_lo + 8 * h) * (k + 1);
            float tmax = -CUDART_INF_F;
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
              tmax = fmaxf(tmax, fmaxf(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]));
            }
            if (tmax < rv[0]) continue;
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float v = acc[4 * j + 2 * h + e];
                const int col = c0 + 8 * j + e;
                if (v > -CUDART_INF_F && better(v, col, rv[0], ri[0])) {
                  sift_down(rv, ri, k, v, col);
                }
              }
            }
          }
        }
        __syncwarp();
      }
    }
  }

  // the 4 threads of each row merge their sums by shuffles and, with two
  // warpgroups, their lists into the first thread's; the second warpgroup's
  // into the first's through shared memory
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      merge_lse(m[h], s[h], __shfl_xor_sync(0xffffffffu, m[h], o),
                __shfl_xor_sync(0xffffffffu, s[h], o));
    }
  }
  float* sums = reinterpret_cast<float*>(smem + lay.sums);  // (BM, 2)
  if (WGS == 2) {
    __syncwarp();
    if ((lane & 3) == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        for (int q = 1; q < 4; ++q) {
          merge_list(lv + (tid * 2 + h) * k, li + (tid * 2 + h) * k,
                     lv + ((tid + q) * 2 + h) * k, li + ((tid + q) * 2 + h) * k, k);
        }
        if (wg == 1) {
          sums[(r_lo + 8 * h) * 2] = m[h];
          sums[(r_lo + 8 * h) * 2 + 1] = s[h];
        }
      }
    }
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(WGS * 128) : "memory");
  if (wg > 0) return;

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + r_lo + 8 * h;
    const bool live = row < N;
    const size_t at = (size_t)row * S + split;
    if (WGS == 2) {  // the quad's merged list, then the second warpgroup's
      if (!live || (lane & 3) != 0) continue;
      float* rv = lv + (tid * 2 + h) * k;
      int* ri = li + (tid * 2 + h) * k;
      merge_lse(m[h], s[h], sums[(r_lo + 8 * h) * 2], sums[(r_lo + 8 * h) * 2 + 1]);
      merge_list(rv, ri, lv + ((tid + 128) * 2 + h) * k, li + ((tid + 128) * 2 + h) * k, k);
      part_max[at] = m[h];
      part_sum[at] = s[h];
      for (int j = 0; j < k; ++j) {
        part_val[at * k + j] = rv[j];
        part_idx[at * k + j] = ri[j];
      }
    } else {  // the row's heap, sorted by the quad's first thread
      float* rv = lv + (r_lo + 8 * h) * (k + 1);
      int* ri = li + (r_lo + 8 * h) * (k + 1);
      if (live && (lane & 3) == 0) {
        part_max[at] = m[h];
        part_sum[at] = s[h];
        heap_sort(rv, ri, k);
      }
      __syncwarp();
      for (int j = lane & 3; live && j < k; j += 4) {
        part_val[at * k + j] = rv[j];
        part_idx[at * k + j] = ri[j];
      }
    }
  }
}

constexpr int MAX_SPLITS = 96;  // vocab splits the merge takes: 3 list heads per lane

// One warp per row: the row's lse from the S partial (max, sum-exp), and its
// top k by a k-way merge of the S sorted partial lists (lane l holds the
// heads of splits l, l + 32, l + 64; each step the warp takes the best
// head, ties to the lowest id).
__global__ void __launch_bounds__(128)
head_topk_merge(const float* __restrict__ part_val, const int* __restrict__ part_idx,
                const float* __restrict__ part_max, const float* __restrict__ part_sum,
                float* __restrict__ vals, int* __restrict__ idxs, float* __restrict__ lse,
                int N, int k, int S) {
  const int row = blockIdx.x * 4 + threadIdx.x / 32, lane = threadIdx.x & 31;
  if (row >= N) return;
  const size_t base = (size_t)row * S;
  float m = -CUDART_INF_F;
  for (int s = lane; s < S; s += 32) m = fmaxf(m, part_max[base + s]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  float sum = 0.f;
  for (int s = lane; s < S; s += 32) {
    const float pm = part_max[base + s];
    if (pm > -CUDART_INF_F) sum += part_sum[base + s] * expf(pm - m);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (lane == 0) lse[row] = m + logf(sum);

  int pos[MAX_SPLITS / 32] = {};  // next entry of each of this lane's splits
  for (int j = 0; j < k; ++j) {
    float bv = -CUDART_INF_F;
    int bi = INT_MAX, bu = -1;
#pragma unroll
    for (int u = 0; u < MAX_SPLITS / 32; ++u) {
      const int s = lane + 32 * u;
      if (s < S && pos[u] < k) {
        const size_t at = (base + s) * k + pos[u];
        const float v = part_val[at];
        const int id = part_idx[at];
        if (bu < 0 || better(v, id, bv, bi)) {
          bv = v;
          bi = id;
          bu = u;
        }
      }
    }
    float wv = bv;
    int wi = bi;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, wv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, wi, o);
      if (better(ov, oi, wv, wi)) {
        wv = ov;
        wi = oi;
      }
    }
    const unsigned mine = __ballot_sync(0xffffffffu, bu >= 0 && bv == wv && bi == wi);
    if (mine != 0 && lane == __ffs(mine) - 1) {
#pragma unroll
      for (int u = 0; u < MAX_SPLITS / 32; ++u) pos[u] += u == bu;
    }
    if (lane == 0) {
      vals[(size_t)row * k + j] = wv;
      idxs[(size_t)row * k + j] = wi;
    }
  }
}

// The TMA map of a (rows, D) row-major bf16 matrix: boxes of `box_rows`
// rows x BKX columns, 128-byte swizzled, zeros outside.
cudaError_t operand_map(CUtensorMap* map, const void* ptr, int rows, int D, int box_rows) {
  const hopper::EncodeTiled encode = hopper::tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D * 2};
  const cuuint32_t box[2] = {BKX, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int WGS>
int smem_of(int D, int k) {
  return layout<WGS>(D, k).total;
}

template <int WGS>
cudaError_t launch(const void* x, const void* w, void* part_val, void* part_idx,
                   void* part_max, void* part_sum, void* vals, void* idxs, void* lse,
                   int N, int D, int V, int k, int S, cudaStream_t stream) {
  CUtensorMap xmap, wmap;
  cudaError_t err = operand_map(&xmap, x, N, D, BM);
  if (err == cudaSuccess) err = operand_map(&wmap, w, V, D, BN);
  if (err != cudaSuccess) return err;
  const int smem = smem_of<WGS>(D, k);
  err = cudaFuncSetAttribute(head_topk_partial<WGS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BM - 1) / BM, S);
  head_topk_partial<WGS><<<grid, WGS * 128 + 32, smem, stream>>>(
      xmap, wmap, static_cast<float*>(part_val), static_cast<int*>(part_idx),
      static_cast<float*>(part_max), static_cast<float*>(part_sum), N, D, V, k, S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  head_topk_merge<<<(N + 3) / 4, 128, 0, stream>>>(
      static_cast<const float*>(part_val), static_cast<const int*>(part_idx),
      static_cast<const float*>(part_max), static_cast<const float*>(part_sum),
      static_cast<float*>(vals), static_cast<int*>(idxs), static_cast<float*>(lse), N, k, S);
  return cudaGetLastError();
}

template <int WGS>
int occupancy_of(int D, int k, int* out) {
  const int smem = smem_of<WGS>(D, k);
  cudaError_t err = cudaFuncSetAttribute(head_topk_partial<WGS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int per_sm = 0;
  cudaFuncAttributes attr;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, head_topk_partial<WGS>,
                                                        WGS * 128 + 32, smem);
  }
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, head_topk_partial<WGS>);
  if (err != cudaSuccess) return (int)err;
  out[0] = per_sm;
  out[1] = WGS * 128 + 32;
  out[2] = attr.numRegs;
  out[3] = (int)attr.localSizeBytes;
  out[4] = smem;
  return 0;
}

}  // namespace

extern "C" {

// Rows of x per block, and vocab ids per tile (the unit in which the host
// splits the vocab).
int openviic_head_topk_tile_rows(void) { return BM; }
int openviic_head_topk_tile_cols(void) { return BN; }

// Largest k and largest vocab split count the kernel takes.
int openviic_head_topk_max_k(void) { return MAX_K; }
int openviic_head_topk_max_splits(void) { return MAX_SPLITS; }

// Dynamic shared memory of the partial kernel's block at width D and k.
int openviic_head_topk_smem(int D, int k) {
  return k <= 16 ? smem_of<2>(D, k) : smem_of<1>(D, k);
}

// What the partial kernel runs with at width D and k: out = {CTAs per SM,
// threads per CTA, registers per thread, local (spill) bytes per thread,
// shared bytes per CTA}.  Returns a CUDA error code.
int openviic_head_topk_occupancy(int D, int k, int* out) {
  return k <= 16 ? occupancy_of<2>(D, k, out) : occupancy_of<1>(D, k, out);
}

// Launch both kernels on `stream`; returns cudaGetLastError() after them.
// Scratch: part_val (N, S, k) f32, part_idx (N, S, k) i32, part_max and
// part_sum (N, S) f32.  Outputs: vals (N, k) f32, idxs (N, k) i32, lse (N,)
// f32.  The caller guarantees 1 <= k <= min(128, V), D % 8 == 0, 16-byte
// aligned x and w, and 1 <= S <= min(ceil(V / 128), 96), so that every split
// holds a tile.
int openviic_head_topk(const void* x, const void* w, void* part_val, void* part_idx,
                       void* part_max, void* part_sum, void* vals, void* idxs, void* lse,
                       int N, int D, int V, int k, int S, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S > MAX_SPLITS) return (int)cudaErrorInvalidValue;
  return k <= 16 ? launch<2>(x, w, part_val, part_idx, part_max, part_sum, vals, idxs, lse, N, D,
                             V, k, S, st)
                 : launch<1>(x, w, part_val, part_idx, part_max, part_sum, vals, idxs, lse, N, D,
                             V, k, S, st);
}

}  // extern "C"
