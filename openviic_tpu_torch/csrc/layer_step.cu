// One decoder layer's decode step as one kernel, for Hopper (sm_90a), in two
// designs built from one set of parts:
//
//  - resident:: replaces the Pallas kernel
//    openviic_tpu/ops/resident_layer_step.py::resident_layer_step (the
//    beam-resident step: caches never reordered, positions resolved through
//    the ancestry table, this step's K/V an extra column, cross K/V at image
//    granularity, output zeroed where the input token is <pad>; it returns
//    this step's K/V rows and leaves the caches alone);
//  - fused:: replaces the Pallas kernel
//    openviic_tpu/ops/fused_decoder_step.py::fused_layer_step (the
//    non-resident step: no ancestry, cross K/V per row, f32 throughout; it
//    writes row t of the caches in place).
//
// Per row: qkv = x Wqkv + b; self-attention; x1 = LN1(x + (att Wo + bo));
// cross-attention; x2 = LN2(x1 + (att Woc + boc)); x3 = LN3(x2 + FFN(x2)).
// The rounding points are those of each TPU kernel:
//  - resident: every product's operands are rounded to bf16 and accumulate
//    in f32 (the JAX _mm), the q.k element products are rounded to bf16,
//    the softmax weights exp(s - m) are rounded to bf16 before PV with the
//    final max m (so the softmax takes two passes, never an online max),
//    this step's v enters PV unrounded, masks are additive -1e30;
//  - fused: f32 activations times the (bf16-valued) weights, accumulated in
//    f32; this step's K/V enter attention unrounded at position t; -1e30
//    additive masks and a max(sum, 1e-30) softmax guard, so a fully masked
//    row is uniform.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s dense bf16): at the
// flagship step (N = 1600 rows, L = 25, M = 50, D = 512, h = 8, F = 2048,
// bf16) the products are ~11.7 GFLOP, ~12 us on the tensor cores (~36 us
// for the fused step, whose f32 operands take three bf16 terms), while the
// bytes are up to 82 MB of self K/V (at t = L - 1), 7.3 MB of weights, 6.6
// MB in and out, plus the cross K/V: 33 MB at image granularity (resident),
// 164 MB per row (fused).  Both are bound by bytes: ~38 us (resident) and
// ~78 us (fused) at the last step, less at earlier ones (chip_smoke.py
// counts the live rows of each call).
//
// The design, for both.  A thread-block cluster of two CTAs shares a tile of
// up to 32 rows (two 16-row MMA tiles) and splits the layer between them:
// CTA c owns half of every D-wide product's output columns, half of the
// heads and half of the FFN's hidden columns, so each CTA streams half of
// the 7.3 MB of weights; the FFN's second product splits its depth (each
// CTA its own hidden columns) and the partial sums cross to the CTA that
// owns the columns through distributed shared memory.  The host takes rows
// per tile = ceil(N / tiles that fit at once), so the grid fills the card
// (1600 rows: 64 clusters, tiles of 25 rows).  Each CTA keeps its own
// columns of the residual stream in f32 and the A operand of every product
// (all D columns) in shared memory; the attention outputs and LayerNorm
// outputs are written into both CTAs' A operands, and the LayerNorm row
// sums are added across the cluster.  The consumers of the two CTAs meet
// at mbarriers in each other's shared memory (two alternating barriers per
// CTA, arrivals from all 32 consumer warps).
//
// The weights stream through a ring of 3 stages of 16 KB: a producer warp
// per CTA loads each stage with up to 4 TMA copies (boxes of 32 rows x 64
// columns, 128-byte swizzle, tensor maps made on the host through
// cuTensorMapEncodeTiled, L2 evict-last), completing on the stage's full
// mbarrier; it runs ahead across the products and through the attention
// phases.  A stage holds 32 weight rows of a 256-column pass or 64 rows of
// a pass of 128 columns or fewer.  Few large copies matter: loading a stage
// with one 1-D bulk copy per weight row was slower, as the copies' count
// and not their bytes set the pace (PERF.md).  16 consumer warps run
// mma.sync m16n8k16 (bf16, f32 sums), each 16 output columns of a pass (of
// one of the two row tiles, where a pass is too narrow to give all 16
// warps columns), reading the swizzled tiles with ldmatrix.trans without
// bank conflicts, and release the stage on its empty mbarrier.  Attention
// runs one warp per (row, own head): d/8 lanes hold one position's 8
// elements (one 16-byte load, L2 evict-first), and a warp issues the K
// loads of up to 32 positions before it reduces any score, then the V
// loads of a batch together; masked positions skip their K loads (score
// -1e30 exactly, as the additive mask gives), and V loads of weight 0 are
// skipped.  The positions stream through a per-warp scratch of ATT_CHUNK
// scores, so shared memory does not grow with the encoder length M (the
// self mask and ancestry rows, BM x L, are staged whole as before): where
// one chunk holds every position the scores are taken once, as before;
// past it a first pass over the chunks finds the final max and a second
// takes the scores again (K read twice) with the weights and the PV
// product, so every weight is exp(s - final max), rounded where the JAX
// kernel rounds it, never rescaled as an online softmax would.  The cross
// mask is read from device memory where the scores are taken, never
// staged.  Shapes whose heads or widths do not split in two run with
// clusters of one CTA (16-row tiles).
//
// resident:: specifics.  The A operand is one bf16 plane (the JAX _mm
// rounds it); the epilogues write in place what the next phase reads (q *
// scale and k_new rounded to bf16, v_new in f32, the residual sum in f32,
// the FFN hidden layer rounded to bf16, all Fc of its columns at once).
// The CTA's ancestry is resolved once into shared memory (the source row of
// every position, its mask folded in); bf16 q.k products come from bf16
// multiplies (exact products, so the rounding is the JAX kernel's).
//
// fused:: specifics (the f32 step).  Every f32 A operand (the attention
// outputs, x1, x2 and each hidden chunk) is split into three bf16 planes
// (hi + mid + lo, f32-accurate) once, when it is written, and each plane
// is multiplied exactly by the bf16 weights with f32 sums; x itself is
// bf16, so the qkv product takes one plane.  The FFN runs in chunks of 128
// hidden columns: relu(x2 W1[:, c] + b1[c]) is split into a three-plane
// chunk buffer and at once multiplied by W2[c, :], the D-wide sums staying
// in registers across chunks, so the 16 x 2048 f32 hidden layer never
// exists whole and its shared memory goes to the weight ring.  That sums
// F in another order than one f32 dot (chunks of 128, then the two CTAs'
// halves); the gap is f32 rounding, well inside the bar of 1 bf16 ulp of y
// against the plain version (chip_smoke.py holds it there).  q, v_new and
// this step's q.k_new partial sums (per 8 columns, from the k epilogue)
// stay in shared memory in f32; k_new and v_new go to row t of the caches
// from the epilogue, rounded; attention reads position t from those f32
// values, never from the cache.  The peer's FFN partial sums land in the
// receiving CTA's A-operand buffer, free by then.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <math_constants.h>

#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float NEG = -1e30f;
constexpr float LN_EPS = 1e-5f;

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
  int rows;             // rows per cluster tile
  int cluster;          // CTAs per cluster
  float scale;          // d ** -0.5
  CUtensorMap maps[6];  // TMA maps of wqkv, wo, wqc, woc, w1, w2
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void unpack8(const uint4& u, float (&out)[8]) {
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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ============================================ the parts both designs share
constexpr int CWARPS = 16;               // consumer warps
constexpr int CTHREADS = 32 * CWARPS;
constexpr int THREADS = CTHREADS + 32;   // and one producer warp
constexpr int PASS_N = 16 * CWARPS;      // widest pass: 16 columns per consumer warp
constexpr int BK = 32;                   // rows of a TMA box
constexpr int BOX = 64;                  // columns per TMA box: one 128-byte swizzled row
constexpr int BOX_BYTES = BK * BOX * 2;
constexpr int STAGES = 3;
constexpr int STAGE_BYTES = 4 * BOX_BYTES;  // 32 rows x 256 columns, or 64 x 128
constexpr int R = 8;                     // rounds of positions whose loads issue together
constexpr int MAX_CLUSTER = 2;
constexpr int FFN_CHUNK = 128;           // fused: hidden columns per FFN chunk
constexpr int ATT_CHUNK = 128;           // attention positions per pass of a warp's scores
static_assert(ATT_CHUNK % 32 == 0, "each lane keeps its positions' order across chunks");
// CTAs per cluster of both kernels where the shape splits evenly.  The
// port builds with 2; a measurement build may pass
// -DOPENVIIC_RESIDENT_CLUSTER=1 (named for the kernel that took it first)
// to run tiles of one CTA, as shapes whose heads or widths do not split in
// two do (scripts/torch_resident_step_phases.py).
#ifdef OPENVIIC_RESIDENT_CLUSTER
constexpr int RESIDENT_CLUSTER = OPENVIIC_RESIDENT_CLUSTER;
#else
constexpr int RESIDENT_CLUSTER = 2;
#endif
static_assert(RESIDENT_CLUSTER == 1 || RESIDENT_CLUSTER == 2, "clusters of 1 or 2 CTAs");

// Phase marks: built with -DOPENVIIC_PHASES, the first consumer thread of
// each CTA reads the global timer at each meeting of the consumers into
// phase_clock (openviic_phase_clock copies it out); otherwise they compile
// to nothing.
constexpr int PHASE_SLOTS = 16, PHASE_CTAS = 1024;
#ifdef OPENVIIC_PHASES
__device__ unsigned long long phase_clock[PHASE_CTAS * PHASE_SLOTS];
__device__ __forceinline__ void phase_mark(int k) {
  if (threadIdx.x == 0 && blockIdx.x < PHASE_CTAS) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    phase_clock[blockIdx.x * PHASE_SLOTS + k] = t;
  }
}
#else
__device__ __forceinline__ void phase_mark(int) {}
#endif
constexpr long long WAIT_LIMIT = 1ll << 35;  // clocks (~17 s): a broken protocol traps, never hangs

// L2 policies: the weights stay (every CTA reads them), the caches stream.
__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(pol));
  return pol;
}

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(pol));
  return pol;
}

// A 16-byte read of the K/V caches, through L2 with the evict-first policy.
__device__ __forceinline__ uint4 load_stream(const void* p, uint64_t pol) {
  uint4 r;
  asm volatile("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;\n"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w) : "l"(p), "l"(pol));
  return r;
}

// How a cluster of C CTAs shares one tile of rows: CTA `rank` owns the
// output columns [rank * Dc, (rank + 1) * Dc) of every D-wide product, the
// heads [rank * hc, ...), the hidden columns [rank * Fc, ...) and, for the
// FFN's second product, its rows [rank * Fc, ...): a split depth whose
// partial sums the cluster adds.
struct Split {
  int C, rank, Dc, hc, Fc;
};

__host__ __device__ inline int align16(int v) { return (v + 15) & ~15; }

// ---- mbarriers, bulk copies and the cluster
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void consumer_sync() {  // the 16 consumer warps only
  asm volatile("bar.sync 1, %0;\n" ::"n"(CTHREADS) : "memory");
}

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Wait until the barrier's phase `parity` has completed.  Cluster scope
// for the exchange barriers, which the other CTA's consumers arrive on.
template <bool CLUSTER>
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    if (CLUSTER) {
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    } else {
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    }
    if (done) return;
    if (clock64() - t0 > WAIT_LIMIT) __trap();
  }
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// One arrival on the barrier at the same offset in CTA `cta` of the cluster.
__device__ __forceinline__ void bar_arrive_remote(uint32_t bar, uint32_t cta) {
  asm volatile(
      "{\n .reg .b32 ra;\n"
      " mapa.shared::cluster.u32 ra, %0, %1;\n"
      " mbarrier.arrive.release.cluster.shared::cluster.b64 _, [ra];\n}\n"
      ::"r"(bar), "r"(cta) : "memory");
}

__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

// One TMA box (BK rows x BOX columns of a weight, from column x, row y)
// into shared memory at `dst`, 128-byte swizzled, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int x, int y,
                                         uint32_t bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1, {%2, %3}], [%4], %5;\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar), "l"(policy)
      : "memory");
}

// The consumers of every CTA of the cluster meet: what each wrote before,
// also into the other CTAs' shared memory, is visible to all after.  Two
// barriers alternate, so an early arrival for the next meeting can never
// count towards this one.
struct Exchange {
  uint32_t bars;  // two mbarriers, C x CWARPS arrivals each
  int count;      // meetings so far
  __device__ void step(const Split& s) {
    if (s.C == 1) {
      consumer_sync();
      return;
    }
    const uint32_t bar = bars + 8 * (count & 1);
    asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
    __syncwarp();
    const int lane = threadIdx.x & 31;
    if (lane < s.C) bar_arrive_remote(bar, lane);
    bar_wait<true>(bar, (count >> 1) & 1);
    ++count;
  }
};

// One pass of a product: `width` (<= PASS_N, a multiple of BOX) output
// columns from column `col` of weight `map`, over K rows from row k0, bk
// rows per ring stage.  own: where the columns go among this CTA's own
// columns (for a split-depth product, among the owner's); owner: the CTA
// whose columns they are.
struct Pass {
  const bf16* bias;
  int k0, K, col, width, own, owner, map, bk;
};

// Rows of a ring stage for a pass of `width` columns: a stage holds 16 KB.
__device__ __forceinline__ int stage_rows(int width) { return width <= 2 * BOX ? 2 * BK : BK; }

// Which 16 output columns of a pass this warp computes, and for which of the
// MT row tiles (bit m: tile m).  A full pass gives every warp 16 columns of
// every tile; a narrower one splits the row tiles among the warps of a
// column group where that keeps more warps at work.
struct WarpTile {
  int col;
  unsigned tiles;
};

template <int MT>
__device__ __forceinline__ WarpTile warp_tile(int width) {
  const int warp = threadIdx.x >> 5;
  const int groups = width / 16;
  if (MT > 1 && MT * groups <= CWARPS) {
    const int t = warp / groups;
    return {16 * (warp % groups), t < MT ? 1u << t : 0u};
  }
  return {16 * warp, warp < groups ? (1u << MT) - 1u : 0u};
}

// The producer warp: every weight tile of the design's products, in the
// order the consumers use them, into the ring; lane b loads the stage's box
// b (row half b / (width / BOX), column box b % (width / BOX)).
template <class Plan>
__device__ void produce(const Params& p, const Split& s, uint32_t ring, uint32_t full,
                        uint32_t empty) {
  const int lane = threadIdx.x & 31;
  const uint64_t keep = evict_last_policy();
  int slice = 0;
  Pass ps;
  for (int g = 0; g < Plan::GROUPS; ++g) {
    for (int i = 0; Plan::pass_of(p, s, g, i, ps); ++i) {
      const int ncb = ps.width / BOX, bk = ps.bk, boxes = ncb * (bk / BK);
      const int x = ps.col + (lane % ncb) * BOX, y = ps.k0 + (lane / ncb) * BK;  // lane's box
      const uint32_t bytes = bk * ps.width * 2;
      const CUtensorMap* map = &p.maps[ps.map];
      for (int k = 0; k < ps.K; k += bk, ++slice) {
        const int st = slice % STAGES;
        if (slice >= STAGES) bar_wait<false>(empty + 8 * st, ((slice / STAGES) - 1) & 1);
        if (lane == 0) bar_expect(full + 8 * st, bytes);
        __syncwarp();
        if (lane < boxes) {
          tma_load(ring + st * STAGE_BYTES + lane * BOX_BYTES, map, x, y + k, full + 8 * st, keep);
        }
      }
    }
  }
}

// acc += A[0:16 MT, acol:acol + 32] @ (32 rows of this warp's 16 columns at
// wst), for the row tiles in `tiles` (ALL: every tile, no test).  A is
// PLANES bf16 planes `plane` elements apart, whose products add up.
template <int MT, int PLANES, bool ALL>
__device__ __forceinline__ void mma_rows32(const bf16* arow, int lda, int plane, int acol,
                                           const unsigned char* wst, unsigned tiles,
                                           float (&acc)[MT][2][4]) {
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t b[4];
    hopper::ldmatrix_x4_trans(b, wst + kk * BOX * 2);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (!ALL && !((tiles >> m) & 1u)) continue;
#pragma unroll
      for (int q = 0; q < PLANES; ++q) {
        uint32_t a[4];
        hopper::ldmatrix_x4(a, arow + q * plane + m * 16 * lda + acol + kk);
        hopper::mma_bf16(acc[m][0], a, b[0], b[1]);
        hopper::mma_bf16(acc[m][1], a, b[2], b[3]);
      }
    }
  }
}

// acc (+)= A[0:16 MT, 0:K] @ (the K x 16 columns of this warp in the ring's
// stages), for the row tiles of wt, the stages consumed in order from
// `slice`.  A is PLANES bf16 planes `plane` elements apart (pitch lda),
// whose products add up: one plane of a bf16 operand, or the hi, mid and lo
// terms of an f32 one.  zero: start the sums at 0.
template <int MT, int PLANES>
__device__ __forceinline__ void mma_pass(const bf16* A, int lda, int plane, const Pass& ps,
                                         const WarpTile& wt, const unsigned char* ring,
                                         uint32_t full, uint32_t empty, int& slice, bool zero,
                                         float (&acc)[MT][2][4]) {
  const int lane = threadIdx.x & 31;
  const int mtx = lane >> 3;
  // lane's ldmatrix rows: A rows (mtx & 1) * 8 + lane % 8 at k + (mtx >> 1) * 8;
  // stage row kr = (mtx & 1) * 8 + lane % 8 at column n = wt.col + (mtx >> 1) * 8,
  // which the 128-byte swizzle keeps in box n / BOX, row kr, 16-byte chunk
  // ((n % BOX) / 8) ^ (kr % 8): the 8 rows of a matrix hit 8 different banks
  const bf16* arow = A + ((mtx & 1) * 8 + (lane & 7)) * lda + (mtx >> 1) * 8;
  const int kr = (mtx & 1) * 8 + (lane & 7), n = wt.col + (mtx >> 1) * 8;
  const int woff = (n / BOX) * BOX_BYTES + kr * BOX * 2 + ((((n % BOX) / 8) ^ (kr & 7)) << 4);
  const int K = ps.K, bk = ps.bk;  // in registers: a Pass may live in local memory
  const int half = (ps.width / BOX) * BOX_BYTES;  // from a stage's first 32 rows to the next
  const bool all = wt.tiles == (1u << MT) - 1u;
  if (zero) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
      }
    }
  }
  for (int k0 = 0; k0 < K; k0 += bk, ++slice) {
    const int st = slice % STAGES;
    bar_wait<false>(full + 8 * st, (slice / STAGES) & 1);
    const unsigned char* wst = ring + st * STAGE_BYTES + woff;
    if (all) {
      mma_rows32<MT, PLANES, true>(arow, lda, plane, k0, wst, wt.tiles, acc);
      if (bk > BK) {
        mma_rows32<MT, PLANES, true>(arow, lda, plane, k0 + BK, wst + half, wt.tiles, acc);
      }
    } else if (wt.tiles) {
      mma_rows32<MT, PLANES, false>(arow, lda, plane, k0, wst, wt.tiles, acc);
      if (bk > BK) {
        mma_rows32<MT, PLANES, false>(arow, lda, plane, k0 + BK, wst + half, wt.tiles, acc);
      }
    }
    __syncwarp();
    if (lane == 0) bar_arrive(empty + 8 * st);  // this warp is done with the stage
  }
}

// Calls f(r, c, v0, v1) for each pair of adjacent sums of this warp's
// tiles: row r, columns c and c + 1 of the pass (every lane at once, so f may
// shuffle within a quad).
template <int MT, class F>
__device__ __forceinline__ void for_pairs(const WarpTile& wt, float (&acc)[MT][2][4], F f) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (!((wt.tiles >> m) & 1u)) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = 16 * m + (lane >> 2), c = wt.col + 8 * j + 2 * (lane & 3);
      f(r, c, acc[m][j][0], acc[m][j][1]);
      f(r + 8, c, acc[m][j][2], acc[m][j][3]);
    }
  }
}

// Every pass of product g of the design's plan; epi(pass, r, c, v0, v1)
// receives the pass's columns c and c + 1 of row r.
template <class Plan, int MT, int PLANES, class Epi>
__device__ void gemm(const Params& p, const Split& s, int g, const bf16* A, int lda, int plane,
                     const unsigned char* ring, uint32_t full, uint32_t empty, int& slice,
                     Epi epi) {
  Pass ps;
  for (int i = 0; Plan::pass_of(p, s, g, i, ps); ++i) {
    const WarpTile wt = warp_tile<MT>(ps.width);
    float acc[MT][2][4];
    mma_pass<MT, PLANES>(A, lda, plane, ps, wt, ring, full, empty, slice, true, acc);
    for_pairs<MT>(wt, acc, [&](int r, int c, float a, float b) { epi(ps, r, c, a, b); });
  }
}

// Pass i of the D-wide products g (0 qkv: the own columns of each of q, k,
// v; 1 wo, 2 wqc, 3 woc: the own columns) for this CTA; false past the last.
__device__ bool d_wide_pass(const Params& p, const Split& s, int g, int i, Pass& ps) {
  const int per_d = (s.Dc + PASS_N - 1) / PASS_N;  // passes over Dc columns
  if (i >= (g == 0 ? 3 : 1) * per_d) return false;
  const int third = g == 0 ? i / per_d : 0, j0 = (i % per_d) * PASS_N;
  const int width = min(PASS_N, s.Dc - j0);
  const bf16* b = g == 0 ? p.bqkv : g == 1 ? p.bo : g == 2 ? p.bqc : p.boc;
  ps = Pass{b, 0, p.D, third * p.D + s.rank * s.Dc + j0, width, third * s.Dc + j0, s.rank, g,
            stage_rows(width)};
  return true;
}

__device__ __forceinline__ void store2(bf16* at, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(at) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float bias_at(const Pass& ps, int c) {
  return __bfloat162float(ps.bias[ps.col + c]);
}

// the residual sum in f32: xs + (product + bias), as the JAX kernels add
struct Residual {
  float* xs;
  int Dc, rows;
  __device__ void operator()(const Pass& ps, int r, int c, float a, float b) const {
    if (r >= rows) return;
    float* at = xs + r * Dc + ps.own + c;
    at[0] = at[0] + (a + bias_at(ps, c));
    at[1] = at[1] + (b + bias_at(ps, c + 1));
  }
};

// v = hi + mid + lo: three bf16 terms of an f32 value (exact for all but the
// tiniest magnitudes)
__device__ __forceinline__ void split3(float v, bf16& hi, bf16& mid, bf16& lo) {
  hi = __float2bfloat16_rn(v);
  const float r = v - __bfloat162float(hi);
  mid = __float2bfloat16_rn(r);
  lo = __float2bfloat16_rn(r - __bfloat162float(mid));
}

// LayerNorm of the cluster's rows (the JAX _ln over all D columns) when
// each CTA holds its own columns of xs: row sums and squared deviations are
// added over the cluster through `ln`.  The result goes back into xs and
// into every CTA's A operand (own columns): rounded to bf16 (one plane), or
// as its three bf16 terms (THREE: planes `plane` elements apart); or, for
// the last one, to y in device memory, zeroed where is_pad (if given) marks
// the input token <pad>.  One warp per row, after a barrier of the CTA's
// consumers: a row's columns of xs come from every warp's epilogue.
template <bool THREE>
__device__ void layer_norm(const Params& p, const Split& s, Exchange& ex, float* xs,
                           bf16* const* xa_all, int plane, float* const* ln_all,
                           const bf16* scale, const bf16* shift, bool last,
                           const uint8_t* is_pad, int row0, int rows, int BM) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int D = p.D, Dc = s.Dc;
  float* sums = ln_all[s.rank];  // [2][C][BM]
  consumer_sync();  // every warp's columns of xs are written
  for (int r = warp; r < rows; r += CWARPS) {
    float part = 0.f;
    for (int c = lane; c < Dc; c += 32) part += xs[r * Dc + c];
    part = warp_sum(part);
    if (lane < s.C) ln_all[lane][s.rank * BM + r] = part;
  }
  ex.step(s);
  for (int r = warp; r < rows; r += CWARPS) {
    float total = 0.f;
    for (int q = 0; q < s.C; ++q) total += sums[q * BM + r];
    const float mean = total / D;
    float part = 0.f;
    for (int c = lane; c < Dc; c += 32) {
      const float v = xs[r * Dc + c] - mean;
      part += v * v;
    }
    part = warp_sum(part);
    if (lane < s.C) ln_all[lane][(s.C + s.rank) * BM + r] = part;
  }
  ex.step(s);
  for (int r = warp; r < rows; r += CWARPS) {
    float total = 0.f, sq = 0.f;
    for (int q = 0; q < s.C; ++q) {
      total += sums[q * BM + r];
      sq += sums[(s.C + q) * BM + r];
    }
    const float mean = total / D;
    const float inv = 1.f / sqrtf(sq / D + LN_EPS);
    const int n = row0 + r;
    const float keep = last && is_pad != nullptr ? 1.f - (float)is_pad[n] : 1.f;
    for (int c = lane; c < Dc; c += 32) {
      const int col = s.rank * Dc + c;
      const float o = (xs[r * Dc + c] - mean) * inv * __bfloat162float(scale[col]) +
                      __bfloat162float(shift[col]);
      if (last) {
        p.y[(size_t)n * D + col] = __float2bfloat16_rn(o * keep);
      } else {
        xs[r * Dc + c] = o;
        bf16 t3[3];
        if (THREE) {
          split3(o, t3[0], t3[1], t3[2]);
        } else {
          t3[0] = __float2bfloat16_rn(o);
        }
        for (int q = 0; q < s.C; ++q) {
#pragma unroll
          for (int k = 0; k < (THREE ? 3 : 1); ++k) {
            xa_all[q][k * plane + r * (D + 8) + col] = t3[k];
          }
        }
      }
    }
  }
}

// Bytes from the start of shared memory to the ring's 1024-byte aligned
// start (the 128-byte swizzle repeats every 1024 bytes).
__device__ __forceinline__ int ring_align(const unsigned char* smem) {
  return (int)((1024u - (hopper::smem_addr(smem) & 1023u)) & 1023u);
}

// The kernel of either design: barriers, the cluster, then the producer
// warp and the consumers' part.  MT 16-row MMA tiles per cluster tile.
template <class Design, int MT>
__global__ void __launch_bounds__(THREADS, 1) step_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = p.cluster;
  const Split s{C, C > 1 ? (int)cluster_rank() : 0, p.D / C, p.h / C, p.F / C};
  const typename Design::Layout lay = Design::layout(16 * MT, C, p.D, p.F, p.L, p.M);
  const uint32_t base = hopper::smem_addr(smem);
  const uint32_t full = base + lay.bars, empty = full + 8 * STAGES, xbars = empty + 8 * STAGES;
  const int row0 = (blockIdx.x / C) * p.rows;  // the cluster's tile of rows
  const int rows = max(0, min(p.rows, p.N - row0));

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      bar_init(full + 8 * i, 1);
      bar_init(empty + 8 * i, CWARPS);
    }
    bar_init(xbars, C * CWARPS);
    bar_init(xbars + 8, C * CWARPS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (C > 1) cluster_sync(); else __syncthreads();  // the peer's barriers exist before use

  if (threadIdx.x >= CTHREADS) {
    produce<Design>(p, s, base + lay.ring + ring_align(smem), full, empty);
  } else {
    Design::template consume<MT>(p, s, smem, lay, full, empty, xbars, row0, rows);
  }
  // no CTA leaves while its peer may still write into its shared memory
  if (C > 1) cluster_sync();
}

// ======================================================== resident:: step
namespace resident {

// sum over 8 elements of bf16(k * q): the product of two bf16 values is exact
// in f32, so the bf16 multiply rounds exactly as bf16(f32(k) * f32(q)) does
__device__ __forceinline__ float dot8_bf16(const uint4& k, const uint4& q) {
  const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&k);
  const __nv_bfloat162* q2 = reinterpret_cast<const __nv_bfloat162*>(&q);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(__hmul2(k2[i], q2[i]));
    s += f.x;
    s += f.y;
  }
  return s;
}

// Byte offsets of the dynamic shared memory of a CTA of BM rows.
struct Layout {
  int ring, xs, xa, work, recv, sc, src, ln, bars, total;
};

// (M does not enter: the attention streams the encoder rows in chunks)
__host__ __device__ inline Layout layout(int BM, int C, int D, int F, int L, int) {
  const int Dc = D / C, Fc = F / C;
  const int qkv = BM * Dc * (2 + 2 + 4), hidden = BM * (Fc + 8) * 2;
  Layout l;
  l.ring = 0;                                            // STAGES stages, 1024-byte aligned
  l.xs = l.ring + STAGES * STAGE_BYTES + 1024;           // BM x Dc f32: own residual columns
  l.xa = l.xs + BM * Dc * 4;                             // BM x (D + 8) bf16: A operand, all columns
  l.work = l.xa + align16(BM * (D + 8) * 2);             // own q, k (bf16), v (f32); or own hidden
  l.recv = l.work + align16(qkv > hidden ? qkv : hidden);  // BM x Dc f32: the peer's partial sums
  l.sc = l.recv + (C > 1 ? BM * Dc * 4 : 0);             // CWARPS x ATT_CHUNK f32
  l.src = l.sc + CWARPS * ATT_CHUNK * 4;                 // BM x L int
  l.ln = l.src + align16(BM * L * 4);                    // 2 x C x BM f32: LayerNorm partial sums
  l.bars = l.ln + 2 * C * BM * 4;                        // full, empty (STAGES each), 2 exchange
  l.total = l.bars + (2 * STAGES + 2) * 8;
  return l;
}

// The weights' passes in stream order: the four D-wide products, then w1
// (this CTA's Fc hidden columns) and w2 (its Fc rows, every column: the
// other CTAs' columns first, this one's last).
struct Plan {
  static constexpr int GROUPS = 6;
  __device__ static bool pass_of(const Params& p, const Split& s, int g, int i, Pass& ps) {
    if (g < 4) return d_wide_pass(p, s, g, i, ps);
    const int per_d = (s.Dc + PASS_N - 1) / PASS_N;
    if (g == 4) {
      const int j0 = i * PASS_N;
      if (j0 >= s.Fc) return false;
      const int width = min(PASS_N, s.Fc - j0);
      ps = Pass{p.b1, 0, p.D, s.rank * s.Fc + j0, width, j0, s.rank, 4, stage_rows(width)};
      return true;
    }
    if (i >= s.C * per_d) return false;
    const int owner = (s.rank + 1 + i / per_d) % s.C;
    const int j0 = (i % per_d) * PASS_N, width = min(PASS_N, s.Dc - j0);
    ps = Pass{p.b2, s.rank * s.Fc, s.Fc, owner * s.Dc + j0, width, j0, owner, 5,
              stage_rows(width)};
    return true;
  }
};

// q * scale and k_new rounded to bf16, v_new in f32 (the JAX kernel's uses)
struct QKV {
  bf16 *q, *k;
  float* v;
  int Dc, rows;
  float scale;
  __device__ void operator()(const Pass& ps, int r, int c, float a, float b) const {
    if (r >= rows) return;
    a += bias_at(ps, c);
    b += bias_at(ps, c + 1);
    const int o = ps.own + c, third = o / Dc, j = o - third * Dc;
    if (third == 0) {
      store2(q + r * Dc + j, a * scale, b * scale);
    } else if (third == 1) {
      store2(k + r * Dc + j, a, b);
    } else {
      v[r * Dc + j] = a;
      v[r * Dc + j + 1] = b;
    }
  }
};

// the cross-attention query: (x Wqc + b) * scale rounded to bf16
struct Query {
  bf16* q;
  int Dc, rows;
  float scale;
  __device__ void operator()(const Pass& ps, int r, int c, float a, float b) const {
    if (r >= rows) return;
    store2(q + r * Dc + ps.own + c, (a + bias_at(ps, c)) * scale, (b + bias_at(ps, c + 1)) * scale);
  }
};

// the FFN hidden layer relu(x W1 + b1), rounded to bf16 for the next product
struct Hidden {
  bf16* h;
  int ld;
  __device__ void operator()(const Pass& ps, int r, int c, float a, float b) const {
    store2(h + r * ld + ps.own + c, fmaxf(a + bias_at(ps, c), 0.f),
           fmaxf(b + bias_at(ps, c + 1), 0.f));
  }
};

// The FFN's second product over this CTA's share of the depth (the hidden
// columns it owns): the partial sums of the other CTAs' columns go into
// their `recv`; this CTA's own stay in `own` (the last pass).
template <int MT>
__device__ void gemm_split(const Params& p, const Split& s, const bf16* A, int lda,
                           const unsigned char* ring, uint32_t full, uint32_t empty, int& slice,
                           float* const* recv_all, int rows, float (&own)[MT][2][4]) {
  Pass ps;
  for (int i = 0; Plan::pass_of(p, s, 5, i, ps); ++i) {
    const WarpTile wt = warp_tile<MT>(ps.width);
    mma_pass<MT, 1>(A, lda, 0, ps, wt, ring, full, empty, slice, true, own);
    if (ps.owner == s.rank) continue;
    float* recv = recv_all[ps.owner];
    for_pairs<MT>(wt, own, [&](int r, int c, float a, float b) {
      if (r < rows) *reinterpret_cast<float2*>(recv + r * s.Dc + ps.own + c) = make_float2(a, b);
    });
  }
}

// Attention of this CTA's heads for every row of the cluster's tile, one
// warp per (row, head), into every CTA's xa (the next product's A operand,
// rounded to bf16 as the JAX _mm rounds it).  q (BM, Dc) bf16: q * scale,
// rounded, own heads.  Self-attention: kn (BM, Dc) bf16 and vn (BM, Dc) f32
// are this step's K/V, own heads; src (BM, L) the cache row of each
// position, ~row where the position is masked.  Cross-attention: the
// image's row of the cross mask (1 where the region is masked), read from
// device memory.  d/8 lanes hold one position's 8 elements (one 16-byte
// load); a warp issues the K loads of up to 8 rounds of positions before it
// reduces a score, then the V loads of a batch.  The positions pass through
// the warp's ATT_CHUNK scores (see the design note at the top): where they
// take more than one chunk, a first pass over the chunks finds the final
// max, and the second takes each chunk's scores again; the weights are
// exp(s - final max) rounded to bf16 either way, as the JAX kernel's two
// passes make them, and each lane sums its positions in one order.
template <bool SELF>
__device__ void attention(const Params& p, const Split& s, const bf16* q, const bf16* kn,
                          const float* vn, const int* src, float* scratch,
                          bf16* const* xa_all, int row0, int rows) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int D = p.D, d = D / p.h, Dc = s.Dc;
  const int G = d / 8;   // lanes per position (a power of two <= 32)
  const int P = 32 / G;  // positions per round
  const int grp = lane / G;
  const int c = (lane % G) * 8;
  const int S = SELF ? p.L : p.M;
  const bool chunked = S > ATT_CHUNK;
  float* sc = scratch + warp * ATT_CHUNK;
  const bf16* kbase = SELF ? p.k_cache : p.cross_k;
  const bf16* vbase = SELF ? p.v_cache : p.cross_v;
  const uint64_t stream = evict_first_policy();  // the caches pass through L2 once

  for (int pr = warp; pr < rows * s.hc; pr += CWARPS) {
    const int r = pr / s.hc, lh = pr - r * s.hc;
    const int head = s.rank * s.hc + lh;
    const int n = row0 + r;
    const int img = n / p.beam;
    const int hoff = head * d + c;  // in the caches and in xa
    const int loff = r * Dc + lh * d + c;  // in this CTA's own q, k, v
    const uint4 qv = *reinterpret_cast<const uint4*>(q + loff);
    const uint8_t* cmask = SELF ? nullptr : p.cmask + (size_t)img * p.M;
    // the cache (or cross) row of position j, and whether j is masked
    auto row_of = [&](int j) -> int {
      if (SELF) {
        const int code = src[r * p.L + j];
        return code < 0 ? ~code : code;
      }
      return img;
    };
    auto dead_at = [&](int j) -> bool { return SELF ? src[r * p.L + j] < 0 : cmask[j] != 0; };

    // this step's column (self-attention), from the unrounded qkv
    float s_new = NEG;
    if (SELF) {
      float part = dot8_bf16(*reinterpret_cast<const uint4*>(kn + loff), qv);
      for (int o = G / 2; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
      s_new = p.is_pad[n] ? part + NEG : part;
    }

    // the scores of positions cb .. cb + len - 1 into sc[0 .. len): a
    // batch's K loads are all issued before the first reduction
    auto scores = [&](int cb, int len) {
      for (int j0 = 0; j0 < len; j0 += P * R) {
        uint4 raw[R];
        bool live[R];
#pragma unroll
        for (int u = 0; u < R; ++u) {
          const int j = j0 + u * P + grp;
          live[u] = j < len && !dead_at(cb + j);
          raw[u] = live[u]
                       ? load_stream(kbase + ((size_t)row_of(cb + j) * S + cb + j) * D + hoff, stream)
                       : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < R; ++u) {
          float part = dot8_bf16(raw[u], qv);
          for (int o = G / 2; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
          const int j = j0 + u * P + grp;
          if (j < len && lane % G == 0) sc[j] = live[u] ? part : NEG;
        }
      }
      __syncwarp();
    };

    // the final max first where the positions take more than one chunk
    float m = s_new;
    if (chunked) {
      for (int cb = 0; cb < S; cb += ATT_CHUNK) {
        const int len = min(ATT_CHUNK, S - cb);
        scores(cb, len);
        for (int j = lane; j < len; j += 32) m = fmaxf(m, sc[j]);
        __syncwarp();  // the next chunk overwrites the scores
      }
    }

    // exp(s - m) with the final max (two passes, as the JAX kernel), the
    // weights rounded to bf16, into PV chunk by chunk
    float part = 0.f;
    float acc[8];
    float vv[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = 0.f;
    for (int cb = 0; cb < S; cb += ATT_CHUNK) {
      const int len = min(ATT_CHUNK, S - cb);
      scores(cb, len);
      if (cb == 0) {
        for (int j = lane; j < len; j += 32) m = fmaxf(m, sc[j]);
        m = warp_max(m);
        if (SELF && grp == 0) {  // this step's column (unrounded v_new) first
          const float w = round_bf16(expf(s_new - m));
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[e] = w * vn[loff + e];
        }
      }
      for (int j = lane; j < len; j += 32) {
        const float e = expf(sc[j] - m);
        sc[j] = e;
        part += e;
      }
      __syncwarp();
      for (int j0 = 0; j0 < len; j0 += P * R) {
        uint4 raw[R];
        float w[R];
#pragma unroll
        for (int u = 0; u < R; ++u) {
          const int j = j0 + u * P + grp;
          w[u] = j < len ? round_bf16(sc[j]) : 0.f;
          raw[u] = w[u] != 0.f
                       ? load_stream(vbase + ((size_t)row_of(cb + j) * S + cb + j) * D + hoff, stream)
                       : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < R; ++u) {
          unpack8(raw[u], vv);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[e] += w[u] * vv[e];
        }
      }
      __syncwarp();  // the next chunk (or pair) overwrites the scores
    }
    const float e_new = SELF ? expf(s_new - m) : 0.f;
    const float denom = e_new + warp_sum(part);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      for (int o = G; o < 32; o <<= 1) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
    }
    if (grp == 0) {
      alignas(16) bf16 out[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) out[e] = __float2bfloat16_rn(acc[e] / denom);
      for (int t = 0; t < s.C; ++t) {
        *reinterpret_cast<uint4*>(xa_all[t] + r * (D + 8) + hoff) =
            *reinterpret_cast<const uint4*>(out);
      }
    }
  }
}

struct Design : Plan {
  using Layout = resident::Layout;
  __host__ __device__ static Layout layout(int BM, int C, int D, int F, int L, int M) {
    return resident::layout(BM, C, D, F, L, M);
  }

  template <int MT>
  __device__ static void consume(const Params& p, const Split& s, unsigned char* smem,
                                 const Layout& lay, uint32_t full, uint32_t empty, uint32_t xbars,
                                 int row0, int rows) {
    constexpr int BM = 16 * MT;
    const int D = p.D, L = p.L, Dc = s.Dc, Fc = s.Fc;
    const int tid = threadIdx.x;
    namespace cg = cooperative_groups;
    const cg::cluster_group cluster = cg::this_cluster();
    const unsigned char* ring = smem + lay.ring + ring_align(smem);
    float* xs = reinterpret_cast<float*>(smem + lay.xs);
    bf16* xa = reinterpret_cast<bf16*>(smem + lay.xa);
    bf16* hid = reinterpret_cast<bf16*>(smem + lay.work);  // (BM, Fc + 8), or:
    bf16* qo = hid;                                        // (BM, Dc) own q
    bf16* ko = qo + BM * Dc;                               // (BM, Dc) own k_new
    float* vo = reinterpret_cast<float*>(ko + BM * Dc);    // (BM, Dc) own v_new
    float* scratch = reinterpret_cast<float*>(smem + lay.sc);
    int* src = reinterpret_cast<int*>(smem + lay.src);
    bf16* xa_all[MAX_CLUSTER];
    float* recv_all[MAX_CLUSTER];
    float* ln_all[MAX_CLUSTER];
    for (int t = 0; t < s.C; ++t) {
      xa_all[t] = s.C > 1 ? cluster.map_shared_rank(xa, t) : xa;
      recv_all[t] = s.C > 1 ? cluster.map_shared_rank(reinterpret_cast<float*>(smem + lay.recv), t)
                            : nullptr;
      ln_all[t] = s.C > 1 ? cluster.map_shared_rank(reinterpret_cast<float*>(smem + lay.ln), t)
                          : reinterpret_cast<float*>(smem + lay.ln);
    }
    Exchange ex{xbars, 0};
    phase_mark(0);

    // x: all columns rounded (the A operand), own columns in f32 (the
    // residual), zero past the tile's rows; the source row of every self
    // position with its mask folded in
    for (int e = tid; e < BM * D; e += CTHREADS) {
      const int r = e / D, c = e - (e / D) * D;
      const float v = r < rows ? __bfloat162float(p.x[(size_t)(row0 + r) * D + c]) : 0.f;
      xa[r * (D + 8) + c] = __float2bfloat16_rn(v);
      const int j = c - s.rank * Dc;
      if (j >= 0 && j < Dc) xs[r * Dc + j] = v;
    }
    for (int e = tid; e < rows * L; e += CTHREADS) {
      const int r = e / L, j = e - (e / L) * L;
      const int n = row0 + r;
      const int from = (n / p.beam) * p.beam + (int)p.anc[(size_t)n * L + j];
      const bool dead = j == p.t || p.smask[(size_t)from * L + j] != 0;  // column t is stale
      src[e] = dead ? ~from : from;
    }
    consumer_sync();
    phase_mark(1);  // inputs staged

    int slice = 0;
    gemm<Plan, MT, 1>(p, s, 0, xa, D + 8, 0, ring, full, empty, slice,
                      QKV{qo, ko, vo, Dc, rows, p.scale});
    ex.step(s);  // every CTA is done with x as an operand before attention overwrites xa
    phase_mark(2);  // qkv product
    for (int e = tid; e < rows * (Dc / 8); e += CTHREADS) {  // this step's K/V rows out
      const int r = e / (Dc / 8), c = (e - r * (Dc / 8)) * 8;
      const size_t at = (size_t)(row0 + r) * D + s.rank * Dc + c;
      *reinterpret_cast<uint4*>(p.out_k + at) = *reinterpret_cast<const uint4*>(ko + r * Dc + c);
      alignas(16) bf16 v8[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) v8[i] = __float2bfloat16_rn(vo[r * Dc + c + i]);
      *reinterpret_cast<uint4*>(p.out_v + at) = *reinterpret_cast<const uint4*>(v8);
    }
    attention<true>(p, s, qo, ko, vo, src, scratch, xa_all, row0, rows);
    ex.step(s);
    phase_mark(3);  // self-attention
    gemm<Plan, MT, 1>(p, s, 1, xa, D + 8, 0, ring, full, empty, slice, Residual{xs, Dc, rows});
    layer_norm<false>(p, s, ex, xs, xa_all, 0, ln_all, p.ln[0], p.ln[1], false, nullptr, row0,
                      rows, BM);
    ex.step(s);
    phase_mark(4);  // wo product + LN1

    gemm<Plan, MT, 1>(p, s, 2, xa, D + 8, 0, ring, full, empty, slice,
                      Query{qo, Dc, rows, p.scale});
    ex.step(s);
    phase_mark(5);  // wqc product
    attention<false>(p, s, qo, nullptr, nullptr, src, scratch, xa_all, row0, rows);
    ex.step(s);
    phase_mark(6);  // cross-attention
    gemm<Plan, MT, 1>(p, s, 3, xa, D + 8, 0, ring, full, empty, slice, Residual{xs, Dc, rows});
    layer_norm<false>(p, s, ex, xs, xa_all, 0, ln_all, p.ln[2], p.ln[3], false, nullptr, row0,
                      rows, BM);
    ex.step(s);
    phase_mark(7);  // woc product + LN2

    gemm<Plan, MT, 1>(p, s, 4, xa, D + 8, 0, ring, full, empty, slice, Hidden{hid, Fc + 8});
    consumer_sync();
    phase_mark(8);  // w1 product
    if (s.C == 1) {
      gemm<Plan, MT, 1>(p, s, 5, hid, Fc + 8, 0, ring, full, empty, slice,
                        Residual{xs, Dc, rows});
    } else {
      // each CTA sums its share of the depth; Dc <= PASS_N, so its own
      // columns are one pass, the last, whose sums stay in registers
      float own[MT][2][4];
      gemm_split<MT>(p, s, hid, Fc + 8, ring, full, empty, slice, recv_all, rows, own);
      ex.step(s);  // the other CTAs' partial sums of this CTA's columns have arrived
      const float* recv = reinterpret_cast<const float*>(smem + lay.recv);
      for_pairs<MT>(warp_tile<MT>(Dc), own, [&](int r, int c, float a, float b) {
        if (r >= rows) return;
        const float sum[2] = {a + recv[r * Dc + c], b + recv[r * Dc + c + 1]};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          xs[r * Dc + c + e] =
              xs[r * Dc + c + e] + (sum[e] + __bfloat162float(p.b2[s.rank * Dc + c + e]));
        }
      });
    }
    phase_mark(9);  // w2 product and the cluster's sum
    layer_norm<false>(p, s, ex, xs, xa_all, 0, ln_all, p.ln[4], p.ln[5], true, p.is_pad, row0,
                      rows, BM);
    phase_mark(10);  // LN3
  }
};

}  // namespace resident

// =========================================================== fused:: step
namespace fused {

// Byte offsets of the dynamic shared memory of a CTA of BM rows.
struct Layout {
  int ring, xa, xs, work, parts, sc, smask, ln, bars, total;
};

// (M does not enter: the attention streams the encoder rows in chunks)
__host__ __device__ inline Layout layout(int BM, int C, int D, int F, int L, int) {
  const int Dc = D / C;
  const int own = BM * Dc * 4, chunk = 3 * BM * (FFN_CHUNK + 8) * 2;
  Layout l;
  l.ring = 0;                                       // STAGES stages, 1024-byte aligned
  l.xa = l.ring + STAGES * STAGE_BYTES + 1024;      // 3 x BM x (D + 8) bf16: the A operand's
                                                    // planes, all columns; at the end the
                                                    // peers' FFN partial sums, BM x Dc f32
  l.xs = l.xa + align16(3 * BM * (D + 8) * 2);      // BM x Dc f32: own q; then own residual
  l.work = l.xs + own;                              // own v_new f32; own q2 f32; hidden chunk
  l.parts = l.work + align16(own > chunk ? own : chunk);  // BM x Dc/8 f32: q . k_new by 8 columns
  l.sc = l.parts + BM * (Dc / 8) * 4;               // CWARPS x ATT_CHUNK f32
  l.smask = l.sc + CWARPS * ATT_CHUNK * 4;          // BM x L bytes
  l.ln = l.smask + align16(BM * L);                 // 2 x C x BM f32: LayerNorm partial sums
  l.bars = l.ln + 2 * C * BM * 4;                   // full, empty (STAGES each), 2 exchange
  l.total = l.bars + (2 * STAGES + 2) * 8;
  return l;
}

// The weights' passes in stream order: the four D-wide products, then the
// FFN by chunks of FFN_CHUNK hidden columns of this CTA's Fc: the chunk's
// w1 columns, then the chunk's w2 rows over every column in passes of up to
// PASS_N.
struct Plan {
  static constexpr int GROUPS = 5;
  __device__ static bool pass_of(const Params& p, const Split& s, int g, int i, Pass& ps) {
    if (g < 4) return d_wide_pass(p, s, g, i, ps);
    const int npd = (p.D + PASS_N - 1) / PASS_N;
    const int c0 = (i / (1 + npd)) * FFN_CHUNK, sub = i % (1 + npd);
    if (c0 >= s.Fc) return false;
    const int cw = min(FFN_CHUNK, s.Fc - c0);
    if (sub == 0) {
      ps = Pass{p.b1, 0, p.D, s.rank * s.Fc + c0, cw, 0, s.rank, 4, stage_rows(cw)};
    } else {
      const int j0 = (sub - 1) * PASS_N, width = min(PASS_N, p.D - j0);
      ps = Pass{p.b2, s.rank * s.Fc + c0, cw, j0, width, j0, -1, 5, stage_rows(width)};
    }
    return true;
  }
};

// q and v_new in f32 (own columns; q unscaled, as the JAX kernel scales the
// scores); k_new and v_new rounded into row t of the caches; and q . k_new
// summed over each 8 columns (a quad's columns) for the score at t.
struct QKV {
  float *q, *v, *parts;
  bf16 *kc, *vc;
  int Dc, rows, row0, D, L, t, rank;
  __device__ void operator()(const Pass& ps, int r, int c, float a, float b) const {
    a += bias_at(ps, c);
    b += bias_at(ps, c + 1);
    const int o = ps.own + c, third = o / Dc, j = o - third * Dc;
    if (third == 1) {  // q of these columns: this thread wrote it in the q pass
      float dot = r < rows ? q[r * Dc + j] * a + q[r * Dc + j + 1] * b : 0.f;
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      if (r < rows && (threadIdx.x & 3) == 0) parts[r * (Dc / 8) + j / 8] = dot;
    }
    if (r >= rows) return;
    const size_t at = ((size_t)(row0 + r) * L + t) * D + rank * Dc + j;
    if (third == 0) {
      *reinterpret_cast<float2*>(q + r * Dc + j) = make_float2(a, b);
    } else if (third == 1) {
      store2(kc + at, a, b);
    } else {
      *reinterpret_cast<float2*>(v + r * Dc + j) = make_float2(a, b);
      store2(vc + at, a, b);
    }
  }
};

// the first residual sum: x (bf16, read again) + (att Wo + bo), in f32
struct ResidualX {
  float* xs;
  const bf16* x;
  int Dc, rows, row0, D, rank;
  __device__ void operator()(const Pass& ps, int r, int c, float a, float b) const {
    if (r >= rows) return;
    const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
        x + (size_t)(row0 + r) * D + rank * Dc + ps.own + c));
    *reinterpret_cast<float2*>(xs + r * Dc + ps.own + c) =
        make_float2(xv.x + (a + bias_at(ps, c)), xv.y + (b + bias_at(ps, c + 1)));
  }
};

// the cross-attention query x1 Wqc + bqc in f32, unscaled
struct Query {
  float* q;
  int Dc, rows;
  __device__ void operator()(const Pass& ps, int r, int c, float a, float b) const {
    if (r >= rows) return;
    *reinterpret_cast<float2*>(q + r * Dc + ps.own + c) =
        make_float2(a + bias_at(ps, c), b + bias_at(ps, c + 1));
  }
};

// a chunk of the hidden layer, relu(x2 W1 + b1) in f32, as its three bf16
// planes (pitch FFN_CHUNK + 8, `plane` apart)
struct Hidden {
  bf16* h;
  int plane;
  __device__ void operator()(const Pass& ps, int r, int c, float a, float b) const {
    const float v[2] = {fmaxf(a + bias_at(ps, c), 0.f), fmaxf(b + bias_at(ps, c + 1), 0.f)};
    uint32_t t3[3];
    hopper::split3(v[0], v[1], t3[0], t3[1], t3[2]);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      *reinterpret_cast<uint32_t*>(h + k * plane + r * (FFN_CHUNK + 8) + ps.own + c) = t3[k];
    }
  }
};

// Attention of this CTA's heads for every row of the cluster's tile, one
// warp per (row, head), in f32, into the three planes of every CTA's A
// operand.  q (BM, Dc) f32, own heads, unscaled.  Self-attention: position t
// is this step's K/V (its score from `parts`, the q . k_new sums by 8
// columns; v_new from vn (BM, Dc) f32), the others row n's cache rows;
// cross-attention: row n's cross K/V rows.  mask: the tile's first row of
// the mask, (BM, S) 1 = masked (the staged self mask, or the cross mask in
// device memory).  The positions pass through the warp's ATT_CHUNK scores
// in chunks (see the design note at the top): in one chunk the weights are
// normalised before PV, as the JAX kernel does; over several, PV sums
// exp(s - m) and the result is divided once.
template <bool SELF>
__device__ void attention(const Params& p, const Split& s, const float* q, const float* vn,
                          const float* parts, const uint8_t* mask, float* scratch,
                          bf16* const* xa_all, int plane, int row0, int rows) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int D = p.D, d = D / p.h, Dc = s.Dc;
  const int G = d / 8;   // lanes per position (a power of two <= 32)
  const int P = 32 / G;  // positions per round
  const int grp = lane / G;
  const int c = (lane % G) * 8;
  const int S = SELF ? p.L : p.M;
  const int t = SELF ? p.t : -1;
  const bool chunked = S > ATT_CHUNK;
  float* sc = scratch + warp * ATT_CHUNK;
  const bf16* kbase = SELF ? p.k_cache : p.cross_k;
  const bf16* vbase = SELF ? p.v_cache : p.cross_v;
  const uint64_t stream = evict_first_policy();  // the caches pass through L2 once

  for (int pr = warp; pr < rows * s.hc; pr += CWARPS) {
    const int r = pr / s.hc, lh = pr - r * s.hc;
    const int head = s.rank * s.hc + lh;
    const size_t base = (size_t)(row0 + r) * S;  // row n's first cache (or cross) row
    const int hoff = head * d + c;                // in the caches and in xa
    const int loff = r * Dc + lh * d + c;         // in this CTA's own q, v
    const uint8_t* mrow = mask + (size_t)r * S;
    float qv[8];
    const float4 q0 = *reinterpret_cast<const float4*>(q + loff);
    const float4 q1 = *reinterpret_cast<const float4*>(q + loff + 4);
    qv[0] = q0.x; qv[1] = q0.y; qv[2] = q0.z; qv[3] = q0.w;
    qv[4] = q1.x; qv[5] = q1.y; qv[6] = q1.z; qv[7] = q1.w;

    float s_t = NEG;  // the score at t, from this step's unrounded k
    if (SELF) {
      float dot = 0.f;
      for (int i = 0; i < d / 8; ++i) dot += parts[r * (Dc / 8) + lh * (d / 8) + i];
      s_t = mrow[t] ? NEG : dot * p.scale;
    }

    // the scores of positions cb .. cb + len - 1 into sc[0 .. len): a
    // batch's K loads are all issued before the first reduction
    auto scores = [&](int cb, int len) {
      for (int j0 = 0; j0 < len; j0 += P * R) {
        uint4 raw[R];
        bool live[R];
#pragma unroll
        for (int u = 0; u < R; ++u) {
          const int j = j0 + u * P + grp, a = cb + j;
          live[u] = j < len && a != t && mrow[a] == 0;
          raw[u] = live[u] ? load_stream(kbase + (base + a) * D + hoff, stream)
                           : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < R; ++u) {
          float kv[8];
          unpack8(raw[u], kv);
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) part += kv[e] * qv[e];
          for (int o = G / 2; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
          const int j = j0 + u * P + grp;
          if (j < len && lane % G == 0) {
            sc[j] = cb + j == t ? s_t : live[u] ? part * p.scale : NEG;
          }
        }
      }
      __syncwarp();
    };

    // the final max first where the positions take more than one chunk
    float m = -CUDART_INF_F;
    if (chunked) {
      for (int cb = 0; cb < S; cb += ATT_CHUNK) {
        const int len = min(ATT_CHUNK, S - cb);
        scores(cb, len);
        for (int j = lane; j < len; j += 32) m = fmaxf(m, sc[j]);
        __syncwarp();  // the next chunk overwrites the scores
      }
    }

    // softmax with the final max and the 1e-30 guard, as the JAX kernel
    float part = 0.f, denom = 1.f;
    float acc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = 0.f;
    for (int cb = 0; cb < S; cb += ATT_CHUNK) {
      const int len = min(ATT_CHUNK, S - cb);
      scores(cb, len);
      if (cb == 0) {
        for (int j = lane; j < len; j += 32) m = fmaxf(m, sc[j]);
        m = warp_max(m);
      }
      for (int j = lane; j < len; j += 32) {
        const float e = expf(sc[j] - m);
        sc[j] = e;
        part += e;
      }
      if (!chunked) denom = fmaxf(warp_sum(part), 1e-30f);
      __syncwarp();
      for (int j0 = 0; j0 < len; j0 += P * R) {
        uint4 raw[R];
        float w[R];
#pragma unroll
        for (int u = 0; u < R; ++u) {
          const int j = j0 + u * P + grp, a = cb + j;
          w[u] = j < len ? sc[j] / denom : 0.f;
          raw[u] = w[u] != 0.f && a != t ? load_stream(vbase + (base + a) * D + hoff, stream)
                                         : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < R; ++u) {
          float vv[8];
          if (SELF && cb + j0 + u * P + grp == t) {
#pragma unroll
            for (int e = 0; e < 8; ++e) vv[e] = vn[loff + e];
          } else {
            unpack8(raw[u], vv);
          }
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[e] += w[u] * vv[e];
        }
      }
      __syncwarp();  // the next chunk (or pair) overwrites the scores
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      for (int o = G; o < 32; o <<= 1) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
    }
    if (chunked) {
      denom = fmaxf(warp_sum(part), 1e-30f);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = acc[e] / denom;
    }
    if (grp == 0) {
      uint32_t t3[3][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hopper::split3(acc[2 * e], acc[2 * e + 1], t3[0][e], t3[1][e], t3[2][e]);
      }
      for (int cta = 0; cta < s.C; ++cta) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          *reinterpret_cast<uint4*>(xa_all[cta] + k * plane + r * (D + 8) + hoff) =
              make_uint4(t3[k][0], t3[k][1], t3[k][2], t3[k][3]);
        }
      }
    }
  }
}

struct Design : Plan {
  using Layout = fused::Layout;
  __host__ __device__ static Layout layout(int BM, int C, int D, int F, int L, int M) {
    return fused::layout(BM, C, D, F, L, M);
  }

  template <int MT>
  __device__ static void consume(const Params& p, const Split& s, unsigned char* smem,
                                 const Layout& lay, uint32_t full, uint32_t empty, uint32_t xbars,
                                 int row0, int rows) {
    constexpr int BM = 16 * MT;
    const int D = p.D, L = p.L, M = p.M, Dc = s.Dc;
    const int plane = BM * (D + 8), hplane = BM * (FFN_CHUNK + 8);
    const int tid = threadIdx.x;
    namespace cg = cooperative_groups;
    const cg::cluster_group cluster = cg::this_cluster();
    const unsigned char* ring = smem + lay.ring + ring_align(smem);
    bf16* xa = reinterpret_cast<bf16*>(smem + lay.xa);
    float* xs = reinterpret_cast<float*>(smem + lay.xs);  // own q first
    float* work = reinterpret_cast<float*>(smem + lay.work);
    bf16* hid = reinterpret_cast<bf16*>(smem + lay.work);
    float* parts = reinterpret_cast<float*>(smem + lay.parts);
    float* scratch = reinterpret_cast<float*>(smem + lay.sc);
    uint8_t* smask = smem + lay.smask;
    bf16* xa_all[MAX_CLUSTER];
    float* ln_all[MAX_CLUSTER];
    for (int t = 0; t < s.C; ++t) {
      xa_all[t] = s.C > 1 ? cluster.map_shared_rank(xa, t) : xa;
      ln_all[t] = s.C > 1 ? cluster.map_shared_rank(reinterpret_cast<float*>(smem + lay.ln), t)
                          : reinterpret_cast<float*>(smem + lay.ln);
    }
    Exchange ex{xbars, 0};
    phase_mark(0);

    // x (bf16, so one plane is exact) zero past the tile's rows; the self mask
    for (int e = tid; e < BM * (D / 8); e += CTHREADS) {
      const int r = e / (D / 8), c = (e - r * (D / 8)) * 8;
      *reinterpret_cast<uint4*>(xa + r * (D + 8) + c) =
          r < rows ? *reinterpret_cast<const uint4*>(p.x + (size_t)(row0 + r) * D + c)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
    for (int e = tid; e < rows * L; e += CTHREADS) smask[e] = p.smask[(size_t)row0 * L + e];
    consumer_sync();
    phase_mark(1);  // inputs staged

    int slice = 0;
    gemm<Plan, MT, 1>(p, s, 0, xa, D + 8, plane, ring, full, empty, slice,
                      QKV{xs, work, parts, p.out_k, p.out_v, Dc, rows, row0, D, L, p.t, s.rank});
    ex.step(s);  // every CTA is done with x as an operand before attention overwrites xa
    phase_mark(2);  // qkv product
    attention<true>(p, s, xs, work, parts, smask, scratch, xa_all, plane, row0, rows);
    ex.step(s);
    phase_mark(3);  // self-attention
    gemm<Plan, MT, 3>(p, s, 1, xa, D + 8, plane, ring, full, empty, slice,
                      ResidualX{xs, p.x, Dc, rows, row0, D, s.rank});
    layer_norm<true>(p, s, ex, xs, xa_all, plane, ln_all, p.ln[0], p.ln[1], false, nullptr,
                     row0, rows, BM);
    ex.step(s);
    phase_mark(4);  // wo product + LN1

    gemm<Plan, MT, 3>(p, s, 2, xa, D + 8, plane, ring, full, empty, slice,
                      Query{work, Dc, rows});
    ex.step(s);
    phase_mark(5);  // wqc product
    attention<false>(p, s, work, nullptr, nullptr, p.cmask + (size_t)row0 * M, scratch, xa_all,
                     plane, row0, rows);
    ex.step(s);
    phase_mark(6);  // cross-attention
    gemm<Plan, MT, 3>(p, s, 3, xa, D + 8, plane, ring, full, empty, slice,
                      Residual{xs, Dc, rows});
    layer_norm<true>(p, s, ex, xs, xa_all, plane, ln_all, p.ln[2], p.ln[3], false, nullptr,
                     row0, rows, BM);
    ex.step(s);
    phase_mark(7);  // woc product + LN2

    // the FFN by chunks: hidden chunk into its planes, then at once its
    // product with the chunk's w2 rows, summed in registers across chunks
    const int npd = (D + PASS_N - 1) / PASS_N;  // <= 2: D <= 512
    float acc2[2][MT][2][4];
    Pass ps;
    for (int i = 0; Plan::pass_of(p, s, 4, i, ps); i += 1 + npd) {
      {
        const WarpTile wt = warp_tile<MT>(ps.width);
        float acc[MT][2][4];
        mma_pass<MT, 3>(xa, D + 8, plane, ps, wt, ring, full, empty, slice, true, acc);
        const Hidden epi{hid, hplane};
        for_pairs<MT>(wt, acc, [&](int r, int c, float a, float b) { epi(ps, r, c, a, b); });
      }
      consumer_sync();  // the chunk's planes are whole
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (q < npd) {
          Plan::pass_of(p, s, 4, i + 1 + q, ps);
          mma_pass<MT, 3>(hid, FFN_CHUNK + 8, hplane, ps, warp_tile<MT>(ps.width), ring, full,
                          empty, slice, i == 0, acc2[q]);
        }
      }
      consumer_sync();  // every warp is done with the chunk's planes
    }
    phase_mark(8);  // FFN products
    // each CTA holds its share of the depth for every column: the other
    // CTAs' columns go into their xa, free now, as (BM, Dc) f32
    if (s.C > 1) {
      ex.step(s);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (q >= npd) continue;
        for_pairs<MT>(warp_tile<MT>(min(PASS_N, D - q * PASS_N)), acc2[q],
                      [&](int r, int c, float a, float b) {
                        const int col = q * PASS_N + c, owner = col / Dc;
                        if (owner == s.rank || r >= rows) return;
                        float* recv = reinterpret_cast<float*>(xa_all[owner]);
                        *reinterpret_cast<float2*>(recv + r * Dc + col - owner * Dc) =
                            make_float2(a, b);
                      });
      }
      ex.step(s);  // the other CTAs' partial sums of this CTA's columns have arrived
    }
    const float* recv = reinterpret_cast<const float*>(xa);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (q >= npd) continue;
      for_pairs<MT>(warp_tile<MT>(min(PASS_N, D - q * PASS_N)), acc2[q],
                    [&](int r, int c, float a, float b) {
                      const int col = q * PASS_N + c, j = col - s.rank * Dc;
                      if (col / Dc != s.rank || r >= rows) return;
                      const float sum[2] = {s.C > 1 ? a + recv[r * Dc + j] : a,
                                            s.C > 1 ? b + recv[r * Dc + j + 1] : b};
#pragma unroll
                      for (int e = 0; e < 2; ++e) {
                        xs[r * Dc + j + e] =
                            xs[r * Dc + j + e] + (sum[e] + __bfloat162float(p.b2[col + e]));
                      }
                    });
    }
    phase_mark(9);  // the cluster's sum
    layer_norm<true>(p, s, ex, xs, xa_all, plane, ln_all, p.ln[4], p.ln[5], true, nullptr, row0,
                     rows, BM);
    phase_mark(10);  // LN3
  }
};

}  // namespace fused

// ================================================================= launch
using KernelFn = void (*)(const Params);

// The cluster size a shape allows: 2 where the heads split evenly and half
// of D and of F are multiples of the TMA box (and the build asks for 2),
// else 1.
int cluster_for(const Params& p) {
  const bool even = p.h % 2 == 0 && (p.D / 2) % BOX == 0 && (p.F / 2) % BOX == 0;
  return even && RESIDENT_CLUSTER == 2 ? 2 : 1;
}

KernelFn kernel_of(bool res, int C) {
  if (res) {
    return C == 2 ? step_kernel<resident::Design, 2> : step_kernel<resident::Design, 1>;
  }
  return C == 2 ? step_kernel<fused::Design, 2> : step_kernel<fused::Design, 1>;
}

size_t smem_of(bool res, int C, int D, int F, int L, int M) {
  return res ? (size_t)resident::layout(16 * C, C, D, F, L, M).total
             : (size_t)fused::layout(16 * C, C, D, F, L, M).total;
}

// CTAs that are resident at once, cached per design, cluster size and
// shared memory.
int resident_ctas(bool res, int C, size_t smem) {
  static int cached[2][MAX_CLUSTER + 1] = {};
  static size_t cached_smem[2][MAX_CLUSTER + 1] = {};
  if (cached[res][C] > 0 && cached_smem[res][C] == smem) return cached[res][C];
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(C * 256);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, kernel_of(res, C), &cfg);
  if (err != cudaSuccess || clusters < 1) {
    cudaGetLastError();
    clusters = 1;
  }
  cached[res][C] = clusters * C;
  cached_smem[res][C] = smem;
  return cached[res][C];
}

// The launch shape: the cluster size, rows per cluster tile (so that the
// grid fills the CTAs resident at once) and the grid.
cudaError_t prepare(Params& p, bool res, int& grid, size_t& smem) {
  p.cluster = cluster_for(p);
  const int C = p.cluster, BM = 16 * C;  // two row tiles of MMA when the cluster splits
  smem = smem_of(res, C, p.D, p.F, p.L, p.M);
  cudaError_t err = cudaFuncSetAttribute(kernel_of(res, C),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = resident_ctas(res, C, smem) / C;
  int rows = (p.N + tiles - 1) / tiles;
  p.rows = rows < 1 ? 1 : (rows > BM ? BM : rows);
  grid = (p.N + p.rows - 1) / p.rows * C;
  return cudaSuccess;
}

// The TMA map of a (K, Nout) row-major bf16 weight: boxes of BK rows x BOX
// columns, 128-byte swizzled.
cudaError_t weight_map(CUtensorMap* map, const bf16* W, int K, int Nout) {
  const hopper::EncodeTiled encode = hopper::tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)Nout, (cuuint64_t)K};
  const cuuint64_t strides[1] = {(cuuint64_t)Nout * sizeof(bf16)};
  const cuuint32_t box[2] = {BOX, BK};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(W), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

cudaError_t launch(Params p, bool res, cudaStream_t stream) {
  int grid;
  size_t smem;
  cudaError_t err = prepare(p, res, grid, smem);
  if (err != cudaSuccess) return err;
  const bf16* W[6] = {p.wqkv, p.wo, p.wqc, p.woc, p.w1, p.w2};
  const int K[6] = {p.D, p.D, p.D, p.D, p.D, p.F};
  const int Nout[6] = {3 * p.D, p.D, p.D, p.D, p.F, p.D};
  for (int g = 0; g < 6; ++g) {
    err = weight_map(&p.maps[g], W[g], K[g], Nout[g]);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel_of(res, p.cluster), p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs, at the cluster size the
// shape allows with an even number of heads.
long long openviic_layer_step_smem(int resident, int D, int F, int L, int M) {
  Params p = {};
  p.D = D; p.F = F; p.L = L; p.M = M; p.h = 2;
  const int C = cluster_for(p);
  return (long long)smem_of(resident != 0, C, D, F, L, M);
}

// What the resident (or fused) kernel runs with at N rows and h heads: out =
// {CTAs per SM, CTAs resident at once, cluster size, rows per cluster tile,
// grid, registers per thread, local (spill) bytes per thread, shared bytes
// per CTA}.  Returns a CUDA error code.
int openviic_layer_step_occupancy(int resident, int N, int D, int F, int L, int M, int h,
                                  int* out) {
  Params p = {};
  p.N = N; p.D = D; p.F = F; p.L = L; p.M = M; p.h = h;
  const bool res = resident != 0;
  int grid;
  size_t smem;
  cudaError_t err = prepare(p, res, grid, smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  cudaFuncAttributes attr;
  const KernelFn fn = kernel_of(res, p.cluster);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS, smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  out[0] = per_sm;
  out[1] = resident_ctas(res, p.cluster, smem);
  out[2] = p.cluster;
  out[3] = p.rows;
  out[4] = grid;
  out[5] = attr.numRegs;
  out[6] = (int)attr.localSizeBytes;
  out[7] = (int)smem;
  return 0;
}

#ifdef OPENVIIC_PHASES
// Copy the phase marks of the last launch (PHASE_CTAS x PHASE_SLOTS
// nanosecond reads of %globaltimer) to `host`; returns a CUDA error code.
int openviic_phase_clock(unsigned long long* host) {
  return (int)cudaMemcpyFromSymbol(host, phase_clock, sizeof(phase_clock));
}
#endif

// Launch one layer step on `stream`; returns cudaGetLastError().
// ptrs: x, k_cache, v_cache, cross_k, cross_v, anc, smask, cmask, is_pad,
// wqkv, bqkv, wo, bo, wqc, bqc, woc, boc, w1, b1, w2, b2, ln1s, ln1b, ln2s,
// ln2b, ln3s, ln3b, y, out_k, out_v (30).  dims: N, L, M, D, F, h, beam,
// t.  The caller guarantees bf16 contiguous 16-byte aligned tensors, D <= 512, D
// and F multiples of 64, d = D / h with d / 8 a power of two <= 32, and
// (resident) 0 <= ancestry < beam.
int openviic_layer_step(int resident, const void* const* ptrs, const int* dims, float scale,
                        void* stream) {
  Params p = {};
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
  return (int)launch(p, resident != 0, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
