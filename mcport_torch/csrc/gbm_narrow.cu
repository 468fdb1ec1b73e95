// The GBM candidate kernel (#3) and the path-stats kernel (#2) up to 16 assets
// on Hopper: one per-path GBM recursion, on narrow_dd.cuh's layouts.
//
// Replaces mcport/ops/pallas_multi_dd.py::_multi_dd_kernel (its three modes)
// at 1-16 assets, the TPU kernel of the drawdown-frontier main path and of
// hedged GBM path risk. The plain torch form of the same function, on the
// same Philox counters, is mcport_torch/ops/multi_dd.py::multi_dd_reference.
// From 17 assets multi_dd.cu's multi_dd_kernel runs, past 64 wide.cuh's
// layout.
//
// What it computes: multi_dd.cu's function, operation for operation. For
// block b of a dispatch group and path p < block_paths, step by step: draw z
// (gbm_draws.cuh, all three tiers), x = m + L z one fmaf per term in column
// order, logS += x; then for every candidate w
//   buy-and-hold:  V_t = W_w · exp(logS)          (ValueUpdate kLevel)
//   rebalanced:    V_t = V_{t-1} · W_w · exp(x)   (kGross)
//   hedged:        P_t = P_{t-1} · exp(x) from P_0 = s0, and
//                  V_t = V_{t-1} · (1 + W_w · r_h(P_{t-1}, P_t))   (kSimpleNan)
// from V_0 = peak_0 = 1, dd_0 = 0, peak = max(peak, V), dd = min(dd, V/peak -
// 1); out V_T - 1 and dd per (candidate, path). The buy-and-hold terminal
// return is the FP32 score of the terminal state in every score tier (Σ w
// when n_steps == 0), as in mcport. With one candidate and the float32 tier
// this is path_stats.cu's (port, dd), operation for operation.
//
// L's upper triangle. Row i of x sums L[i][j]·z[j] over the whole row in
// column order, one fmaf per term, from +0. That chain is never -0 (a sum
// that cancels exactly rounds to +0), so a term whose L[i][j] is zero adds
// an exact zero and can be left out: for a lower-triangular factor (every
// Cholesky factor) the recursion runs the lower triangle only, (A+1)/2
// fmafs per asset instead of A. Each block checks its copy of L once
// (__syncthreads_or while it loads it): a factor with a nonzero term above
// the diagonal runs the whole row. No host sync is needed for the check.
//
// Score tiers (multi_dd.cu's): float32 FMAs; tensorfloat32, mcport's bf16
// split w1·e1 + w1·e2 + w2·e1 per asset in that order; bfloat16, both
// operands rounded to bf16, the products summed in FP32. Ascending assets
// from 0.0f in each.
//
// The layouts (ops/multi_dd.py gbm_narrow_plan picks one by W, mode and score
// tier, measured on an H100):
// - solo (float32 tier): a thread per path (64 a block) runs the recursion
//   with one Philox call's shocks in registers and scores its own
//   candidates, their values, peaks and drawdowns in shared memory; one
//   launch, no barrier in the step loop;
// - split (every tier): the same recursion writes every step's returns to a
//   device scratch, then scoring blocks score them, 4 candidates x 4 paths a
//   thread: narrow_dd.cuh's score_kernel in the float32 tier,
//   gbm_tier_score_kernel (the same with the tiers' operand rounding) in the
//   other two.
// With no steps there is nothing to score: every layout and tier runs the
// solo recursion, whose terminal is mcport's (Σ w buy-and-hold, else 0).
// Every layout computes each path's operations in the same order, so their
// outputs are equal bit for bit, and equal to multi_dd.cu's tile kernel,
// which runs from 17 assets.

#include "gbm_draws.cuh"
#include "hedged.cuh"
#include "narrow_dd.cuh"

namespace {

constexpr int kMaxCand = 256;  // ops/multi_dd.py MAX_CANDIDATES

// The function's modes (multi_dd.cu's codes).
enum GbmMode { kBuyHold = 0, kRebalanced = 1, kHedgedMode = 2 };
// The score tiers (multi_dd.cu's codes).
enum ScoreTier { kScoreF32 = 0, kScoreSplit = 1, kScoreBf16 = 2 };

// Where the layouts switch, by mode (ops/multi_dd.py gbm_narrow_plan mirrors
// it): solo up to kSoloMaxCand candidates in the float32 tier, split past
// it and in the other tiers. Measured on an H100 at 15 assets and 131,072 x
// 252 (tools/ab_narrow_kernels.py ... gbm), every W from 12 to 28: the
// split layout's time steps with ceil(W/4) (its scoring blocks' shape), so
// it wins at some W where solo wins on both sides; these switches lose at
// most 1.3% unhedged (buy-and-hold at W = 16 and 20) and 2.5% hedged (at
// 17) to the faster of the two. Split beat multi_dd.cu's tile at every W, score
// tier and mode (by 4-75%), so the tile runs from 17 assets only. No steps:
// solo in every tier.
constexpr int kSoloMaxCand[3] = {22, 23, 14};

constexpr int gbm_layout(int n_cand, int mode, int score, int n_steps) {
  return n_steps == 0 || (score == kScoreF32 && n_cand <= kSoloMaxCand[mode]) ? kSolo : kSplit;
}

// float → the nearest bfloat16 (ties to even), returned as a float: multi_dd.cu's.
__device__ __forceinline__ float bf16_round(float x) {
  uint32_t u = __float_as_uint(x);
  u += 0x7FFFu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xFFFF0000u);
}

// Four floats of shared memory, loaded anew at every use: the volatile load
// keeps the compiler from holding L in registers across the unrolled steps.
__device__ __forceinline__ float4 lds4(const float* p) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
  return v;
}

__device__ __forceinline__ float lane(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// Row i of L z past the diagonal, added to the chain y in column order: the
// terms a factor with nonzero terms above its diagonal needs.
__device__ __forceinline__ float upper_terms(const float* s_l, const float (&z)[kNA], int i,
                                             int n, float y) {
#pragma unroll
  for (int j = i / 4 * 4; j < kNA; j += 4) {
    if (j < n) {
      const float4 l = lds4(s_l + i * kNA + j);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (j + c > i && j + c < n) y = fmaf(lane(l, c), z[j + c], y);
      }
    }
  }
  return y;
}

// The recursion's shared memory, in floats: L (kNA x kNA, zero outside A x
// A), m (kNA), the hedge block (hedged), the solo part's weights (W, kNA);
// then per-thread slices (stride kSoloThreads): the prices (kNA, hedged) and
// the solo part's values, peaks and drawdowns (3 x W).
struct GbmRecurLayout {
  int l, m, h, w, p, st, total;
  __host__ __device__ GbmRecurLayout(int n, int n_cand, int part, int n_legs) {
    l = 0;
    m = kNA * kNA;
    h = m + kNA;
    w = h + (n_legs ? round4n(hedge_floats(n, n_legs)) : 0);
    p = w + (part == kOwn ? n_cand * kNA : 0);
    st = p + (n_legs ? kNA * kSoloThreads : 0);
    total = st + (part == kOwn ? 3 * n_cand * kSoloThreads : 0);
  }
};

// The scoring block's shared memory, in floats: narrow_dd.cuh's
// score_floats, twice over for the split tier (the low parts).
__host__ __device__ constexpr int gbm_score_floats(int n, int n_cand, int score) {
  return (score == kScoreSplit ? 2 : 1) * score_floats(n, n_cand);
}

// The recursion, a thread per path, for chunk paths 0 .. chunk-1 (path
// first_path + cp of each dispatch block): multi_dd.cu's per-path operations
// in their order — the shocks of one Philox call in registers (every loop
// over assets unrolled), x = m + L z (the lower triangle only unless L has
// terms above its diagonal), logS += x, exp(logS) (buy-and-hold) or exp(x);
// hedged the price P·exp(x) and the settled return (narrow_dd.cuh
// settle_all). kOwn scores the thread's own candidates in the float32 tier
// (solo_score) and, buy-and-hold, their terminal as the FP32 score of the
// terminal state. kReturns writes the returns to rets (returns_slot).
template <int kTier, int kMode, int kPart>
__global__ void __launch_bounds__(kSoloThreads, 4)
gbm_recur_kernel(long long seed, long long first_block, int block_paths, int first_path,
                 int chunk, int n_assets, int n_cand, int n_steps, int n_legs, float df,
                 float neg2_over_df, const float* __restrict__ chol,
                 const float* __restrict__ mean, const float* __restrict__ weights,
                 const float* __restrict__ hedge, float* __restrict__ rets,
                 float* __restrict__ term, float* __restrict__ max_dd) {
  constexpr int kS = kSoloThreads;  // the per-thread slices' stride
  constexpr bool kHedged = kMode == kHedgedMode;
  extern __shared__ __align__(16) float smem[];
  const int n = n_assets, tid = threadIdx.x, blk = blockIdx.y;
  const GbmRecurLayout lay(n, n_cand, kPart, kHedged ? n_legs : 0);
  float* s_l = smem + lay.l;
  float* s_m = smem + lay.m;
  float* s_h = smem + lay.h;
  float* s_w = smem + lay.w;
  int upper = 0;  // a nonzero term above the diagonal among this thread's
  for (int i = tid; i < kNA * kNA; i += kS) {
    const int r = i / kNA, c = i % kNA;
    const float x = (r < n && c < n) ? chol[r * n + c] : 0.0f;
    s_l[i] = x;
    upper |= c > r && x != 0.0f;
  }
  for (int i = tid; i < kNA; i += kS) s_m[i] = i < n ? mean[i] : 0.0f;
  if (kHedged) {
    for (int i = tid; i < hedge_floats(n, n_legs); i += kS) s_h[i] = hedge[i];
  }
  if (kPart == kOwn) {
    for (int i = tid; i < n_cand * kNA; i += kS) {
      const int c = i / kNA, a = i % kNA;
      s_w[i] = a < n ? weights[c * n + a] : 0.0f;
    }
  }
  const bool full = __syncthreads_or(upper);  // run L's whole rows

  const int cp = blockIdx.x * kS + tid;  // this thread's path of the chunk
  const uint32_t p = static_cast<uint32_t>(first_path + cp);
  const uint32_t key = block_key(seed, first_block, blk);
  const HedgeBlock legs(s_h, n, n_legs);
  float* s_p = smem + lay.p + tid;  // hedged: the prices, from s0
  float* s_st = smem + lay.st + tid;
  if (kHedged) {
    for (int a = 0; a < n; ++a) s_p[a * kS] = s_h[a];
  }
  if (kPart == kOwn) solo_start(n_cand, s_st);
  float* rg = kPart == kReturns ? returns_slot(rets, blk, chunk, cp, n_steps, n) : nullptr;
  const bool writes = cp < (chunk + kTile - 1) / kTile * kTile;  // whole tiles of the scratch
  float acc[kNA];  // logS
#pragma unroll
  for (int a = 0; a < kNA; ++a) acc[a] = 0.0f;
  constexpr int kPer = steps_per_call<kTier>();
  for (int s0 = 0; s0 < n_steps; s0 += kPer) {
    const int nk = min(kPer, n_steps - s0);
    float z[kPer][kNA];
#pragma unroll
    for (int a = 0; a < kNA; ++a) {
      float za[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (a < n) call_draws<kTier>(s0 / kPer, a, p, key, nk, df, neg2_over_df, za);
#pragma unroll
      for (int k = 0; k < kPer; ++k) z[k][a] = za[k];
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (k >= nk) continue;  // (not break: a loop that may break is not unrolled)
      float e[kNA];  // the step's returns (hedged: first (L z)_i)
#pragma unroll
      for (int i = 0; i < kNA; ++i) {
        e[i] = 0.0f;
        if (i < n) {
          float y = 0.0f;
#pragma unroll
          for (int j = 0; j <= i; j += 4) {  // row i's lower triangle, in column order
            const float4 l = lds4(s_l + i * kNA + j);
            y = fmaf(l.x, z[k][j], y);
            if (j + 1 <= i) y = fmaf(l.y, z[k][j + 1], y);
            if (j + 2 <= i) y = fmaf(l.z, z[k][j + 2], y);
            if (j + 3 <= i) y = fmaf(l.w, z[k][j + 3], y);
          }
          if (kHedged) {
            e[i] = y;
          } else {  // the rest of the row here: measured faster unhedged
            if (full) y = upper_terms(s_l, z[k], i, n, y);
            const float x = lane(lds4(s_m + i / 4 * 4), i % 4) + y;
            if (kMode == kBuyHold) acc[i] += x;
            e[i] = expf(kMode == kBuyHold ? acc[i] : x);
          }
        }
      }
      if (kHedged) {  // the rest of the rows under one branch a step: measured faster hedged
        if (full) {
#pragma unroll
          for (int i = 0; i < kNA; ++i) {
            if (i < n) e[i] = upper_terms(s_l, z[k], i, n, e[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < kNA; ++i) {  // the move P -> P·exp(x), settled below
          if (i < n) e[i] = s_p[i * kS] * expf(lane(lds4(s_m + i / 4 * 4), i % 4) + e[i]);
        }
      }
      if (kHedged) settle_all<kS>(legs, n, s_p, e);
      if (kPart == kOwn) {
        solo_score<kHedged ? kSimpleNan : kMode == kBuyHold ? kLevel : kGross>(n, n_cand, s_w,
                                                                              s_st, e);
      } else if (writes) {
#pragma unroll
        for (int i = 0; i < kNA; ++i) {
          if (i < n) rg[((s0 + k) * n + i) * kTile] = e[i];
        }
      }
    }
  }
  if (kPart == kOwn && cp < chunk) {
    if (kMode == kBuyHold) {  // the terminal: the FP32 score of the terminal state
      float e[kNA];
#pragma unroll
      for (int i = 0; i < kNA; ++i) e[i] = i < n ? expf(acc[i]) : 0.0f;
      for (int c = 0; c < n_cand; ++c) {
        float f = 0.0f;
#pragma unroll
        for (int a = 0; a < kNA; ++a) {
          if (a < n) f = fmaf(s_w[c * kNA + a], e[a], f);
        }
        s_st[3 * c * kS] = f;
      }
    }
    solo_store(n_cand, blk, block_paths, p, s_st, term, max_dd);
  }
}

// The split layout's scoring launch in the reduced-precision score tiers
// (kScore): narrow_dd.cuh's score_kernel with the tier's operand rounding —
// the weights rounded once into shared memory, the returns as they are
// staged — and multi_dd.cu's product order per asset (bfloat16: score_kernel's
// tile_score on the rounded operands); buy-and-hold (kLevel), the terminal is
// then the FP32 score of the last step's returns. n_steps >= 1.
template <int kUpd, int kScore>
__global__ void __launch_bounds__(kScoreThreads, 2)
gbm_tier_score_kernel(int block_paths, int first_path, int chunk, int n, int n_cand,
                      int n_steps, const float* __restrict__ weights,
                      const float* __restrict__ rets, float* __restrict__ term,
                      float* __restrict__ max_dd) {
  static_assert(kScore == kScoreSplit || kScore == kScoreBf16, "score_kernel scores float32");
  constexpr bool kTwo = kScore == kScoreSplit;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, blk = blockIdx.y, w_pad = round4n(n_cand);
  const int pg = score_groups(n_cand), bp = 4 * pg, ks = score_steps(n, n_cand);
  float* s_w = smem;                          // (A, w_pad): the weights, or their high part
  float* s_w2 = s_w + n * w_pad;              // (A, w_pad): the split tier's low part
  float* s_r = s_w + (kTwo ? 2 : 1) * n * w_pad;  // (ks, A, bp): the returns, or high part
  float* s_r2 = s_r + ks * n * bp;            // (ks, A, bp): the split tier's low part
  for (int i = tid; i < n * w_pad; i += kScoreThreads) {
    const int a = i / w_pad, c = i % w_pad;
    const float x = c < n_cand ? weights[c * n + a] : 0.0f;
    const float hi = bf16_round(x);
    s_w[i] = hi;
    if (kTwo) s_w2[i] = bf16_round(x - hi);
  }
  const int cw = tid / pg, pq = tid % pg;
  const int b0 = blockIdx.x * bp;  // the block's first path of the chunk
  const long long tiles = (chunk + kTile - 1) / kTile;
  const int bt = min(bp / kTile, static_cast<int>(tiles - b0 / kTile));  // its tiles
  const bool scorer = 4 * cw < w_pad && 4 * pq < bt * kTile;
  const float* rg = rets + ((blk * tiles + b0 / kTile) * n_steps) * n * kTile;
  float v[4][4], peak[4][4], dd[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[i][j] = 1.0f;
      peak[i][j] = 1.0f;
      dd[i][j] = 0.0f;
    }
  }
  for (int s0 = 0; s0 < n_steps; s0 += ks) {
    const int nk = min(ks, n_steps - s0);
    __syncthreads();  // the last stage's reads are done (and the weights stored)
    // float4 i of the stage: tile t, step k, asset a, lanes 4·l4 .. +3
    for (int i = tid; i < bt * nk * n * (kTile / 4); i += kScoreThreads) {
      const int l4 = i % (kTile / 4), a = (i / (kTile / 4)) % n;
      const int k = (i / (kTile / 4 * n)) % nk, tl = i / (kTile / 4 * n * nk);
      const float4 x = *reinterpret_cast<const float4*>(
          rg + ((static_cast<long long>(tl) * n_steps + s0 + k) * n + a) * kTile + 4 * l4);
      const int o = (k * n + a) * bp + tl * kTile + 4 * l4;
      const float4 hi = make_float4(bf16_round(x.x), bf16_round(x.y), bf16_round(x.z),
                                    bf16_round(x.w));
      if (kTwo) {
        *reinterpret_cast<float4*>(s_r2 + o) =
            make_float4(bf16_round(x.x - hi.x), bf16_round(x.y - hi.y),
                        bf16_round(x.z - hi.z), bf16_round(x.w - hi.w));
      }
      *reinterpret_cast<float4*>(s_r + o) = hi;
    }
    __syncthreads();
    if (!scorer) continue;
    for (int k = 0; k < nk; ++k) {
      if (!kTwo) {
        tile_score<kUpd>(n, w_pad, cw, pq, s_w, s_r + k * n * bp, bp, v, peak, dd);
        continue;
      }
      const float* s_e = s_r + k * n * bp;
      const float* s_e2 = s_r2 + k * n * bp;
      float f[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) f[i][j] = 0.0f;
      }
      for (int a = 0; a < n; ++a) {  // w1·e1, w1·e2, w2·e1 per asset
        const float4 w4 = *reinterpret_cast<const float4*>(s_w + a * w_pad + 4 * cw);
        const float4 e4 = *reinterpret_cast<const float4*>(s_e + a * bp + 4 * pq);
        const float4 w2 = *reinterpret_cast<const float4*>(s_w2 + a * w_pad + 4 * cw);
        const float4 e2 = *reinterpret_cast<const float4*>(s_e2 + a * bp + 4 * pq);
        const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
        const float ev[4] = {e4.x, e4.y, e4.z, e4.w};
        const float wl[4] = {w2.x, w2.y, w2.z, w2.w};
        const float el[4] = {e2.x, e2.y, e2.z, e2.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            f[i][j] = fmaf(wv[i], ev[j], f[i][j]);
            f[i][j] = fmaf(wv[i], el[j], f[i][j]);
            f[i][j] = fmaf(wl[i], ev[j], f[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) value_update<kUpd>(f[i][j], v[i][j], peak[i][j], dd[i][j]);
      }
    }
  }
  if (!scorer) return;
  if (kUpd == kLevel) {  // the terminal: the FP32 score of the last step's returns
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = 4 * cw + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = 4 * pq + j;  // the path of the block's tiles
        const float* last =
            rg + ((static_cast<long long>(q / kTile) * n_steps + n_steps - 1) * n) * kTile +
            q % kTile;
        float f = 0.0f;
        for (int a = 0; a < n; ++a) {
          f = fmaf(c < n_cand ? weights[c * n + a] : 0.0f, last[a * kTile], f);
        }
        v[i][j] = f;
      }
    }
  }
  tile_store(n_cand, blk, block_paths, first_path + b0, cw, pq, v, dd, term, max_dd);
}

// The launches of one call, passed down the dispatch on (tier, mode, score).
struct GbmArgs {
  long long seed, first_block;
  int n_blocks, block_paths, n_assets, n_cand, n_steps, n_legs, layout;
  float df, neg2_over_df;
  const float *chol, *mean, *w, *hedge;
  float *term, *dd, *scratch;
  long long scratch_floats;
  cudaStream_t s;
};

// one launch of `kernel` with `smem` bytes of dynamic shared memory
template <class K>
int start(K kernel, size_t smem) {
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)));
}

// the recursion over chunk paths from `first`, scoring its own candidates
// (kOwn) or writing their returns to the scratch (kReturns)
template <int kTier, int kMode, int kPart>
int recur(const GbmArgs& g, int first, int chunk) {
  auto kernel = gbm_recur_kernel<kTier, kMode, kPart>;
  const int legs = kMode == kHedgedMode ? g.n_legs : 0;
  const size_t smem = sizeof(float) * GbmRecurLayout(g.n_assets, g.n_cand, kPart, legs).total;
  int err = start(kernel, smem);
  if (err) return err;
  const dim3 grid((chunk + kSoloThreads - 1) / kSoloThreads, g.n_blocks);
  kernel<<<grid, kSoloThreads, smem, g.s>>>(g.seed, g.first_block, g.block_paths, first, chunk,
                                            g.n_assets, g.n_cand, g.n_steps, legs, g.df,
                                            g.neg2_over_df, g.chol, g.mean, g.w, g.hedge,
                                            g.scratch, g.term, g.dd);
  return static_cast<int>(cudaGetLastError());
}

// the split layout's scoring launch: score_kernel in the float32 tier, else
// gbm_tier_score_kernel
template <int kUpd, int kScore>
int score(const GbmArgs& g, int first, int chunk) {
  auto kernel = score_kernel<kUpd>;
  if constexpr (kScore != kScoreF32) kernel = gbm_tier_score_kernel<kUpd, kScore>;
  const size_t smem = sizeof(float) * gbm_score_floats(g.n_assets, g.n_cand, kScore);
  int err = start(kernel, smem);
  if (err) return err;
  const int paths = 4 * score_groups(g.n_cand);
  const dim3 grid((chunk + paths - 1) / paths, g.n_blocks);
  kernel<<<grid, kScoreThreads, smem, g.s>>>(g.block_paths, first, chunk, g.n_assets, g.n_cand,
                                             g.n_steps, g.w, g.scratch, g.term, g.dd);
  return static_cast<int>(cudaGetLastError());
}

template <int kMode, int kScore>
int score_mode(const GbmArgs& g, int first, int chunk) {
  constexpr int kUpd = kMode == kHedgedMode ? kSimpleNan : kMode == kBuyHold ? kLevel : kGross;
  return score<kUpd, kScore>(g, first, chunk);
}

template <int kTier, int kMode>
int run(int score_tier, const GbmArgs& g) {
  if (g.layout == kSolo) {  // the float32 tier, or no steps in any tier
    if (score_tier != kScoreF32 && g.n_steps) return static_cast<int>(cudaErrorInvalidValue);
    return recur<kTier, kMode, kOwn>(g, 0, g.block_paths);
  }
  // the split layout: the paths of a chunk are every path where the scratch
  // holds them all (in whole 16-path tiles), else what it holds in whole
  // recursion blocks
  const long long per_path = static_cast<long long>(g.n_blocks) * g.n_steps * g.n_assets;
  const long long all = (g.block_paths + kTile - 1) / kTile * kTile;
  long long chunk = g.block_paths;
  if (g.scratch_floats / per_path < all) {
    chunk = g.scratch_floats / per_path / kSoloThreads * kSoloThreads;
  }
  if (chunk < 1 || g.scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int first = 0; first < g.block_paths; first += static_cast<int>(chunk)) {
    const int m = static_cast<int>(chunk < g.block_paths - first ? chunk : g.block_paths - first);
    int err = recur<kTier, kMode, kReturns>(g, first, m);
    if (err) return err;
    switch (score_tier) {
      case kScoreF32:
        err = score_mode<kMode, kScoreF32>(g, first, m);
        break;
      case kScoreSplit:
        err = score_mode<kMode, kScoreSplit>(g, first, m);
        break;
      case kScoreBf16:
        err = score_mode<kMode, kScoreBf16>(g, first, m);
        break;
      default:
        err = static_cast<int>(cudaErrorInvalidValue);
    }
    if (err) return err;
  }
  return 0;
}

template <int kTier>
int run_mode(int mode, int score_tier, const GbmArgs& g) {
  switch (mode) {
    case kBuyHold:
      return run<kTier, kBuyHold>(score_tier, g);
    case kRebalanced:
      return run<kTier, kRebalanced>(score_tier, g);
    case kHedgedMode:
      return run<kTier, kHedgedMode>(score_tier, g);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int run_tier(int tier, int mode, int score_tier, const GbmArgs& g) {
  switch (tier) {
    case kPoly:
      return run_mode<kPoly>(mode, score_tier, g);
    case kPolyFast:
      return run_mode<kPolyFast>(mode, score_tier, g);
    case kStudentT:
      return run_mode<kStudentT>(mode, score_tier, g);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launches the candidate function up to 16 assets on `stream` for blocks
// first_block+1 .. first_block+n_blocks: multi_dd.cu's mcport_multi_dd
// (chol (n_assets, n_assets), mean (n_assets,), weights (n_cand, n_assets),
// float32 row-major on the device; hedge: HedgeTensors.packed for n_legs
// legs per asset, read only in the hedged mode; tier 0 poly, 1 poly_fast, 2
// Student-t; mode 0 buy-and-hold, 1 rebalanced, 2 hedged; score 0 float32, 1
// tensorfloat32, 2 bfloat16; outputs term and dd (n_blocks, n_cand,
// block_paths) float32), in the layout gbm_layout(n_cand, mode, score,
// n_steps) picks (layout -1) or the one named (0 solo, float32 tier only; 1
// split; with no steps solo whatever the name). The
// split layout takes its returns through scratch (scratch_floats floats on
// the device) in chunks of paths that it holds for every block and step (a
// multiple of 64 paths; ops/multi_dd.py gbm_narrow_plan sizes it), the solo
// layout takes none (null, 0). Returns cudaGetLastError() after the last
// launch, or cudaErrorInvalidValue for arguments the layouts do not take
// (among them a layout whose block the shared memory cannot hold).
int mcport_gbm_narrow_dd(long long seed, long long first_block, int n_blocks, int block_paths,
                         int n_assets, int n_cand, int n_steps, int tier, int mode, int score,
                         int n_legs, float df, float neg2_over_df, const void* chol,
                         const void* mean, const void* weights, const void* hedge, void* term,
                         void* dd, void* scratch, long long scratch_floats, int layout,
                         void* stream) {
  if (n_assets < 1 || n_assets > kNA || n_cand < 1 || n_cand > kMaxCand || n_blocks < 1 ||
      n_blocks > 65535 || block_paths < 1 || n_steps < 0 || mode < 0 || mode > kHedgedMode ||
      score < 0 || score > kScoreBf16 || (mode == kHedgedMode && (n_legs < 1 || !hedge)) ||
      scratch_floats < 0 || layout < -1 || layout > kSplit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static_assert(kMaxCand / 4 * score_groups(kMaxCand) <= kScoreThreads &&
                    4 * score_groups(kMaxCand) % kTile == 0 && kSoloThreads % kTile == 0,
                "a scoring block covers 256 candidates of whole tiles");
  if (layout < 0 || n_steps == 0) layout = gbm_layout(n_cand, mode, score, n_steps);
  GbmArgs g{seed, first_block, n_blocks, block_paths, n_assets, n_cand, n_steps,
            mode == kHedgedMode ? n_legs : 0, layout, df, neg2_over_df,
            static_cast<const float*>(chol), static_cast<const float*>(mean),
            static_cast<const float*>(weights), static_cast<const float*>(hedge),
            static_cast<float*>(term), static_cast<float*>(dd), static_cast<float*>(scratch),
            scratch_floats, static_cast<cudaStream_t>(stream)};
  return run_tier(tier, mode, score, g);
}

}  // extern "C"
