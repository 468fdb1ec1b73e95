// Many candidate portfolios scored over one shared set of correlated-GBM paths
// on Hopper: per (candidate, path), the terminal simple return and the maximum
// drawdown.
//
// Replaces mcport/ops/pallas_multi_dd.py::_multi_dd_kernel, its three modes,
// the TPU kernel of the drawdown-frontier main path and of hedged GBM path
// risk. The plain torch form of the same function, on the same Philox
// counters, is mcport_torch/ops/multi_dd.py::multi_dd_reference.
//
// What it computes. For block b of a dispatch group and path p < block_paths,
// step by step: draw z (gbm_draws.cuh: the same shocks as terminal_noise.cu and
// path_stats.cu), x = m + L z, logS += x; then for every candidate w
//   buy-and-hold:  V_t = W_w · exp(logS)
//   rebalanced:    V_t = V_{t-1} · W_w · exp(x)
//   hedged:        P_t = P_{t-1} · exp(x) from P_0 = s0, and
//                  V_t = V_{t-1} · (1 + W_w · r_h(P_{t-1}, P_t))
// with V_0 = peak_0 = 1, dd_0 = 0, peak = max(peak, V), dd = min(dd, V/peak -
// 1). Out: V_T - 1 and dd per (candidate, path). With one candidate this is
// path_stats.cu's (port, dd), operation for operation. r_h is hedged.cuh's
// per-step option settlement (mcport's hedged branch, pallas_multi_dd.py:
// 143-175): the price P replaces logS in the same registers, and the settled
// returns replace exp(x) in the shared tile the candidates score. The shocks
// are the unhedged modes' (the same counters), so a hedge of one BUY_ASSET leg
// per asset is the rebalanced mode up to rounding. Hedged wealth can overflow
// float32 (an in-the-money leg pays every step): then V = inf, V/peak = NaN,
// and peak and dd carry the NaN as torch.maximum/minimum do (hedged.cuh).
//
// Score tiers (the per-step product W·e), mcport's numerics:
//   float32        FP32 FMAs;
//   tensorfloat32  mcport's manual 3-product bf16 split, w1·e1 + w1·e2 + w2·e1
//                  with w1 = bf16(w), w2 = bf16(w - w1) and e likewise
//                  (~1.5e-5 relative) — not Hopper's TF32, whose 10-bit
//                  mantissa (~5e-4) is some 30x worse;
//   bfloat16       both operands rounded to bf16 (round to nearest even), the
//                  products summed in FP32 (~2e-3, screening).
// The buy-and-hold terminal return is always the FP32 score of the terminal
// state, as in mcport; rebalanced, the tier's rounding compounds into it.
//
// What bounds it on the card. Per path-step: A shocks (a quarter of a Philox
// call and ~40 floating-point operations each), A² FMAs of L z and A exps —
// shared by all candidates — and W·A FMAs of scoring (3·W·A in the split
// tier). At W = 256 and A = 15 the scoring is ~90% of the arithmetic, so the
// kernel is bound by FP32 issue; nothing is read per step, and 8·W bytes per
// path are stored once. The design: a block owns a tile of 16 paths and all
// candidates. Per Philox call its threads draw the (asset, path) shocks of up
// to four steps into shared memory; per step they correlate them, keep logS in
// registers and write exp(logS) (or exp(x)) for the tile to shared memory;
// then each thread updates a 4-candidate x 4-path micro-tile whose values,
// peaks and drawdowns stay in registers, reading the weights (in shared memory
// for the whole launch) and the tile's exps as float4s. A dispatch group of
// blocks is one launch (gridDim.y). Tensor cores (wgmma) for the score product
// are later work.
//
// Past 64 assets the kernel runs wide.cuh's layout with its GbmWide model
// (the same operations; the hedge read from device memory).
//
// Candidate rows past W and paths past block_paths are computed (weights zero,
// valid counters) but never stored.

#include "gbm_draws.cuh"
#include "hedged.cuh"
#include "wide.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileP = 16;          // paths per block
constexpr int kMaxCand = 256;       // ops/multi_dd.py MAX_CANDIDATES
constexpr int kItems = 4;           // (asset, path) items per thread: kMaxAssets·kTileP / kThreads

enum Score { kF32 = 0, kSplit = 1, kBf16 = 2 };
enum Mode { kHold = 0, kRebal = 1, kHedged = 2 };

// float → the nearest bfloat16 (ties to even), returned as a float; torch's
// float32 → bfloat16 conversion for finite values.
__device__ __forceinline__ float bf16_round(float x) {
  uint32_t u = __float_as_uint(x);
  u += 0x7FFFu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xFFFF0000u);
}

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

struct Layout {  // offsets into dynamic shared memory, in floats, 16-byte aligned
  int chol, mean, w1, w2, z, e1, e2, hedge, total;
  __host__ __device__ Layout(int a, int w_pad, bool split, int n_legs) {
    chol = 0;
    mean = round4(chol + a * a);
    w1 = round4(mean + a);
    w2 = w1 + a * w_pad;
    z = w2 + (split ? a * w_pad : 0);
    e1 = z + 4 * a * kTileP;
    e2 = e1 + a * kTileP;
    hedge = e2 + (split ? a * kTileP : 0);
    total = hedge + (n_legs ? hedge_floats(a, n_legs) : 0);
  }
};

template <int kTier, int kMode, int kScore>
__global__ void __launch_bounds__(kThreads, 2)
multi_dd_kernel(long long seed, long long first_block, int block_paths, int n_assets,
                int n_cand, int n_steps, int n_legs, float df, float neg2_over_df,
                const float* __restrict__ chol, const float* __restrict__ mean,
                const float* __restrict__ weights, const float* __restrict__ hedge,
                float* __restrict__ term, float* __restrict__ max_dd) {
  constexpr bool kRebalanced = kMode == kRebal;
  extern __shared__ __align__(16) float smem[];
  const int a_n = n_assets;
  const int w_pad = round4(n_cand);
  const Layout lay(a_n, w_pad, kScore == kSplit, kMode == kHedged ? n_legs : 0);
  float* s_chol = smem + lay.chol;  // (A, A)
  float* s_mean = smem + lay.mean;  // (A,)
  float* s_w1 = smem + lay.w1;      // (A, w_pad): score weights, or their bf16 high part
  float* s_w2 = smem + lay.w2;      // (A, w_pad): the split tier's low part
  float* s_z = smem + lay.z;        // (4, A, kTileP): the shocks of one Philox call
  float* s_e1 = smem + lay.e1;      // (A, kTileP): exp(logS) or exp(x), or its high part
  float* s_e2 = smem + lay.e2;      // (A, kTileP): the split tier's low part
  float* s_h = smem + lay.hedge;    // hedged: the hedge block (hedged.cuh)

  const int tid = threadIdx.x;
  if (kMode == kHedged) {
    for (int i = tid; i < hedge_floats(a_n, n_legs); i += kThreads) s_h[i] = hedge[i];
  }
  const HedgeBlock legs(s_h, a_n, n_legs);
  for (int i = tid; i < a_n * a_n; i += kThreads) s_chol[i] = chol[i];
  for (int i = tid; i < a_n; i += kThreads) s_mean[i] = mean[i];
  for (int i = tid; i < a_n * w_pad; i += kThreads) {
    const int a = i / w_pad, w = i % w_pad;
    const float x = w < n_cand ? weights[w * a_n + a] : 0.0f;
    if (kScore == kF32) {
      s_w1[i] = x;
    } else {
      const float hi = bf16_round(x);
      s_w1[i] = hi;
      if (kScore == kSplit) s_w2[i] = bf16_round(x - hi);
    }
  }

  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kTileP;
  const uint32_t key = block_key(seed, first_block, b);
  constexpr int kPer = steps_per_call<kTier>();
  const int n_items = a_n * kTileP;

  float acc[kItems];  // logS of this thread's (asset, path) items; hedged, their price
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int item = tid + r * kThreads;
    acc[r] = (kMode == kHedged && item < n_items) ? hedge[item / kTileP] : 0.0f;
  }

  // this thread's micro-tile: candidates 4·cw .. +3, tile paths 4·pq .. +3
  const int cw = tid / 4, pq = tid % 4;
  const bool scorer = 4 * cw < w_pad;
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
  __syncthreads();

  for (int s0 = 0; s0 < n_steps; s0 += kPer) {
    const int n = min(kPer, n_steps - s0);
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      const int item = tid + r * kThreads;
      if (item < n_items) {
        const int a = item / kTileP, p = item % kTileP;
        float za[4];
        call_draws<kTier>(s0 / kPer, a, p0 + p, key, n, df, neg2_over_df, za);
#pragma unroll
        for (int k = 0; k < kPer; ++k) s_z[(k * a_n + a) * kTileP + p] = za[k];
      }
    }
    __syncthreads();

    for (int k = 0; k < n; ++k) {
#pragma unroll
      for (int r = 0; r < kItems; ++r) {
        const int item = tid + r * kThreads;
        if (item < n_items) {
          const int a = item / kTileP, p = item % kTileP;
          float y = 0.0f;
          for (int j = 0; j < a_n; ++j) {
            y = fmaf(s_chol[a * a_n + j], s_z[(k * a_n + j) * kTileP + p], y);
          }
          const float x = s_mean[a] + y;
          float e;
          if (kMode == kHedged) {  // the settled return of the move P -> P·exp(x)
            const float p_new = acc[r] * expf(x);
            e = hedged_return(legs, a, acc[r], p_new);
            acc[r] = p_new;
          } else {
            acc[r] += x;
            e = expf(kRebalanced ? x : acc[r]);
          }
          if (kScore == kF32) {
            s_e1[item] = e;
          } else {
            const float hi = bf16_round(e);
            s_e1[item] = hi;
            if (kScore == kSplit) s_e2[item] = bf16_round(e - hi);
          }
        }
      }
      __syncthreads();

      if (scorer) {
        float f[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) f[i][j] = 0.0f;
        }
        for (int a = 0; a < a_n; ++a) {
          const float4 w1 = *reinterpret_cast<const float4*>(s_w1 + a * w_pad + 4 * cw);
          const float4 e1 = *reinterpret_cast<const float4*>(s_e1 + a * kTileP + 4 * pq);
          const float wv[4] = {w1.x, w1.y, w1.z, w1.w};
          const float ev[4] = {e1.x, e1.y, e1.z, e1.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j) f[i][j] = fmaf(wv[i], ev[j], f[i][j]);
          }
          if (kScore == kSplit) {
            const float4 w2 = *reinterpret_cast<const float4*>(s_w2 + a * w_pad + 4 * cw);
            const float4 e2 = *reinterpret_cast<const float4*>(s_e2 + a * kTileP + 4 * pq);
            const float wl[4] = {w2.x, w2.y, w2.z, w2.w};
            const float el[4] = {e2.x, e2.y, e2.z, e2.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                f[i][j] = fmaf(wv[i], el[j], f[i][j]);
                f[i][j] = fmaf(wl[i], ev[j], f[i][j]);
              }
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            v[i][j] = kMode == kHedged ? v[i][j] * (1.0f + f[i][j])
                      : kRebalanced    ? v[i][j] * f[i][j]
                                       : f[i][j];
            if (kMode == kHedged) {  // wealth may overflow: NaN carries on
              peak[i][j] = max_nan(peak[i][j], v[i][j]);
              dd[i][j] = min_nan(dd[i][j], v[i][j] / peak[i][j] - 1.0f);
            } else {
              peak[i][j] = fmaxf(peak[i][j], v[i][j]);
              dd[i][j] = fminf(dd[i][j], v[i][j] / peak[i][j] - 1.0f);
            }
          }
        }
      }
      __syncthreads();
    }
  }

  if (kMode == kHold) {
    // the terminal return is the FP32 score of the terminal state in every
    // tier (Σ w when n_steps == 0): exp(logS) to shared memory once more
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      const int item = tid + r * kThreads;
      if (item < n_items) s_e1[item] = expf(acc[r]);
    }
    __syncthreads();
    if (scorer) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int w = 4 * cw + i;
        float f[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int a = 0; a < a_n; ++a) {
          const float wa = w < n_cand ? weights[w * a_n + a] : 0.0f;
#pragma unroll
          for (int j = 0; j < 4; ++j) f[j] = fmaf(wa, s_e1[a * kTileP + 4 * pq + j], f[j]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) v[i][j] = f[j];
      }
    }
  }

  if (scorer) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int w = 4 * cw + i;
      if (w >= n_cand) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = p0 + 4 * pq + j;
        if (p >= block_paths) continue;
        const long long o = (static_cast<long long>(b) * n_cand + w) * block_paths + p;
        term[o] = v[i][j] - 1.0f;
        max_dd[o] = dd[i][j];
      }
    }
  }
}

// The launch's arguments, passed down the dispatch on (tier, mode, score).
struct Args {
  dim3 grid;
  size_t smem;
  cudaStream_t s;
  long long seed, first_block;
  int block_paths, n_assets, n_cand, n_steps, n_legs;
  float df, neg2_over_df;
  const float *chol, *mean, *w, *hedge;
  float *term, *dd;
};

template <int kTier, int kMode, int kScore>
int launch(const Args& g) {
  auto kernel = multi_dd_kernel<kTier, kMode, kScore>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(g.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<g.grid, kThreads, g.smem, g.s>>>(g.seed, g.first_block, g.block_paths, g.n_assets,
                                            g.n_cand, g.n_steps, g.n_legs, g.df,
                                            g.neg2_over_df, g.chol, g.mean, g.w, g.hedge,
                                            g.term, g.dd);
  return static_cast<int>(cudaGetLastError());
}

template <int kTier, int kMode>
int launch_score(int score, const Args& g) {
  switch (score) {
    case kF32:
      return launch<kTier, kMode, kF32>(g);
    case kSplit:
      return launch<kTier, kMode, kSplit>(g);
    case kBf16:
      return launch<kTier, kMode, kBf16>(g);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int kTier>
int launch_mode(int mode, int score, const Args& g) {
  switch (mode) {
    case kHold:
      return launch_score<kTier, kHold>(score, g);
    case kRebal:
      return launch_score<kTier, kRebal>(score, g);
    case kHedged:
      return launch_score<kTier, kHedged>(score, g);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` for blocks first_block+1 .. first_block+n_blocks.
// chol: (n_assets, n_assets), mean: (n_assets,), weights: (n_cand, n_assets),
// float32 row-major on the device; hedge: ops/hedged.py HedgeTensors.packed
// for n_legs legs per asset (read only in the hedged mode). Outputs term and
// dd: (n_blocks, n_cand, block_paths) float32. tier: 0 poly, 1 poly_fast, 2
// Student-t (df, neg2_over_df = -2/df used only then); mode: 0 buy-and-hold,
// 1 rebalanced every step, 2 hedged per-step settlement; score: 0 float32, 1
// tensorfloat32 (bf16 split), 2 bfloat16. Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for arguments the kernel does not take
// (among them a hedge too large for a block's shared memory).
int mcport_multi_dd(long long seed, long long first_block, int n_blocks, int block_paths,
                    int n_assets, int n_cand, int n_steps, int tier, int mode, int score,
                    int n_legs, float df, float neg2_over_df, const void* chol,
                    const void* mean, const void* weights, const void* hedge, void* term,
                    void* dd, void* stream) {
  if (n_assets < 1 || n_assets > kMaxAssets || n_cand < 1 || n_cand > kMaxCand ||
      n_blocks < 1 || n_blocks > 65535 || block_paths < 1 || n_steps < 0 ||
      kMaxAssets * kTileP > kItems * kThreads || (mode == kHedged && n_legs < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args g;
  g.grid = dim3((block_paths + kTileP - 1) / kTileP, n_blocks);
  g.smem = sizeof(float) * Layout(n_assets, round4(n_cand), score == kSplit,
                                  mode == kHedged ? n_legs : 0).total;
  if (g.smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  g.s = static_cast<cudaStream_t>(stream);
  g.seed = seed;
  g.first_block = first_block;
  g.block_paths = block_paths;
  g.n_assets = n_assets;
  g.n_cand = n_cand;
  g.n_steps = n_steps;
  g.n_legs = mode == kHedged ? n_legs : 0;
  g.df = df;
  g.neg2_over_df = neg2_over_df;
  g.chol = static_cast<const float*>(chol);
  g.mean = static_cast<const float*>(mean);
  g.w = static_cast<const float*>(weights);
  g.hedge = static_cast<const float*>(hedge);
  g.term = static_cast<float*>(term);
  g.dd = static_cast<float*>(dd);
  switch (tier) {
    case kPoly:
      return launch_mode<kPoly>(mode, score, g);
    case kPolyFast:
      return launch_mode<kPolyFast>(mode, score, g);
    case kStudentT:
      return launch_mode<kStudentT>(mode, score, g);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The same function past 64 assets (the layout of wide.cuh, its GbmWide
// model): the arguments of mcport_multi_dd, plus scratch, WIDE_CTAS·tp·A
// floats on the device, tp paths per tile (1, 2, 4, 8 or 16) and n_ctas
// persistent CTAs (the scratch's CTA axis). The hedge is read from device
// memory. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments the layout does not take.
int mcport_multi_dd_wide(long long seed, long long first_block, int n_blocks, int block_paths,
                         int n_assets, int n_cand, int n_steps, int tier, int mode, int score,
                         int n_legs, float df, float neg2_over_df, const void* chol,
                         const void* mean, const void* weights, const void* hedge, void* term,
                         void* dd, void* scratch, int tp, int n_ctas, void* stream) {
  if (n_cand < 1 || n_cand > kMaxCand || (mode == kHedged && (n_legs < 1 || hedge == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  WideArgs g{seed, first_block, n_blocks, block_paths, n_assets, n_cand, n_steps, tp,
             static_cast<const float*>(weights), static_cast<float*>(scratch),
             static_cast<float*>(term), static_cast<float*>(dd), nullptr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto model) {
    model.chol = static_cast<const float*>(chol);
    model.mean = static_cast<const float*>(mean);
    model.muj = model.sigj = nullptr;
    model.hedge = static_cast<const float*>(hedge);
    model.n_legs = n_legs;
    model.df = df;
    model.neg2_over_df = neg2_over_df;
    model.lam = 0.0f;
    return wide_launch(g, model, n_ctas, s);
  };
  auto by_score = [&](auto tier_tag, auto mode_tag) {
    constexpr int kT = decltype(tier_tag)::value, kV = decltype(mode_tag)::value;
    switch (score) {
      case kF32:
        return run(GbmWide<kT, kV, kWideF32, false>{});
      case kSplit:
        return run(GbmWide<kT, kV, kWideSplit, false>{});
      case kBf16:
        return run(GbmWide<kT, kV, kWideBf16, false>{});
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  };
  auto by_mode = [&](auto tier_tag) {
    switch (mode) {
      case kHold:
        return by_score(tier_tag, std::integral_constant<int, kWideHold>{});
      case kRebal:
        return by_score(tier_tag, std::integral_constant<int, kWideGross>{});
      case kHedged:
        return by_score(tier_tag, std::integral_constant<int, kWideHedged>{});
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  };
  switch (tier) {
    case kPoly:
      return by_mode(std::integral_constant<int, kPoly>{});
    case kPolyFast:
      return by_mode(std::integral_constant<int, kPolyFast>{});
    case kStudentT:
      return by_mode(std::integral_constant<int, kStudentT>{});
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
