// Correlated-GBM path statistics of one portfolio on Hopper: per path, the
// terminal log returns, the portfolio's terminal simple return and its maximum
// drawdown over the path.
//
// Replaces mcport/ops/pallas_gbm.py::_path_stats_kernel (its default "eup_sum"
// form), the TPU kernel of the path-risk main path. The plain torch form of the
// same function, on the same Philox counters, is
// mcport_torch/ops/path_stats.py::path_stats_reference.
//
// What it computes. For block b of a dispatch group and path p < block_paths,
// step by step: draw z (gbm_draws.cuh: the same shocks as terminal_noise.cu,
// so its terminal equals the terminal-noise kernel's drift + L·Σz up to
// rounding), x = m + L z, logS += x, then the portfolio value
//   buy-and-hold:  V_t = Σ_a w_a exp(logS_a)
//   rebalanced:    V_t = V_{t-1} · Σ_a w_a exp(x_a)
// with V_0 = peak_0 = 1 and dd_0 = 0 (pallas_gbm.py:696-707), peak = max(peak,
// V), dd = min(dd, V/peak - 1). Out: logS (optional), V_T - 1 and dd. The t
// scale is folded into L by the wrapper (ops/path_stats.py::gbm_path_stats).
//
// What bounds it on the card. Per path-step and asset: a quarter of a Philox
// call (half for the t tier) plus ~40 floating-point operations of draw
// polynomials, A FMAs of L z and one exp; nothing is read per step and 8 + 4·A
// bytes per path are stored once (4·A only when the terminal is asked for).
// So it is bound by instruction issue, not memory. The design: one thread per
// path; the asset state (logS) and the four shocks one Philox call feeds stay
// in registers — up to 16 assets (path_stats_narrow_kernel) the loops over
// assets are unrolled so that they can, and L z runs the lower triangle;
// from 17 to 64 assets (path_stats_kernel<…, 64, 1>) the arrays live in
// local memory (the ptxas log shows the stack frame), which is correct but
// slower. L, m and w sit in shared memory. A dispatch group of blocks is one
// launch (gridDim.y).
//
// Past 64 assets the function runs wide.cuh's layout with its GbmWide model
// and one candidate (kernel #3's path, as at any width).
//
// nvcc contracts a*b+c into FMA where the torch form rounds twice, and the
// plain form sums log paths and portfolio values in other orders, so kernel and
// plain form agree to ulps, not bits (bound: ops/path_stats.py
// path_stats_tolerance).

#include "gbm_draws.cuh"
#include "wide.cuh"

namespace {

constexpr int kThreads = 128;

// Four floats of shared memory, loaded anew at every use: the volatile load
// keeps the compiler from holding all of L in registers across the unrolled
// steps of a Philox call (which spilled at 255 registers).
__device__ __forceinline__ float4 lds128(const float* p) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
  return v;
}

// kA: the asset capacity (a multiple of the real count's bucket); kUnroll: how
// far the loops over assets unroll (kA keeps arrays in registers, 1 lets them
// live in local memory). Built as <…, kMaxAssets, 1>.
template <int kTier, bool kRebal, int kA, int kUnroll>
__global__ void __launch_bounds__(kThreads)
path_stats_kernel(long long seed, long long first_block, int block_paths, int n_assets,
                  int n_steps, float df, float neg2_over_df, const float* __restrict__ chol,
                  const float* __restrict__ mean, const float* __restrict__ weights,
                  float* __restrict__ term, float* __restrict__ port,
                  float* __restrict__ max_dd) {
  __shared__ __align__(16) float s_chol[kA * kA];  // (kA, kA) row-major, zero outside (A, A)
  __shared__ float s_mean[kA];
  __shared__ float s_w[kA];
  for (int i = threadIdx.x; i < kA * kA; i += kThreads) {
    const int r = i / kA, c = i % kA;
    s_chol[i] = (r < n_assets && c < n_assets) ? chol[r * n_assets + c] : 0.0f;
  }
  for (int i = threadIdx.x; i < kA; i += kThreads) {
    s_mean[i] = i < n_assets ? mean[i] : 0.0f;
    s_w[i] = i < n_assets ? weights[i] : 0.0f;
  }
  __syncthreads();

  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= block_paths) return;
  const int b = blockIdx.y;
  const uint32_t key = block_key(seed, first_block, b);
  constexpr int kPer = steps_per_call<kTier>();

  float acc[kA];
#pragma unroll (kUnroll)
  for (int a = 0; a < kA; ++a) acc[a] = 0.0f;
  float v = 1.0f, peak = 1.0f, dd = 0.0f;

  for (int s0 = 0; s0 < n_steps; s0 += kPer) {
    const int n = min(kPer, n_steps - s0);
    float z[kPer][kA];
#pragma unroll (kUnroll)
    for (int a = 0; a < kA; ++a) {
      float za[4];
      if (a < n_assets) {
        call_draws<kTier>(s0 / kPer, a, p, key, n, df, neg2_over_df, za);
      } else {
        za[0] = za[1] = za[2] = za[3] = 0.0f;
      }
#pragma unroll
      for (int k = 0; k < kPer; ++k) z[k][a] = za[k];
    }
#pragma unroll (kUnroll == 1 ? 1 : kPer)
    for (int k = 0; k < kPer; ++k) {
      if (k >= n) continue;  // (not break: a loop that may break is not unrolled)
      float s = 0.0f;
#pragma unroll (kUnroll)
      for (int i = 0; i < kA; ++i) {
        if (i < n_assets) {
          float y = 0.0f;  // L's zero padding and z's adds exact zeros past A
#pragma unroll (kUnroll)
          for (int j = 0; j < kA; j += 4) {
            if (j < n_assets) {
              const float4 l = lds128(s_chol + i * kA + j);
              y = fmaf(l.x, z[k][j], y);
              y = fmaf(l.y, z[k][j + 1], y);
              y = fmaf(l.z, z[k][j + 2], y);
              y = fmaf(l.w, z[k][j + 3], y);
            }
          }
          const float x = s_mean[i] + y;
          acc[i] += x;
          s = fmaf(s_w[i], expf(kRebal ? x : acc[i]), s);
        }
      }
      v = kRebal ? v * s : s;
      peak = fmaxf(peak, v);
      dd = fminf(dd, v / peak - 1.0f);
    }
  }

  const long long row = static_cast<long long>(b) * block_paths + p;
  if (!kRebal) {  // V_T of the terminal state (Σ w when n_steps == 0)
    float s = 0.0f;
#pragma unroll (kUnroll)
    for (int i = 0; i < kA; ++i) {
      if (i < n_assets) s = fmaf(s_w[i], expf(acc[i]), s);
    }
    v = s;
  }
  if (term != nullptr) {
#pragma unroll (kUnroll)
    for (int a = 0; a < kA; ++a) {
      if (a < n_assets) term[row * n_assets + a] = acc[a];
    }
  }
  port[row] = v - 1.0f;
  max_dd[row] = dd;
}

// Up to 16 assets: path_stats_kernel's operations in their order, with every
// loop over assets unrolled (the logS and the shocks of one Philox call in
// registers) and L z over row i's lower triangle only, (A+1)/2 fmafs per
// asset. The row's chain is never -0 (it starts at +0, and a sum that
// cancels exactly rounds to +0), so the zero terms above the diagonal of a
// lower-triangular factor add exact zeros: leaving them out keeps the
// outputs bit for bit. The block checks its copy of L once while it loads it
// (__syncthreads_or); a factor with a nonzero term above the diagonal runs
// the whole rows, in column order (kFull, the path's second build, chosen
// once per thread).
constexpr int kNarrow = 16;

template <int kTier, bool kRebal, bool kFull>
__device__ __forceinline__ void narrow_path(int p, int b, long long seed, long long first_block,
                                            int block_paths, int n_assets, int n_steps,
                                            float df, float neg2_over_df, const float* s_chol,
                                            const float* s_mean, const float* s_w, float* term,
                                            float* port, float* max_dd) {
  constexpr int kA = kNarrow;
  const uint32_t key = block_key(seed, first_block, b);
  constexpr int kPer = steps_per_call<kTier>();

  float acc[kA];
#pragma unroll
  for (int a = 0; a < kA; ++a) acc[a] = 0.0f;
  float v = 1.0f, peak = 1.0f, dd = 0.0f;

  for (int s0 = 0; s0 < n_steps; s0 += kPer) {
    const int n = min(kPer, n_steps - s0);
    float z[kPer][kA];
#pragma unroll
    for (int a = 0; a < kA; ++a) {
      float za[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (a < n_assets) call_draws<kTier>(s0 / kPer, a, p, key, n, df, neg2_over_df, za);
#pragma unroll
      for (int k = 0; k < kPer; ++k) z[k][a] = za[k];
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (k >= n) continue;  // (not break: a loop that may break is not unrolled)
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < kA; ++i) {
        if (i < n_assets) {
          float y = 0.0f;
#pragma unroll
          for (int j = 0; j < kA; j += 4) {  // row i in column order, kFull past the diagonal
            if (j < n_assets && (kFull || j <= i)) {
              const float4 l = lds128(s_chol + i * kA + j);
              const float lv[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                if (kFull ? j + c < n_assets : j + c <= i) y = fmaf(lv[c], z[k][j + c], y);
              }
            }
          }
          const float x = s_mean[i] + y;
          acc[i] += x;
          s = fmaf(s_w[i], expf(kRebal ? x : acc[i]), s);
        }
      }
      v = kRebal ? v * s : s;
      peak = fmaxf(peak, v);
      dd = fminf(dd, v / peak - 1.0f);
    }
  }

  const long long row = static_cast<long long>(b) * block_paths + p;
  if (!kRebal) {  // V_T of the terminal state (Σ w when n_steps == 0)
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < kA; ++i) {
      if (i < n_assets) s = fmaf(s_w[i], expf(acc[i]), s);
    }
    v = s;
  }
  if (term != nullptr) {
#pragma unroll
    for (int a = 0; a < kA; ++a) {
      if (a < n_assets) term[row * n_assets + a] = acc[a];
    }
  }
  port[row] = v - 1.0f;
  max_dd[row] = dd;
}

template <int kTier, bool kRebal>
__global__ void __launch_bounds__(kThreads)
path_stats_narrow_kernel(long long seed, long long first_block, int block_paths, int n_assets,
                         int n_steps, float df, float neg2_over_df,
                         const float* __restrict__ chol, const float* __restrict__ mean,
                         const float* __restrict__ weights, float* __restrict__ term,
                         float* __restrict__ port, float* __restrict__ max_dd) {
  constexpr int kA = kNarrow;
  __shared__ __align__(16) float s_chol[kA * kA];  // (kA, kA) row-major, zero outside (A, A)
  __shared__ float s_mean[kA];
  __shared__ float s_w[kA];
  int upper = 0;  // a nonzero term above the diagonal among this thread's
  for (int i = threadIdx.x; i < kA * kA; i += kThreads) {
    const int r = i / kA, c = i % kA;
    const float x = (r < n_assets && c < n_assets) ? chol[r * n_assets + c] : 0.0f;
    s_chol[i] = x;
    upper |= c > r && x != 0.0f;
  }
  for (int i = threadIdx.x; i < kA; i += kThreads) {
    s_mean[i] = i < n_assets ? mean[i] : 0.0f;
    s_w[i] = i < n_assets ? weights[i] : 0.0f;
  }
  const bool full = __syncthreads_or(upper);  // run L's whole rows

  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= block_paths) return;
  if (full) {
    narrow_path<kTier, kRebal, true>(p, blockIdx.y, seed, first_block, block_paths, n_assets,
                                     n_steps, df, neg2_over_df, s_chol, s_mean, s_w, term, port,
                                     max_dd);
  } else {
    narrow_path<kTier, kRebal, false>(p, blockIdx.y, seed, first_block, block_paths, n_assets,
                                      n_steps, df, neg2_over_df, s_chol, s_mean, s_w, term, port,
                                      max_dd);
  }
}

template <int kTier, bool kRebal>
int launch(dim3 grid, cudaStream_t s, long long seed, long long first_block, int block_paths,
           int n_assets, int n_steps, float df, float neg2_over_df, const float* chol,
           const float* mean, const float* w, float* term, float* port, float* dd) {
  if (n_assets <= kNarrow) {
    path_stats_narrow_kernel<kTier, kRebal><<<grid, kThreads, 0, s>>>(
        seed, first_block, block_paths, n_assets, n_steps, df, neg2_over_df, chol, mean, w,
        term, port, dd);
  } else {
    path_stats_kernel<kTier, kRebal, kMaxAssets, 1><<<grid, kThreads, 0, s>>>(
        seed, first_block, block_paths, n_assets, n_steps, df, neg2_over_df, chol, mean, w,
        term, port, dd);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int kTier>
int launch_mode(bool rebalance, dim3 grid, cudaStream_t s, long long seed,
                long long first_block, int block_paths, int n_assets, int n_steps, float df,
                float neg2_over_df, const float* chol, const float* mean, const float* w,
                float* term, float* port, float* dd) {
  return rebalance
             ? launch<kTier, true>(grid, s, seed, first_block, block_paths, n_assets, n_steps,
                                   df, neg2_over_df, chol, mean, w, term, port, dd)
             : launch<kTier, false>(grid, s, seed, first_block, block_paths, n_assets, n_steps,
                                    df, neg2_over_df, chol, mean, w, term, port, dd);
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` for blocks first_block+1 .. first_block+n_blocks.
// chol: (n_assets, n_assets), mean and weights: (n_assets,), float32 on the
// device. Outputs, float32: term (n_blocks, block_paths, n_assets) or null to
// skip it, port and dd (n_blocks, block_paths). tier: 0 poly, 1 poly_fast, 2
// Student-t (df, neg2_over_df = -2/df used only then); rebalance: 0 buy-and-hold,
// 1 rebalanced every step. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments the kernel does not take.
int mcport_path_stats(long long seed, long long first_block, int n_blocks, int block_paths,
                      int n_assets, int n_steps, int tier, int rebalance, float df,
                      float neg2_over_df, const void* chol, const void* mean,
                      const void* weights, void* term, void* port, void* dd, void* stream) {
  if (n_assets < 1 || n_assets > kMaxAssets || n_blocks < 1 || n_blocks > 65535 ||
      block_paths < 1 || n_steps < 0 || port == nullptr || dd == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((block_paths + kThreads - 1) / kThreads, n_blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(chol);
  const float* m = static_cast<const float*>(mean);
  const float* w = static_cast<const float*>(weights);
  float* t = static_cast<float*>(term);
  float* o = static_cast<float*>(port);
  float* d = static_cast<float*>(dd);
  switch (tier) {
    case kPoly:
      return launch_mode<kPoly>(rebalance != 0, grid, s, seed, first_block, block_paths,
                                n_assets, n_steps, df, neg2_over_df, l, m, w, t, o, d);
    case kPolyFast:
      return launch_mode<kPolyFast>(rebalance != 0, grid, s, seed, first_block, block_paths,
                                    n_assets, n_steps, df, neg2_over_df, l, m, w, t, o, d);
    case kStudentT:
      return launch_mode<kStudentT>(rebalance != 0, grid, s, seed, first_block, block_paths,
                                    n_assets, n_steps, df, neg2_over_df, l, m, w, t, o, d);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The same function past 64 assets: wide.cuh's layout with its GbmWide model
// and one candidate, the weights (the path-stats kernel is kernel #3 with one
// candidate, operation for operation). The arguments of mcport_path_stats,
// plus scratch (WIDE_CTAS·tp·A floats on the device), tp paths per tile and
// n_ctas persistent CTAs. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments the layout does not take.
int mcport_path_stats_wide(long long seed, long long first_block, int n_blocks,
                           int block_paths, int n_assets, int n_steps, int tier, int rebalance,
                           float df, float neg2_over_df, const void* chol, const void* mean,
                           const void* weights, void* term, void* port, void* dd,
                           void* scratch, int tp, int n_ctas, void* stream) {
  if (port == nullptr || dd == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  WideArgs g{seed, first_block, n_blocks, block_paths, n_assets, 1, n_steps, tp,
             static_cast<const float*>(weights), static_cast<float*>(scratch),
             static_cast<float*>(port), static_cast<float*>(dd), static_cast<float*>(term)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto model) {
    model.chol = static_cast<const float*>(chol);
    model.mean = static_cast<const float*>(mean);
    model.muj = model.sigj = model.hedge = nullptr;
    model.n_legs = 0;
    model.df = df;
    model.neg2_over_df = neg2_over_df;
    model.lam = 0.0f;
    return wide_launch(g, model, n_ctas, s);
  };
  auto by_mode = [&](auto tier_tag) {
    constexpr int kT = decltype(tier_tag)::value;
    return rebalance ? run(GbmWide<kT, kWideGross, kWideF32, false>{})
                     : run(GbmWide<kT, kWideHold, kWideF32, false>{});
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
