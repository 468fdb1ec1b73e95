// CCC-GARCH(1,1) paths on Hopper: the terminal simple returns of every asset
// (kernel garch_terminal_kernel) and W candidate portfolios' rebalanced wealth
// with its maximum drawdown (kernel garch_dd_kernel).
//
// Replaces mcport/ops/pallas_garch.py::_garch_kernel (the garch-risk main path)
// and ::_garch_dd_kernel, both modes (path-risk --models garch and the GARCH
// drawdown frontier, hedged or not). The plain torch forms of the same functions, on the
// same Philox counters, are mcport_torch/ops/garch.py::garch_terminal_reference
// and ::garch_multi_dd_reference.
//
// What they compute. For block b of a dispatch group and path p < block_paths,
// step by step: draw z (gbm_draws.cuh: the GBM kernels' shocks, STREAM_GBM),
// correlate zc = L_R z with the lower triangle of the correlation's Cholesky
// factor, then per asset
//   sigma2 = omega + alpha eps2_prev + beta sigma2   (from sigma2_0, eps2_0)
//   eps = sqrt(max(sigma2, 0)) zc,   r = mu + eps
// and either cum *= 1 + mu + eps (terminal: out cum - 1 per asset), or, for
// every candidate w, V *= 1 + w·r, peak = max(peak, V), dd = min(dd, V/peak - 1)
// from V_0 = peak_0 = 1, dd_0 = 0 (out V_T - 1 and dd per candidate and path).
// Hedged (kHedged, mcport's hedged branch, pallas_garch.py:137-167): each
// (asset, path) item also carries its price from s0, P_new = P·(1 + mu + eps)
// (rounded (1 + mu) + eps, as the plain form), writes hedged.cuh's settled
// return r_h(P, P_new) in place of r, and V *= 1 + w·r_h with peak and dd
// carrying a NaN of overflowed wealth; the legs are read from device memory.
// GARCH is nonlinear in the shocks, so unlike terminal_noise.cu it must
// correlate every step: it cannot sum the shocks first.
//
// What bounds them on the card. Per path-step and asset: the draw (a quarter of
// a Philox call and ~40 floating-point operations, kernel #1's 54.75
// instructions), the correlate's lower triangle ((A+1)/2 FMAs on average) and
// the GARCH update (an IEEE sqrt, ~6 FMAs); the candidate kernel adds W·A
// scoring FMAs per path-step. Nothing is read per step and each output is
// stored once, so both are bound by instruction issue. The designs:
// - terminal up to 16 assets: one thread per path, asset by asset within a
//   Philox call (garch_call; all loops over assets unrolled): the call's
//   shocks of every asset in registers, then per asset its row of L_R and its
//   (omega, alpha, beta, 1 + mu) (shared memory, 16-byte loads, once per
//   call) and its steps. sigma2 and the gross wait in the thread's slices of
//   shared memory, so that three 256-thread blocks fit an SM: the draw's and
//   the update's dependent chains leave it bound by latency more than by its
//   instruction count (PERF.md §6, #4), and more warps hide it. Whole calls
//   run without a step guard; a path's last, shorter call runs a copy of its
//   own. The unrolled correlate skips the zero upper triangle at compile
//   time: A(A+1)/2 FMAs per step, not A².
// - candidates up to 16 assets, the layout narrow_layout picks by W
//   (narrow_dd.cuh; ops/garch.py garch_narrow_plan): for few candidates a
//   thread per path (64 per block) runs the terminal kernel's recursion, one
//   Philox call's shocks and the variances in registers, and scores its own
//   candidates (garch_recur_kernel<hedged, kOwn>); for more the same
//   recursion writes its returns to a device scratch and scoring blocks (each
//   thread 4 candidates x 4 paths) read them (<hedged, kReturns>, then
//   narrow_dd.cuh's score_kernel). Hedged, the thread keeps its prices in a
//   slice of shared memory and settles leg by leg across the assets. Scores
//   are FP32 FMAs (mcport's score_dot is float32).
// - wider universes, 17 <= A <= 64: a path's state (A variances, A
//   compounded grosses and 4·A shocks) no longer fits one thread's
//   registers. The candidate kernel (garch_dd_kernel<64, hedged>) takes
//   multi_dd.cu's block design: a block owns 16 paths and all <= 256
//   candidates; each thread keeps the sigma2 of kItems = 4 (asset, path)
//   items of the tile in registers, draws the shocks of one Philox call into
//   shared memory, and per step correlates them and writes r = mu + eps to
//   shared memory; then each thread updates a 4-candidate x 4-path
//   micro-tile whose values, peaks and drawdowns stay in registers. The
//   terminal kernel takes the same tile (garch_terminal_tile_kernel): 16
//   paths per block, each (asset, path) item's sigma2 and gross in a
//   thread's registers, the Philox call's shocks in shared memory, one barrier
//   per four steps, the former narrow kernel's operations in their order
//   (its multiply-adds left to nvcc).
// A dispatch group of blocks is one launch (gridDim.y).
//
// Past 64 assets both functions run wide.cuh's layout with the GarchWide model
// below (sigma2, the gross or the hedged price in its device-memory scratch).
//
// The kernels read only the lower triangle of L_R (the plain forms do too).
// nvcc contracts a*b+c into FMA where the torch forms round twice, so kernels
// and plain forms agree to ulps, not bits (bound: ops/garch.py garch_shares).
// The recursion kernel up to 16 assets writes out the contractions nvcc made
// in the former candidate kernel up to 16 assets, garch_dd_kernel<16, *>
// (__fmaf_rn, __fmul_rn, __fadd_rn), so every layout's outputs are that
// kernel's bit for bit; the terminal kernel up to 16 assets writes out those
// of the former terminal kernel (the same four: read from its SASS, whose
// floating-point operations the written-out form repeats in order), so its
// outputs are that kernel's bit for bit in both tiers.

#include "gbm_draws.cuh"
#include "hedged.cuh"
#include "narrow_dd.cuh"
#include "wide.cuh"

namespace {

constexpr int kGA = 16;              // the narrow terminal kernel's asset bound
constexpr int kTermThreads = 256;    // the terminal kernel's block, and its blocks per SM:
constexpr int kTermMinBlocks = 3;    // 24 warps at <= 80 registers (tools/ab_narrow_kernels.py)
constexpr int kDdThreads = 256;
constexpr int kTileP = 16;           // paths per candidate block
constexpr int kMaxCand = 256;        // ops/garch.py MAX_CANDIDATES

// Four floats of shared memory, loaded anew at every use: the volatile load
// keeps the compiler from holding all of L_R in registers across the unrolled
// steps of a Philox call (path_stats.cu's lesson).
__device__ __forceinline__ float4 lds128(const float* p) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
  return v;
}

// The parameter block of ops/garch.py GarchTensors.packed: L (A·A), then mu,
// omega, alpha, beta, sigma2_0, eps2_0 (A each).
struct Params {
  const float *l, *mu, *omega, *alpha, *beta, *s2_0, *e2_0;
  __device__ Params(const float* p, int a)
      : l(p), mu(p + a * a), omega(mu + a), alpha(omega + a), beta(alpha + a),
        s2_0(beta + a), e2_0(s2_0 + a) {}
};

// The variance of the first step, as every later one: omega + alpha e2 + beta s2.
__device__ __forceinline__ float first_sigma2(const Params& q, int a) {
  return q.omega[a] + q.alpha[a] * q.e2_0[a] + q.beta[a] * q.s2_0[a];
}

// Loads L's lower triangle into s_l (kCap x kCap, zero elsewhere) and, per
// asset, (omega, alpha, beta, last) into s_g (kCap entries).
template <int kCap = kGA>
__device__ __forceinline__ void load_params(const Params& q, int a_n, bool one_plus_mu,
                                            float* s_l, float4* s_g, int tid, int n_threads) {
  for (int i = tid; i < kCap * kCap; i += n_threads) {
    const int r = i / kCap, c = i % kCap;
    s_l[i] = (r < a_n && c <= r) ? q.l[r * a_n + c] : 0.0f;
  }
  for (int i = tid; i < kCap; i += n_threads) {
    s_g[i] = i < a_n ? make_float4(q.omega[i], q.alpha[i], q.beta[i],
                                   one_plus_mu ? 1.0f + q.mu[i] : q.mu[i])
                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// One Philox call c of the terminal kernel's path, asset by asset: the shocks
// of every asset first, then for each asset in ascending order its row of L
// and its (omega, alpha, beta, 1 + mu) once, its (sigma2, gross) from the
// thread's slices of shared memory (ss, sc: asset i at i·kTermThreads), and
// its steps of the call. The operations are the former terminal kernel's with
// the multiply-adds nvcc contracted there written out: one fmaf per
// correlate term in column order, eps = sqrt(max(s2, 0))·y rounded, the gross
// times ((1 + mu) + eps), each rounded, sigma2' = fma(beta, s2, fma(alpha,
// eps², omega)). kTail: the last call of a path, of n < kPer steps.
template <int kTier, bool kTail>
__device__ __forceinline__ void garch_call(int c, int n, uint32_t p, uint32_t key, int n_assets,
                                           float df, float neg2_over_df, const float* s_l,
                                           const float4* s_g, volatile float* ss,
                                           volatile float* sc) {
  constexpr int kPer = steps_per_call<kTier>();
  float z[kPer][kGA];
#pragma unroll
  for (int a = 0; a < kGA; ++a) {
    float za[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (a < n_assets) call_draws<kTier>(c, a, p, key, kTail ? n : kPer, df, neg2_over_df, za);
#pragma unroll
    for (int k = 0; k < kPer; ++k) z[k][a] = za[k];
  }
#pragma unroll
  for (int i = 0; i < kGA; ++i) {
    if (i < n_assets) {
      float l[kGA];
#pragma unroll
      for (int j = 0; j <= i; j += 4) {  // row i's lower triangle
        const float4 v = lds128(s_l + i * kGA + j);
        l[j] = v.x;
        l[j + 1] = v.y;
        l[j + 2] = v.z;
        l[j + 3] = v.w;
      }
      const float4 g = lds128(reinterpret_cast<const float*>(s_g + i));
      float s2 = ss[i * kTermThreads], cum = sc[i * kTermThreads];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        if (kTail && k >= n) continue;
        float y = 0.0f;
#pragma unroll
        for (int j = 0; j <= i; ++j) y = fmaf(l[j], z[k][j], y);  // in column order
        const float eps = __fmul_rn(sqrtf(fmaxf(s2, 0.0f)), y);
        cum = __fmul_rn(cum, __fadd_rn(g.w, eps));
        s2 = __fmaf_rn(g.z, s2, __fmaf_rn(g.y, __fmul_rn(eps, eps), g.x));
      }
      ss[i * kTermThreads] = s2;
      sc[i * kTermThreads] = cum;
    }
  }
}

template <int kTier>
__global__ void __launch_bounds__(kTermThreads, kTermMinBlocks)
garch_terminal_kernel(long long seed, long long first_block, int block_paths, int n_assets,
                      int n_steps, float df, float neg2_over_df,
                      const float* __restrict__ params, float* __restrict__ out) {
  __shared__ __align__(16) float s_l[kGA * kGA];
  __shared__ float4 s_g[kGA];  // (omega, alpha, beta, 1 + mu)
  __shared__ float s_state[2 * kGA * kTermThreads];  // (sigma2, gross) per asset and thread
  const Params q(params, n_assets);
  load_params(q, n_assets, true, s_l, s_g, threadIdx.x, kTermThreads);
  __syncthreads();

  const int p = blockIdx.x * kTermThreads + threadIdx.x;
  if (p >= block_paths) return;
  const int b = blockIdx.y;
  const uint32_t key = block_key(seed, first_block, b);
  constexpr int kPer = steps_per_call<kTier>();
  volatile float* ss = s_state + threadIdx.x;  // this thread's slices: sigma2 (of the coming
  volatile float* sc = ss + kGA * kTermThreads;  // step), then the gross
#pragma unroll
  for (int a = 0; a < kGA; ++a) {
    ss[a * kTermThreads] = a < n_assets ? __fmaf_rn(q.beta[a], q.s2_0[a],
                                                    __fmaf_rn(q.alpha[a], q.e2_0[a], q.omega[a]))
                                        : 0.0f;
    sc[a * kTermThreads] = 1.0f;
  }
  const int whole = n_steps / kPer;
  for (int c = 0; c < whole; ++c) {
    garch_call<kTier, false>(c, kPer, p, key, n_assets, df, neg2_over_df, s_l, s_g, ss, sc);
  }
  if (n_steps % kPer) {
    garch_call<kTier, true>(whole, n_steps % kPer, p, key, n_assets, df, neg2_over_df, s_l, s_g,
                            ss, sc);
  }

  const long long row = static_cast<long long>(b) * block_paths + p;
#pragma unroll
  for (int a = 0; a < kGA; ++a) {
    if (a < n_assets) out[row * n_assets + a] = sc[a * kTermThreads] - 1.0f;
  }
}

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

struct DdLayout {  // offsets into dynamic shared memory, in floats, 16-byte aligned
  int l, g, w, z, e, total;
  __host__ __device__ DdLayout(int a, int w_pad, int cap) {
    l = 0;
    g = cap * cap;
    w = g + 4 * cap;
    z = w + a * w_pad;
    e = z + 4 * a * kTileP;
    total = e + a * kTileP;
  }
};

// The (asset, path) items of a 16-path tile per thread of the 256: one for A
// <= 16, four up to kMaxAssets (multi_dd.cu's mapping).
template <int kCap>
__host__ __device__ constexpr int tile_items() { return kCap * kTileP / kDdThreads; }

// The tile kernel for the terminal returns at 17 <= A <= 64: the candidate
// kernel's (asset, path) items without the scoring; each item's variance and
// gross stay in registers, the shocks of one Philox call in shared memory.
struct TileLayout {  // offsets into dynamic shared memory, in floats, 16-byte aligned
  int l, g, z, total;
  __host__ __device__ explicit TileLayout(int a) {
    l = 0;
    g = kMaxAssets * kMaxAssets;
    z = g + 4 * kMaxAssets;
    total = z + 4 * a * kTileP;
  }
};

template <int kTier>
__global__ void __launch_bounds__(kDdThreads, 2)
garch_terminal_tile_kernel(long long seed, long long first_block, int block_paths,
                           int n_assets, int n_steps, float df, float neg2_over_df,
                           const float* __restrict__ params, float* __restrict__ out) {
  constexpr int kIt = tile_items<kMaxAssets>();
  extern __shared__ __align__(16) float smem[];
  const int a_n = n_assets;
  const TileLayout lay(a_n);
  float* s_l = smem + lay.l;                              // (64, 64) lower triangle
  float4* s_g = reinterpret_cast<float4*>(smem + lay.g);  // (omega, alpha, beta, 1 + mu)
  float* s_z = smem + lay.z;                              // (4, A, kTileP) one call's shocks
  const int tid = threadIdx.x;
  const Params q(params, a_n);
  load_params<kMaxAssets>(q, a_n, true, s_l, s_g, tid, kDdThreads);

  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kTileP;
  const uint32_t key = block_key(seed, first_block, b);
  const int n_items = a_n * kTileP;
  float s2[kIt], cum[kIt];  // per item: the variance of the coming step, the gross
#pragma unroll
  for (int r = 0; r < kIt; ++r) {
    const int item = tid + r * kDdThreads;
    s2[r] = item < n_items ? first_sigma2(q, item / kTileP) : 0.0f;
    cum[r] = 1.0f;
  }
  __syncthreads();

  constexpr int kPer = steps_per_call<kTier>();
  for (int s0 = 0; s0 < n_steps; s0 += kPer) {
    const int n = min(kPer, n_steps - s0);
#pragma unroll
    for (int r = 0; r < kIt; ++r) {
      const int item = tid + r * kDdThreads;
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
      for (int r = 0; r < kIt; ++r) {
        const int item = tid + r * kDdThreads;
        if (item < n_items) {
          const int a = item / kTileP, p = item % kTileP;
          float y = 0.0f;
          for (int j = 0; j <= a; ++j) {  // row a's lower triangle, in column order
            y = fmaf(s_l[a * kMaxAssets + j], s_z[(k * a_n + j) * kTileP + p], y);
          }
          const float4 g = s_g[a];
          const float eps = sqrtf(fmaxf(s2[r], 0.0f)) * y;
          cum[r] *= g.w + eps;
          const float e2 = eps * eps;
          s2[r] = g.x + g.y * e2 + g.z * s2[r];
        }
      }
    }
    __syncthreads();  // the next call's draws overwrite s_z
  }

#pragma unroll
  for (int r = 0; r < kIt; ++r) {
    const int item = tid + r * kDdThreads;
    const int a = item / kTileP, p = p0 + item % kTileP;
    if (item < n_items && p < block_paths) {
      out[(static_cast<long long>(b) * block_paths + p) * a_n + a] = cum[r] - 1.0f;
    }
  }
}

// The candidate kernel of 17-64 assets (and of any width up to 64 with
// `wide`). kCap: the asset bound, kMaxAssets (four (asset, path) items per
// thread); up to 16 assets the layouts above run instead.
template <int kCap, bool kHedged>
__global__ void __launch_bounds__(kDdThreads, 2)
garch_dd_kernel(long long seed, long long first_block, int block_paths, int n_assets,
                int n_cand, int n_steps, int n_legs, const float* __restrict__ params,
                const float* __restrict__ weights, const float* __restrict__ hedge,
                float* __restrict__ term, float* __restrict__ max_dd) {
  constexpr int kIt = tile_items<kCap>();
  extern __shared__ __align__(16) float smem[];
  const int a_n = n_assets;
  const int w_pad = round4(n_cand);
  const DdLayout lay(a_n, w_pad, kCap);
  float* s_l = smem + lay.l;                            // (kCap, kCap) lower triangle
  float4* s_g = reinterpret_cast<float4*>(smem + lay.g);  // (omega, alpha, beta, mu)
  float* s_w = smem + lay.w;                            // (A, w_pad) weights
  float* s_z = smem + lay.z;                            // (4, A, kTileP) one Philox call's shocks
  float* s_e = smem + lay.e;                            // (A, kTileP) r = mu + eps

  const int tid = threadIdx.x;
  const Params q(params, a_n);
  load_params<kCap>(q, a_n, false, s_l, s_g, tid, kDdThreads);
  for (int i = tid; i < a_n * w_pad; i += kDdThreads) {
    const int a = i / w_pad, w = i % w_pad;
    s_w[i] = w < n_cand ? weights[w * a_n + a] : 0.0f;
  }

  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kTileP;
  const uint32_t key = block_key(seed, first_block, b);
  // this thread's (asset, path) items of the tile: item tid + r·256, asset
  // item / 16, path item % 16
  const int n_items = a_n * kTileP;
  float s2[kIt];
  float price[kIt];  // hedged: each item's price, from s0
#pragma unroll
  for (int r = 0; r < kIt; ++r) {
    const int item = tid + r * kDdThreads;
    s2[r] = item < n_items ? first_sigma2(q, item / kTileP) : 0.0f;
    price[r] = (kHedged && item < n_items) ? hedge[item / kTileP] : 0.0f;
  }
  const HedgeBlock legs(hedge, a_n, n_legs);  // hedged: the legs, read from device memory

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

  constexpr int kPer = steps_per_call<kPoly>();
  for (int s0 = 0; s0 < n_steps; s0 += kPer) {
    const int n = min(kPer, n_steps - s0);
#pragma unroll
    for (int r = 0; r < kIt; ++r) {
      const int item = tid + r * kDdThreads;
      if (item < n_items) {
        const int ia = item / kTileP, ip = item % kTileP;
        float za[4];
        call_draws<kPoly>(s0 / kPer, ia, p0 + ip, key, n, 0.0f, 0.0f, za);
#pragma unroll
        for (int k = 0; k < kPer; ++k) s_z[(k * a_n + ia) * kTileP + ip] = za[k];
      }
    }
    __syncthreads();

    for (int k = 0; k < n; ++k) {
#pragma unroll
      for (int r = 0; r < kIt; ++r) {
        const int item = tid + r * kDdThreads;
        if (item < n_items) {
          const int ia = item / kTileP, ip = item % kTileP;
          float y = 0.0f;
          for (int j = 0; j <= ia; ++j) {
            y = fmaf(s_l[ia * kCap + j], s_z[(k * a_n + j) * kTileP + ip], y);
          }
          const float4 g = s_g[ia];
          const float eps = sqrtf(fmaxf(s2[r], 0.0f)) * y;
          if (kHedged) {  // the settled return of the move P -> P·(1 + mu + eps)
            const float p_new = price[r] * (1.0f + g.w + eps);
            s_e[ia * kTileP + ip] = hedged_return(legs, ia, price[r], p_new);
            price[r] = p_new;
          } else {
            s_e[ia * kTileP + ip] = g.w + eps;
          }
          const float e2 = eps * eps;
          s2[r] = g.x + g.y * e2 + g.z * s2[r];
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
          const float4 w4 = *reinterpret_cast<const float4*>(s_w + a * w_pad + 4 * cw);
          const float4 e4 = *reinterpret_cast<const float4*>(s_e + a * kTileP + 4 * pq);
          const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
          const float ev[4] = {e4.x, e4.y, e4.z, e4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j) f[i][j] = fmaf(wv[i], ev[j], f[i][j]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            v[i][j] = v[i][j] * (1.0f + f[i][j]);
            if (kHedged) {  // wealth may overflow: NaN carries on (hedged.cuh)
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

// ---- kernel #5 up to 16 assets: the redesigned layouts (narrow_dd.cuh) -----------------

// Where the layouts switch (ops/garch.py garch_narrow_plan mirrors it): a
// thread per path scores its own candidates up to kSoloMaxCand, the split
// layout past that. Measured on an H100 at 15 assets and 131,072 x 252
// (tools/ab_narrow_kernels.py): solo is the faster up to 13 candidates in
// both modes (by 1.3%, hedged 0.3%, at 13) and split from 14; split beat the
// former candidate kernel (garch_dd_kernel<16, *>, a 16-path tile) at every
// W, by 11% at 256 (3% hedged), which this file therefore no longer
// instantiates.
constexpr int kSoloMaxCand = 13;

__host__ __device__ constexpr int narrow_layout(int n_cand) {
  return n_cand <= kSoloMaxCand ? kSolo : kSplit;
}

// The recursion part's shared memory, in floats: L's lower triangle (kGA x
// kGA, zero elsewhere), per asset (omega, alpha, beta, mu), the hedge block
// (hedged), the solo part's weights (W, kNA); then per thread slices (stride
// kSoloThreads): the prices (kNA, hedged) and the solo part's values, peaks
// and drawdowns (3 x W).
struct RecurLayout {
  int l, g, h, w, p, st, total;
  __host__ __device__ RecurLayout(int n, int n_cand, int mode, int n_legs) {
    l = 0;
    g = kGA * kGA;
    h = g + 4 * kGA;
    w = h + (n_legs ? round4n(hedge_floats(n, n_legs)) : 0);
    p = w + (mode == kOwn ? n_cand * kNA : 0);
    st = p + (n_legs ? kNA * kSoloThreads : 0);
    total = st + (mode == kOwn ? 3 * n_cand * kSoloThreads : 0);
  }
};

// The recursion, a thread per path, for chunk paths 0 .. chunk-1 (path
// first_path + cp of each dispatch block): the per-path operations of the
// former candidate kernel up to 16 assets in their order, with the
// contractions nvcc made there written out (read from its SASS) — the
// shocks of one Philox call in
// registers (all loops over assets unrolled), the correlate one fmaf per term
// of row i's lower triangle, sigma2_1 = fma(beta, s2_0, fma(alpha, e2_0,
// omega)), eps = sqrt(max(s2, 0))·y rounded, the return mu + eps, not
// contracted (hedged: the price P·((1 + mu) + eps) and the settled return),
// sigma2' = fma(beta, s2, fma(alpha, eps², omega)).
// kOwn scores the thread's own candidates (narrow_dd.cuh solo_score),
// kReturns writes the returns to rets (returns_slot).
template <bool kHedged, int kMode>
__global__ void __launch_bounds__(kSoloThreads, 4)
garch_recur_kernel(long long seed, long long first_block, int block_paths, int first_path,
                   int chunk, int n_assets, int n_cand, int n_steps, int n_legs,
                   const float* __restrict__ params, const float* __restrict__ weights,
                   const float* __restrict__ hedge, float* __restrict__ rets,
                   float* __restrict__ term, float* __restrict__ max_dd) {
  constexpr int kS = kSoloThreads;  // the per-thread slices' stride
  extern __shared__ __align__(16) float smem[];
  const int n = n_assets, tid = threadIdx.x, blk = blockIdx.y;
  const RecurLayout lay(n, n_cand, kMode, kHedged ? n_legs : 0);
  float* s_l = smem + lay.l;
  float4* s_g = reinterpret_cast<float4*>(smem + lay.g);  // (omega, alpha, beta, mu)
  float* s_h = smem + lay.h;
  float* s_w = smem + lay.w;
  const Params q(params, n);
  load_params<kGA>(q, n, false, s_l, s_g, tid, kS);
  if (kHedged) {
    for (int i = tid; i < hedge_floats(n, n_legs); i += kS) s_h[i] = hedge[i];
  }
  if (kMode == kOwn) {
    for (int i = tid; i < n_cand * kNA; i += kS) {
      const int c = i / kNA, a = i % kNA;
      s_w[i] = a < n ? weights[c * n + a] : 0.0f;
    }
  }
  __syncthreads();

  const int cp = blockIdx.x * kS + tid;  // this thread's path of the chunk
  const uint32_t p = static_cast<uint32_t>(first_path + cp);
  const uint32_t key = block_key(seed, first_block, blk);
  const HedgeBlock legs(s_h, n, n_legs);
  float* s_p = smem + lay.p + tid;  // hedged: the prices, from s0
  float* s_st = smem + lay.st + tid;
  if (kHedged) {
    for (int a = 0; a < n; ++a) s_p[a * kS] = s_h[a];
  }
  if (kMode == kOwn) solo_start(n_cand, s_st);
  float* rg = kMode == kReturns ? returns_slot(rets, blk, chunk, cp, n_steps, n) : nullptr;
  const bool writes = cp < (chunk + kTile - 1) / kTile * kTile;  // whole tiles of the scratch
  float s2[kGA];  // the variance of the coming step
#pragma unroll
  for (int a = 0; a < kGA; ++a) {
    s2[a] = a < n ? __fmaf_rn(q.beta[a], q.s2_0[a], __fmaf_rn(q.alpha[a], q.e2_0[a], q.omega[a]))
                  : 0.0f;
  }
  constexpr int kPer = steps_per_call<kPoly>();
  for (int s0 = 0; s0 < n_steps; s0 += kPer) {
    const int nk = min(kPer, n_steps - s0);
    float z[kPer][kGA];
#pragma unroll
    for (int a = 0; a < kGA; ++a) {
      float za[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (a < n) call_draws<kPoly>(s0 / kPer, a, p, key, nk, 0.0f, 0.0f, za);
#pragma unroll
      for (int k = 0; k < kPer; ++k) z[k][a] = za[k];
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (k >= nk) continue;  // (not break: a loop that may break is not unrolled)
      float e[kNA];
#pragma unroll
      for (int i = 0; i < kGA; ++i) {
        e[i] = 0.0f;
        if (i < n) {
          float y = 0.0f;
#pragma unroll
          for (int j = 0; j <= i; j += 4) {  // row i's lower triangle only, in column order
            const float4 l = lds128(s_l + i * kGA + j);
            y = fmaf(l.x, z[k][j], y);
            if (j + 1 <= i) y = fmaf(l.y, z[k][j + 1], y);
            if (j + 2 <= i) y = fmaf(l.z, z[k][j + 2], y);
            if (j + 3 <= i) y = fmaf(l.w, z[k][j + 3], y);
          }
          const float4 g = lds128(reinterpret_cast<const float*>(s_g + i));
          const float eps = __fmul_rn(sqrtf(fmaxf(s2[i], 0.0f)), y);
          // hedged: the move P -> P·((1 + mu) + eps), settled below
          e[i] = kHedged ? __fmul_rn(s_p[i * kS], __fadd_rn(__fadd_rn(1.0f, g.w), eps))
                         : __fadd_rn(g.w, eps);
          s2[i] = __fmaf_rn(g.z, s2[i], __fmaf_rn(g.y, __fmul_rn(eps, eps), g.x));
        }
      }
      if (kHedged) settle_all<kS>(legs, n, s_p, e);
      if (kMode == kOwn) {
        solo_score<kHedged ? kSimpleNan : kSimple>(n, n_cand, s_w, s_st, e);
      } else if (writes) {
#pragma unroll
        for (int i = 0; i < kGA; ++i) {
          if (i < n) rg[((s0 + k) * n + i) * kTile] = e[i];
        }
      }
    }
  }
  if (kMode == kOwn && cp < chunk) solo_store(n_cand, blk, block_paths, p, s_st, term, max_dd);
}

// Kernels #4 and #5 past 64 assets: wide.cuh's layout with the narrow
// kernels' arithmetic, operation for operation. State: the terminal's
// (sigma2, gross), the candidates' sigma2 and, hedged, the price.
template <int kTier, bool kCand, bool kHedged>
struct GarchWide : WideModelBase {
  static constexpr int kState = (kCand && !kHedged) ? 1 : 2;
  static constexpr int kPer = steps_per_call<kTier>();
  static constexpr int kValue = kHedged ? kWideHedged : kWideSimple;
  const float *params, *hedge;  // GarchTensors.packed; the hedge block
  int n_legs;
  float df, neg2_over_df;

  __host__ __device__ static int smem_floats(int a, int tp) { return kPer * a * tp; }
  __device__ void start(const WideTile& t, int a, int p) const {
    t.at(0, a, p) = first_sigma2(Params(params, t.a_n), a);
    if (kState == 2) t.at(1, a, p) = kHedged ? __ldg(hedge + a) : 1.0f;
  }
  __device__ void draw(const WideTile& t, float* s, int call, int n, int a, int p) const {
    float za[4];
    wide_draw<kTier>(t, s, call, n, a, p, df, neg2_over_df, za);
  }
  __device__ float step(const WideTile& t, float* s, int k, int a, int p) const {
    const Params q(params, t.a_n);
    const float y = wide_correlate(q.l, s, t, k, a, p, a + 1);  // row a's lower triangle
    const float mu = __ldg(q.mu + a);
    float& s2 = t.at(0, a, p);
    const float eps = sqrtf(fmaxf(s2, 0.0f)) * y;
    float e = 0.0f;
    if (!kCand) {
      float& cum = t.at(1, a, p);
      cum *= (1.0f + mu) + eps;
    } else if (kHedged) {
      float& price = t.at(1, a, p);
      const float p_new = price * (1.0f + mu + eps);
      e = hedged_return(HedgeBlock(hedge, t.a_n, n_legs), a, price, p_new);
      price = p_new;
    } else {
      e = mu + eps;
    }
    const float e2 = eps * eps;
    s2 = __ldg(q.omega + a) + __ldg(q.alpha + a) * e2 + __ldg(q.beta + a) * s2;
    return e;
  }
  __device__ float out(const WideTile& t, int a, int p) const { return t.at(1, a, p) - 1.0f; }
};

}  // namespace

extern "C" {

// Launches the terminal kernel on `stream` for blocks first_block+1 ..
// first_block+n_blocks. params: ops/garch.py GarchTensors.packed, float32 on the
// device (L with the t scale folded in). Output out: (n_blocks, block_paths,
// n_assets) float32. tier: 0 poly, 2 Student-t (df, neg2_over_df = -2/df used
// only then). wide: nonzero runs the tile kernel of 17-64 assets at any width
// (to time it against the narrow one). Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for arguments the kernel does not take.
int mcport_garch_terminal(long long seed, long long first_block, int n_blocks, int block_paths,
                          int n_assets, int n_steps, int wide, int tier, float df,
                          float neg2_over_df, const void* params, void* out, void* stream) {
  if (n_assets < 1 || n_assets > kMaxAssets || n_blocks < 1 || n_blocks > 65535 ||
      block_paths < 1 || n_steps < 0 || kMaxAssets * kTileP > 4 * kDdThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* q = static_cast<const float*>(params);
  float* o = static_cast<float*>(out);
  if (n_assets > kGA || wide) {
    const dim3 grid((block_paths + kTileP - 1) / kTileP, n_blocks);
    const size_t smem = sizeof(float) * TileLayout(n_assets).total;
    auto run = [&](auto kernel) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      kernel<<<grid, kDdThreads, smem, s>>>(seed, first_block, block_paths, n_assets, n_steps,
                                            df, neg2_over_df, q, o);
      return static_cast<int>(cudaGetLastError());
    };
    switch (tier) {
      case kPoly:
        return run(garch_terminal_tile_kernel<kPoly>);
      case kStudentT:
        return run(garch_terminal_tile_kernel<kStudentT>);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const dim3 grid((block_paths + kTermThreads - 1) / kTermThreads, n_blocks);
  switch (tier) {
    case kPoly:
      garch_terminal_kernel<kPoly><<<grid, kTermThreads, 0, s>>>(
          seed, first_block, block_paths, n_assets, n_steps, df, neg2_over_df, q, o);
      break;
    case kStudentT:
      garch_terminal_kernel<kStudentT><<<grid, kTermThreads, 0, s>>>(
          seed, first_block, block_paths, n_assets, n_steps, df, neg2_over_df, q, o);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches the candidate function on `stream` for blocks first_block+1 ..
// first_block+n_blocks. params: GarchTensors.packed; weights: (n_cand,
// n_assets); float32 on the device. hedge: ops/hedged.py HedgeTensors.packed
// for n_legs legs per asset, or null with n_legs 0 for the unhedged mode.
// Outputs term and dd: (n_blocks, n_cand, block_paths) float32. Normal shocks
// (the poly tier). Up to 16 assets the layout is narrow_layout(n_cand)
// (layout -1), or the one named (0 solo, 1 split); the split layout takes its
// returns through scratch (scratch_floats floats on the
// device) in chunks of paths that it holds for every block and step (a
// multiple of 64 paths; ops/garch.py garch_narrow_plan sizes it), the others
// take no scratch (null, 0). From 17 assets, or with wide nonzero at any
// width, the 64-asset instantiation runs (the hedge read from device memory;
// layout -1). Returns cudaGetLastError() after the last launch, or
// cudaErrorInvalidValue for arguments the kernel does not take (among them a
// layout whose block the shared memory cannot hold).
int mcport_garch_multi_dd(long long seed, long long first_block, int n_blocks,
                          int block_paths, int n_assets, int n_cand, int n_steps, int wide,
                          int n_legs, const void* params, const void* weights,
                          const void* hedge, void* term, void* dd, void* scratch,
                          long long scratch_floats, int layout, void* stream) {
  if (n_assets < 1 || n_assets > kMaxAssets || n_cand < 1 || n_cand > kMaxCand ||
      n_blocks < 1 || n_blocks > 65535 || block_paths < 1 || n_steps < 0 || n_legs < 0 ||
      (n_legs > 0 && hedge == nullptr) ||
      kMaxAssets * kTileP != tile_items<kMaxAssets>() * kDdThreads || scratch_floats < 0 ||
      layout < -1 || layout > kSplit || ((wide || n_assets > kGA) && layout >= 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static_assert(kGA == kNA && kMaxCand / 4 * score_groups(kMaxCand) <= kScoreThreads &&
                    4 * score_groups(kMaxCand) % kTile == 0 && kSoloThreads % kTile == 0,
                "the redesigned layouts' universe; a scoring block covers 256 candidates of "
                "whole tiles");
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* prm = static_cast<const float*>(params);
  const float* wts = static_cast<const float*>(weights);
  const float* hdg = static_cast<const float*>(hedge);
  float *out = static_cast<float*>(term), *out_dd = static_cast<float*>(dd);
  // one launch of `kernel` with `smem` bytes of dynamic shared memory
  auto start = [&](auto kernel, size_t smem) {
    if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(cudaFuncSetAttribute(kernel,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem)));
  };
  if (wide || n_assets > kGA) {  // garch_dd_kernel<kMaxAssets>, the 17-64-asset layout
    const dim3 grid((block_paths + kTileP - 1) / kTileP, n_blocks);
    const size_t smem = sizeof(float) * DdLayout(n_assets, round4(n_cand), kMaxAssets).total;
    auto run = [&](auto kernel) {
      int err = start(kernel, smem);
      if (err) return err;
      kernel<<<grid, kDdThreads, smem, st>>>(seed, first_block, block_paths, n_assets, n_cand,
                                             n_steps, n_legs, prm, wts, hdg, out, out_dd);
      return static_cast<int>(cudaGetLastError());
    };
    return n_legs ? run(garch_dd_kernel<kMaxAssets, true>)
                  : run(garch_dd_kernel<kMaxAssets, false>);
  }
  if (layout < 0) layout = narrow_layout(n_cand);
  float* r = static_cast<float*>(scratch);
  // the recursion over chunk paths from `first`, scoring its own candidates
  // (kOwn) or writing their returns to the scratch (kReturns)
  auto recur = [&](auto kernel, int mode, int first, int chunk) {
    const size_t smem = sizeof(float) * RecurLayout(n_assets, n_cand, mode, n_legs).total;
    int err = start(kernel, smem);
    if (err) return err;
    const dim3 grid((chunk + kSoloThreads - 1) / kSoloThreads, n_blocks);
    kernel<<<grid, kSoloThreads, smem, st>>>(seed, first_block, block_paths, first, chunk,
                                             n_assets, n_cand, n_steps, n_legs, prm, wts, hdg,
                                             r, out, out_dd);
    return static_cast<int>(cudaGetLastError());
  };
  if (layout == kSolo) {
    return n_legs ? recur(garch_recur_kernel<true, kOwn>, kOwn, 0, block_paths)
                  : recur(garch_recur_kernel<false, kOwn>, kOwn, 0, block_paths);
  }
  // the split layout: the paths of a chunk are every path where the scratch
  // holds them all (in whole 16-path tiles), else what it holds in whole
  // recursion blocks
  const long long per_path = static_cast<long long>(n_blocks) * n_steps * n_assets;
  const long long all = (block_paths + kTile - 1) / kTile * kTile;
  long long chunk = block_paths;
  if (per_path > 0 && scratch_floats / per_path < all) {
    chunk = scratch_floats / per_path / kSoloThreads * kSoloThreads;
  }
  if (chunk < 1 || (per_path > 0 && r == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  const int paths = 4 * score_groups(n_cand);
  const size_t score_smem = sizeof(float) * score_floats(n_assets, n_cand);
  for (int first = 0; first < block_paths; first += static_cast<int>(chunk)) {
    const int m = static_cast<int>(chunk < block_paths - first ? chunk : block_paths - first);
    int err = n_steps == 0 ? 0
              : n_legs     ? recur(garch_recur_kernel<true, kReturns>, kReturns, first, m)
                           : recur(garch_recur_kernel<false, kReturns>, kReturns, first, m);
    if (err) return err;
    auto score = [&](auto kernel) {
      int e = start(kernel, score_smem);
      if (e) return e;
      const dim3 grid((m + paths - 1) / paths, n_blocks);
      kernel<<<grid, kScoreThreads, score_smem, st>>>(block_paths, first, m, n_assets, n_cand,
                                                      n_steps, wts, r, out, out_dd);
      return static_cast<int>(cudaGetLastError());
    };
    err = n_legs ? score(score_kernel<kSimpleNan>) : score(score_kernel<kSimple>);
    if (err) return err;
  }
  return 0;
}

// Both functions past 64 assets (wide.cuh's layout with the GarchWide model):
// n_cand 0 runs the terminal function (tier 0 poly or 2 Student-t, df and
// neg2_over_df as mcport_garch_terminal's; output out (n_blocks, block_paths,
// n_assets)), n_cand >= 1 the candidates' (normal shocks; hedged when n_legs
// > 0, the hedge block read from device memory; outputs out and dd (n_blocks,
// n_cand, block_paths)). scratch: WIDE_CTAS·tp·A·2 floats on the device, tp
// paths per tile, n_ctas persistent CTAs. Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for arguments the layout does not take.
int mcport_garch_wide(long long seed, long long first_block, int n_blocks, int block_paths,
                      int n_assets, int n_cand, int n_steps, int tier, float df,
                      float neg2_over_df, int n_legs, const void* params, const void* weights,
                      const void* hedge, void* out, void* dd, void* scratch, int tp, int n_ctas,
                      void* stream) {
  if (n_cand < 0 || n_cand > kMaxCand || n_legs < 0 || (n_legs > 0 && hedge == nullptr) ||
      (n_cand > 0 && tier != kPoly)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool cand = n_cand > 0;
  WideArgs g{seed, first_block, n_blocks, block_paths, n_assets, n_cand, n_steps, tp,
             static_cast<const float*>(weights), static_cast<float*>(scratch),
             cand ? static_cast<float*>(out) : nullptr, static_cast<float*>(dd),
             cand ? nullptr : static_cast<float*>(out)};
  auto run = [&](auto model) {
    model.params = static_cast<const float*>(params);
    model.hedge = static_cast<const float*>(hedge);
    model.n_legs = n_legs;
    model.df = df;
    model.neg2_over_df = neg2_over_df;
    return wide_launch(g, model, n_ctas, static_cast<cudaStream_t>(stream));
  };
  if (cand) {
    return n_legs ? run(GarchWide<kPoly, true, true>{}) : run(GarchWide<kPoly, true, false>{});
  }
  switch (tier) {
    case kPoly:
      return run(GarchWide<kPoly, false, false>{});
    case kStudentT:
      return run(GarchWide<kStudentT, false, false>{});
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
