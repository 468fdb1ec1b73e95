// DCC-GARCH(1,1) paths on Hopper: the terminal simple returns of every asset
// (kernel dcc_terminal_kernel) and W candidate portfolios' rebalanced wealth
// with its maximum drawdown (kernel dcc_dd_kernel), up to 16 assets; from 17
// on both functions in dcc_group_kernel.
//
// dcc_terminal_kernel replaces mcport/ops/pallas_dcc.py::_dcc_pack_kernel (the
// garch-risk --correlation dcc and compare-models path) and ::_dcc_kernel (the
// same function in the TPU's tile layout); dcc_dd_kernel replaces
// ::_dcc_dd_kernel, both its modes (path-risk --models dcc, the DCC drawdown
// frontier and path_tail_risk, hedged or not), and ::_dcc_pack_dd_kernel (the
// unhedged function, scored in the TPU's pack layout, which takes no hedge);
// dcc_group_kernel replaces all four past 16 assets. Pack and tile are TPU
// layouts; on the card each function is one kernel.
// The plain torch forms of the same functions, on the same Philox counters,
// are mcport_torch/ops/dcc.py::dcc_terminal_reference and
// ::dcc_multi_dd_reference.
//
// What they compute (pallas_dcc.py::_make_pack_asset_step). For block b of a
// dispatch group and path p < block_paths, from Q = q0, e = e0 and the GARCH
// state (sigma2_0, eps2_0), step by step: draw z (gbm_draws.cuh: the GBM
// kernels' shocks on STREAM_GBM, the same (path, step, asset) mapping as
// garch.cu), then
//   Q      = (1-a-b) S + a e e' + b Q          (lower triangle)
//   L      = chol(Q)                           (pivot floor rsqrt(max(d, 1e-12)))
//   e_new  = diag(Q)^{-1/2} (L z)              (chol(R) = D^{-1/2} chol(Q))
//   sigma2 = omega + alpha eps2 + beta sigma2,  eps = sqrt(max(sigma2, 0)) e_new
//   r = mu + eps,  eps2 = eps^2,  e = e_new
// and either cum *= 1 + mu + eps (terminal: out cum - 1 per asset), or, for
// every candidate w, V *= 1 + w·r, peak = max(peak, V), dd = min(dd, V/peak - 1)
// from V_0 = peak_0 = 1, dd_0 = 0 (out V_T - 1 and dd per candidate and path).
// Hedged (kHedged, mcport's hedged branch, pallas_dcc.py:378-406): each
// (asset, path) also carries its price from s0, P_new = P·((1 + mu) + eps)
// (one rounded sum and one rounded product, as the plain form and the
// terminal's cum), writes hedged.cuh's settled return r_h(P, P_new) in place
// of r, and V *= 1 + w·r_h with peak and dd carrying a NaN of overflowed
// wealth; the legs are read from device memory. The DCC recursion is the
// unhedged mode's, so the price differs from the plain form's by the draws'
// and the recursion's roundings (bound: ops/dcc.py dcc_price_bound, along
// each path). The Cholesky subtracts its sums in ascending k, as the plain
// form does; the reciprocal square roots are correctly rounded (__frsqrt_rn),
// as the plain form's are. With a = b = 0 and q0 = S the recursion is CCC-GARCH on the same
// shocks: garch.cu's terminal kernel up to the float32 Cholesky of S.
//
// What bounds them on the card. Per path-step at A assets: the draws (A x
// kernel #1's 54.75 instructions), the Q update (~3 per entry of the
// triangle), the Cholesky (A(A^2-1)/6 FMAs, A(A-1)/2 multiplies, A rsqrt),
// the correlate (A(A+1)/2 FMAs) and the rescale, GARCH and compounding (~9 per
// asset); the candidate kernel adds W·(A + 6) for the score. Nothing is read
// per step and each output is stored once: both are bound by instruction
// issue. The designs, for A <= 16:
// - terminal: one thread per path, the instruction-minimal form. A path
//   carries 136 Q floats, 136 of L, and its per-asset state: past the 255
//   registers of a thread. Q lives in shared memory, element-major
//   (s_q[k * blockDim + tid], so a warp's 32 paths hit 32 banks), and so do
//   the shocks of one Philox call (4 steps x 16 assets); the Cholesky runs in
//   place on a register copy of the step's Q (all loops over assets unrolled,
//   the zero upper triangle skipped at compile time), beside e, sigma2 and
//   cum. 100 KB of shared memory per 128 threads: two blocks per SM.
// - candidates: the terminal kernel's recursion, a thread per path (64 per
//   block, 4 blocks per SM: 8 warps). Up to 4 candidates (the path-risk
//   engine's W = 1) the thread scores its own candidates from the step's
//   returns in registers, their values, peaks and drawdowns in shared memory:
//   one launch, no barrier. Past 4 a thread cannot hold 256 candidates'
//   state, and the few paths an SM could hold would leave the recursion's
//   latency bare (a producer warp of 32 paths feeding 8 scoring warps, one
//   block per SM, was slower on an H100 than a half-warp per path): the
//   recursion writes every step's returns to a device scratch, tile-major
//   (16 paths of a step and asset contiguous; the chunk's paths where the
//   scratch holds fewer than all), and 256-thread blocks score them from
//   shared memory, each thread 4 candidates x 4 paths, the block as many
//   paths as ceil(W/4) candidate groups leave threads (16 at W = 256, 512 at
//   W = 5-8). The score is one FP32 fmaf per asset, ascending from 0.0f
//   (mcport's score_dot is float32). Hedged, the price lives in shared
//   memory and every asset's legs settle leg by leg across the assets
//   (hedged.cuh's operations, branch-free), the legs staged in shared
//   memory.
// From 17 assets on (dcc_group_kernel, both functions, any width): a
// path's triangle no longer fits a thread's registers or a half-warp's. A
// group of kG threads owns a path: a warp up to 32 assets, 64 threads up to
// 64, 128 up to 128, the whole 256-thread block past that (256/kG paths per
// block; a barrier per group: __syncwarp, a named barrier over the group's
// warps, or __syncthreads). Q and the Cholesky factor are lower triangles of
// 4 x 4 tiles, stored tile column by tile column, a tile's column one float4
// (the factor's tiles padded to 20 floats, so that neighbouring tiles' float4
// fall on distinct banks). Per step, by panels of nb = 4 columns (one tile
// column; nb = 8, two tile columns, past 128 assets):
// - the Q update, tile by tile over the group; the thread that updates the
//   corner tile (0, 0) factors it at once in registers;
// - per panel: each tile below the factored corner (kt, kt) solves against
//   it, one thread per tile (the pivots' reciprocals computed once, by the
//   corner's thread); a barrier; every thread updates its 4 x 4 tiles of the
//   trailing triangle in registers with the panel's products (two float4
//   loads per 16 FMAs), the thread that owns the next corner first, which it
//   then factors while the others update; a barrier. With nb = 8 the
//   panel's second tile column first takes the first one's products (its
//   corner factored) and its tiles below solve, two more barriers; the
//   trailing triangle then takes 8 products per load and store of a tile.
//   Two barriers per 4 columns (128 per step at A = 256, where a
//   left-looking sweep needs one per column), and every column's pivot
//   computed once;
// - e = D^{-1/2} (L z), the GARCH update and the gross or r = mu + eps (hedged:
//   hedged.cuh's settled r_h) row by row; then the block's candidates, one per
//   thread, score its paths (weights transposed, through the read-only cache;
//   one block barrier per step, the returns double-buffered).
// Every entry of the factor starts from Q_rc and receives its products
// L_rk·L_ck one fmaf at a time in ascending k, within and across panels; the
// pivot is __frsqrt_rn(fmaxf(d, 1e-12f)), L_rc = num·inv: the narrow kernels'
// arithmetic in another schedule, bit for bit what a left-looking sweep of
// the same sums gives. Where the data lives (GroupLayout): a path's Q and
// factor in shared memory while the block holds them (up to 220 assets);
// past that Q moves to the CTA's slot of a device-memory scratch (at A = 256,
// 132 slots of 133 KB: 17.6 MB, inside the 50 MB L2), and past 292 assets
// the factor too. The CTAs are persistent, as many as the occupancy calculator fits on
// the SMs, each walking units of 256/kG paths gridDim.x apart; c0·S is read
// from the parameter block as it is needed. What bounds it: the trailing
// updates' shared-memory traffic (per tile and 4-column panel 12 float4
// loads and 4 stores for 64 FMAs; 20 and 4 for 128 with nb = 8), then the
// panels' serial chain (a corner's four dependent pivots, the solve)
// wherever one path fills the SM.
// A dispatch group of blocks is one launch (the narrow kernels' gridDim.y;
// dcc_group_kernel's units span the group's blocks).
//
// nvcc contracts a*b+c into FMA where the torch forms round twice, so kernels
// and plain forms agree to ulps, not bits (bound: ops/dcc.py dcc_shares).

#include "gbm_draws.cuh"
#include "wide.cuh"

namespace {

constexpr int kDA = 16;                      // the narrow kernels' asset bound
constexpr int kTri = kDA * (kDA + 1) / 2;    // entries of a lower triangle
constexpr int kTermThreads = 128;
constexpr int kMaxCand = 256;                // ops/multi_dd.py MAX_CANDIDATES
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int tri(int i, int j) { return i * (i + 1) / 2 + j; }
__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// The parameter block of ops/dcc.py DccTensors.packed: S and q0 (A·A each,
// row-major), then mu, omega, alpha, beta, sigma2_0, eps2_0, e0 (A each), a, b.
struct Params {
  const float *s, *q0, *mu, *omega, *alpha, *beta, *s2_0, *e2_0, *e0;
  float a, b;
  __device__ Params(const float* p, int n)
      : s(p), q0(p + n * n), mu(q0 + n * n), omega(mu + n), alpha(omega + n),
        beta(alpha + n), s2_0(beta + n), e2_0(s2_0 + n), e0(e2_0 + n),
        a(e0[n]), b(e0[n + 1]) {}
  // the constant weight of S: 1 - a - b, rounded as the plain form rounds it
  __device__ float c0() const { return __fsub_rn(__fsub_rn(1.0f, a), b); }
};

// The variance of the first step, as every later one: omega + alpha e2 + beta s2.
__device__ __forceinline__ float first_sigma2(const Params& q, int i) {
  return q.omega[i] + q.alpha[i] * q.e2_0[i] + q.beta[i] * q.s2_0[i];
}

// Per asset (omega, alpha, beta, last): last is 1 + mu for the terminal
// kernel, mu for the candidate kernel.
__device__ __forceinline__ void load_garch(const Params& q, int n, bool one_plus_mu,
                                           float4* s_g, int tid, int n_threads) {
  for (int i = tid; i < kDA; i += n_threads) {
    s_g[i] = i < n ? make_float4(q.omega[i], q.alpha[i], q.beta[i],
                                 one_plus_mu ? 1.0f + q.mu[i] : q.mu[i])
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

struct TermLayout {  // offsets into dynamic shared memory, in floats
  int cs, g, q, z, total;
  __host__ __device__ explicit TermLayout(int n) {
    cs = 0;                                   // (1-a-b) S, lower triangle (kTri)
    g = round4(kTri);                         // kDA float4
    q = g + 4 * kDA;                          // tri(n) x kTermThreads, element-major
    z = q + tri(n, 0) * kTermThreads;         // (4 x kDA) x kTermThreads shocks
    total = z + 4 * kDA * kTermThreads;
  }
};

__global__ void __launch_bounds__(kTermThreads, 2)
dcc_terminal_kernel(long long seed, long long first_block, int block_paths, int n_assets,
                    int n_steps, const float* __restrict__ params, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int n = n_assets;
  const TermLayout lay(n);
  float* s_cs = smem + lay.cs;
  float4* s_g = reinterpret_cast<float4*>(smem + lay.g);
  float* s_q = smem + lay.q;
  float* s_z = smem + lay.z;
  const int tid = threadIdx.x;
  const Params q(params, n);
  const float c0 = q.c0(), a_c = q.a, b_c = q.b;
  for (int i = tid; i < kDA * kDA; i += kTermThreads) {
    const int r = i / kDA, c = i % kDA;
    if (c <= r) s_cs[tri(r, c)] = (r < n) ? c0 * q.s[r * n + c] : 0.0f;
  }
  load_garch(q, n, true, s_g, tid, kTermThreads);
  // this thread's Q, from q0
#pragma unroll
  for (int i = 0; i < kDA; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      if (i < n) s_q[tri(i, j) * kTermThreads + tid] = q.q0[i * n + j];
    }
  }
  __syncthreads();

  const int p = blockIdx.x * kTermThreads + threadIdx.x;
  if (p >= block_paths) return;
  const int blk = blockIdx.y;
  const uint32_t key = block_key(seed, first_block, blk);
  constexpr int kPer = steps_per_call<kPoly>();

  float e[kDA], s2[kDA], cum[kDA];  // s2: the variance of the coming step
#pragma unroll
  for (int i = 0; i < kDA; ++i) {
    e[i] = i < n ? q.e0[i] : 0.0f;
    s2[i] = i < n ? first_sigma2(q, i) : 0.0f;
    cum[i] = 1.0f;
  }

  for (int s0 = 0; s0 < n_steps; s0 += kPer) {
    const int nk = min(kPer, n_steps - s0);
#pragma unroll
    for (int i = 0; i < kDA; ++i) {
      if (i < n) {
        float za[4];
        call_draws<kPoly>(s0 / kPer, i, p, key, nk, 0.0f, 0.0f, za);
#pragma unroll
        for (int k = 0; k < kPer; ++k) s_z[(k * kDA + i) * kTermThreads + tid] = za[k];
      }
    }
#pragma unroll 1
    for (int k = 0; k < nk; ++k) {
      const float* z = s_z + k * kDA * kTermThreads + tid;  // z[j * kTermThreads]
      float w[kTri];
      // Q update, into shared memory and into the working copy
#pragma unroll
      for (int i = 0; i < kDA; ++i) {
#pragma unroll
        for (int j = 0; j <= i; ++j) {
          if (i < n) {
            float* qij = s_q + tri(i, j) * kTermThreads + tid;
            const float v = fmaf(b_c, *qij, fmaf(a_c, e[i] * e[j], s_cs[tri(i, j)]));
            *qij = v;
            w[tri(i, j)] = v;
          }
        }
      }
      // Cholesky of Q, in place, column by column (left-looking)
#pragma unroll
      for (int j = 0; j < kDA; ++j) {
        if (j < n) {
          float d = w[tri(j, j)];
#pragma unroll
          for (int k2 = 0; k2 < j; ++k2) d = fmaf(-w[tri(j, k2)], w[tri(j, k2)], d);
          const float inv = __frsqrt_rn(fmaxf(d, 1e-12f));
          w[tri(j, j)] = d * inv;
#pragma unroll
          for (int i = j + 1; i < kDA; ++i) {
            if (i < n) {
              float num = w[tri(i, j)];
#pragma unroll
              for (int k2 = 0; k2 < j; ++k2) num = fmaf(-w[tri(i, k2)], w[tri(j, k2)], num);
              w[tri(i, j)] = num * inv;
            }
          }
        }
      }
      // e = D^{-1/2} (L z), then the GARCH update and the compounding
#pragma unroll
      for (int i = 0; i < kDA; ++i) {
        if (i < n) {
          float m = w[tri(i, 0)] * z[0];
#pragma unroll
          for (int j = 1; j <= i; ++j) m = fmaf(w[tri(i, j)], z[j * kTermThreads], m);
          const float ei =
              m * __frsqrt_rn(fmaxf(s_q[tri(i, i) * kTermThreads + tid], 1e-12f));
          const float4 g = s_g[i];
          const float eps = sqrtf(fmaxf(s2[i], 0.0f)) * ei;
          cum[i] *= g.w + eps;
          s2[i] = g.x + g.y * (eps * eps) + g.z * s2[i];
          e[i] = ei;
        }
      }
    }
  }

  const long long row = static_cast<long long>(blk) * block_paths + p;
#pragma unroll
  for (int i = 0; i < kDA; ++i) {
    if (i < n) out[row * n + i] = cum[i] - 1.0f;
  }
}

// ---- up to 16 assets, candidates: dcc_dd_kernel ------------------------------------

// The candidate kernel's modes, chosen by W (ops/dcc.py dcc_narrow_plan
// mirrors the choice, the memory and the scratch):
// - kSolo, W <= kSoloMaxCand: a thread per path runs the recursion and scores
//   its own candidates from the step's returns in registers, one launch, no
//   barrier;
// - W > kSoloMaxCand, two launches per chunk of paths: kReturns, the solo
//   layout's recursion, writes every step's returns to a device scratch; then
//   kScore scores them, 256 threads per block, each 4 candidates x 4 paths:
//   ceil(W/4) groups of candidates x score_groups(W) groups of paths.
constexpr int kSoloThreads = 64;                     // paths (and threads) per solo block
constexpr int kSoloMaxCand = 4;                      // the solo layout's widest W
constexpr int kScoreThreads = 256;                   // threads of a scoring block
constexpr int kTile = 16;                            // paths of a tile of the scratch
constexpr int kStageFloats = 8192;                   // returns a scoring block stages at once
enum NarrowMode { kSolo = 0, kReturns = 1, kScore = 2 };

__host__ __device__ constexpr int narrow_mode(int n_cand) {
  return n_cand <= kSoloMaxCand ? kSolo : kReturns;
}

// The scoring block's groups of 4 paths at W candidates: the most, a power of
// two from 4, that ceil(W/4) groups of candidates leave of its 256 threads
// (4 at W = 256, 16 paths; 128 at W = 5-8, 512 paths).
__host__ __device__ constexpr int score_groups(int n_cand) {
  int pg = 4;
  while (pg * 2 * ((n_cand + 3) / 4) <= kScoreThreads) pg *= 2;
  return pg;
}

// Steps of returns a scoring block stages in shared memory at once: what
// kStageFloats hold of its paths, 1 to 16 (16 at W = 256, 1 at W = 5-8).
__host__ __device__ constexpr int score_steps(int n, int n_cand) {
  const int k = kStageFloats / (n * 4 * score_groups(n_cand));
  return k < 1 ? 1 : k > 16 ? 16 : k;
}

struct NarrowLayout {  // offsets into dynamic shared memory, in floats, 16-byte aligned
  int cs, g, w, w_pad, h, q, z, p, st, total;
  __host__ __device__ NarrowLayout(int n, int n_cand, int mode, int n_legs) {
    w_pad = round4(n_cand);
    const bool recur = mode != kScore;
    const int paths = recur ? kSoloThreads : 0;
    cs = 0;                                   // (1-a-b) S, lower triangle (kTri)
    g = round4(kTri);                         // kDA float4 (omega, alpha, beta, mu or 1 + mu)
    w = g + 4 * kDA;                          // solo: (W, kDA) weights; score: (A, w_pad)
    h = w + (mode == kSolo ? n_cand * kDA : mode == kScore ? n * w_pad : 0);
    q = h + (recur && n_legs > 0 ? round4(hedge_floats(n, n_legs)) : 0);  // the hedge block
    z = q + round4(tri(n, 0) * paths);        // Q, tri(n) x paths, element-major
    p = z + 4 * n * paths;                    // one Philox call's shocks, (4 x A) x paths
    st = p + n * paths;                       // hedged: the prices, A x paths
    // solo: v, peak, dd, (3 x W) x paths; score: the staged returns, (steps, A, paths)
    total = st + (mode == kSolo    ? 3 * n_cand * kSoloThreads
                  : mode == kScore ? score_steps(n, n_cand) * n * 4 * score_groups(n_cand)
                                   : 0);
  }
};

// One step of one path's DCC recursion, the terminal kernel's arithmetic: Q
// (element-major at stride kS) updated in shared memory, its Cholesky in place
// on a register copy, e = D^{-1/2} (L z) from the step's shocks z (z[j * kS]),
// then the GARCH update; out r[i] the step's return mu + eps (hedged: the
// settled return of the move P -> P·((1 + mu) + eps), the price at s_p[i *
// kS]). Every loop over assets is unrolled and the zero upper triangle skipped
// at compile time.
template <bool kHedged, int kS>
__device__ __forceinline__ void narrow_step(int n, const float* s_cs, const float4* s_g,
                                            float* s_q, const float* z, float* s_p, float a_c,
                                            float b_c, const HedgeBlock& legs, float (&e)[kDA],
                                            float (&s2)[kDA], float (&r)[kDA]) {
  float w[kTri];
  // Q update, into shared memory and into the working copy
#pragma unroll
  for (int i = 0; i < kDA; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      if (i < n) {
        float* qij = s_q + tri(i, j) * kS;
        const float v = fmaf(b_c, *qij, fmaf(a_c, e[i] * e[j], s_cs[tri(i, j)]));
        *qij = v;
        w[tri(i, j)] = v;
      }
    }
  }
  // Cholesky of Q, in place, column by column (left-looking)
#pragma unroll
  for (int j = 0; j < kDA; ++j) {
    if (j < n) {
      float d = w[tri(j, j)];
#pragma unroll
      for (int k2 = 0; k2 < j; ++k2) d = fmaf(-w[tri(j, k2)], w[tri(j, k2)], d);
      const float inv = __frsqrt_rn(fmaxf(d, 1e-12f));
      w[tri(j, j)] = d * inv;
#pragma unroll
      for (int i = j + 1; i < kDA; ++i) {
        if (i < n) {
          float num = w[tri(i, j)];
#pragma unroll
          for (int k2 = 0; k2 < j; ++k2) num = fmaf(-w[tri(i, k2)], w[tri(j, k2)], num);
          w[tri(i, j)] = num * inv;
        }
      }
    }
  }
  // e = D^{-1/2} (L z), then the GARCH update and the step's return
#pragma unroll
  for (int i = 0; i < kDA; ++i) {
    r[i] = 0.0f;
    if (i < n) {
      float m = w[tri(i, 0)] * z[0];
#pragma unroll
      for (int j = 1; j <= i; ++j) m = fmaf(w[tri(i, j)], z[j * kS], m);
      const float ei = m * __frsqrt_rn(fmaxf(s_q[tri(i, i) * kS], 1e-12f));
      const float4 g = s_g[i];
      const float eps = sqrtf(fmaxf(s2[i], 0.0f)) * ei;
      if (kHedged) {  // the move P -> P·((1 + mu) + eps), settled below
        r[i] = __fmul_rn(s_p[i * kS], __fadd_rn(g.w, eps));
      } else {
        r[i] = g.w + eps;
      }
      s2[i] = g.x + g.y * (eps * eps) + g.z * s2[i];
      e[i] = ei;
    }
  }
  if (kHedged) {
    // hedged.cuh's hedged_return for every asset at once, leg by leg (each
    // asset's legs in ascending order, every operation rounded as there), so
    // that the assets' settlements interleave
    float up[kDA], acc[kDA];
#pragma unroll
    for (int i = 0; i < kDA; ++i) {
      up[i] = i < n ? __fsub_rn(r[i], s_p[i * kS]) : 0.0f;
      acc[i] = 0.0f;
    }
    for (int l = 0; l < legs.n_legs; ++l) {
#pragma unroll
      for (int i = 0; i < kDA; ++i) {
        if (i < n) {
          const int at = i * legs.n_legs + l;
          const float k = legs.strike[at], prem = legs.premium[at], p_new = r[i];
          const float call_iv = fmaxf(__fsub_rn(p_new, k), 0.0f);
          const float put_iv = fmaxf(__fsub_rn(k, p_new), 0.0f);
          const int ty = static_cast<int>(legs.type[at]);
          const float numer = ty == 0                ? up[i]
                              : ty == 1 || ty == 6   ? -up[i]
                              : ty == 2              ? __fsub_rn(call_iv, prem)
                              : ty == 3              ? __fsub_rn(prem, call_iv)
                              : ty == 4              ? __fsub_rn(put_iv, prem)
                              : ty == 5              ? __fsub_rn(prem, put_iv)
                                                     : 0.0f;
          acc[i] = __fadd_rn(acc[i], __fmul_rn(legs.qty[at], numer));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kDA; ++i) {
      if (i < n) {
        const float price = s_p[i * kS];
        s_p[i * kS] = r[i];
        r[i] = __fdiv_rn(acc[i], price);
      }
    }
  }
}

// One (candidate, path)'s wealth after a step whose score is f: V *= 1 + f,
// its running peak and drawdown (hedged: a NaN of overflowed wealth carries on).
template <bool kHedged>
__device__ __forceinline__ void narrow_update(float f, float& v, float& peak, float& dd) {
  v = v * (1.0f + f);
  if (kHedged) {
    peak = max_nan(peak, v);
    dd = min_nan(dd, v / peak - 1.0f);
  } else {
    peak = fmaxf(peak, v);
    dd = fminf(dd, v / peak - 1.0f);
  }
}

// The candidate function up to 16 assets, both modes (kHedged: per-step
// settlement of the n_legs legs per asset of the hedge block, ops/hedged.py
// HedgeTensors.packed, in device memory), in the part kMode of its layout,
// over paths first_path .. first_path + chunk - 1 of each dispatch block.
// kReturns writes step s's return of asset a and chunk path c = 16·t + l to
// rets[(((blk · tiles + t) · n_steps + s) · A + a) · 16 + l] (tiles =
// ceil(chunk / 16): a tile's returns are contiguous); kScore reads them
// there.
template <bool kHedged, int kMode>
__global__ void __launch_bounds__(kMode == kScore ? kScoreThreads : kSoloThreads,
                                  kMode == kScore ? 2 : 4)
dcc_dd_kernel(long long seed, long long first_block, int block_paths, int first_path,
              int chunk, int n_assets, int n_cand, int n_steps, int n_legs,
              const float* __restrict__ params, const float* __restrict__ weights,
              const float* __restrict__ hedge, float* __restrict__ rets,
              float* __restrict__ term, float* __restrict__ max_dd) {
  constexpr int kS = kSoloThreads;  // the recursion's element-major stride
  constexpr int kThreads = kMode == kScore ? kScoreThreads : kSoloThreads;
  extern __shared__ __align__(16) float smem[];
  const int n = n_assets;
  const NarrowLayout lay(n, n_cand, kMode, n_legs);
  float* s_cs = smem + lay.cs;
  float4* s_g = reinterpret_cast<float4*>(smem + lay.g);
  float* s_w = smem + lay.w;
  const int tid = threadIdx.x;
  const int blk = blockIdx.y;

  if (kMode == kScore) {
    // thread tid holds candidates 4·cw .. +3 of the block's paths 4·pq .. +3,
    // their values, peaks and drawdowns in registers; the block's returns are
    // staged in shared memory ks steps at a time
    for (int i = tid; i < n * lay.w_pad; i += kThreads) {
      const int a = i / lay.w_pad, c = i % lay.w_pad;
      s_w[i] = c < n_cand ? weights[c * n + a] : 0.0f;
    }
    const int pg = score_groups(n_cand), bp = 4 * pg, ks = score_steps(n, n_cand);
    const int cw = tid / pg, pq = tid % pg;
    const int b0 = blockIdx.x * bp;  // the block's first path of the chunk
    const long long tiles = (chunk + kTile - 1) / kTile;
    const int bt = min(bp / kTile, static_cast<int>(tiles - b0 / kTile));  // its tiles
    const bool scorer = 4 * cw < lay.w_pad && 4 * pq < bt * kTile;
    const float* rg = rets + ((blk * tiles + b0 / kTile) * n_steps) * n * kTile;
    float* s_r = smem + lay.st;  // (ks, A, bp)
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
      for (int i = tid; i < bt * nk * n * (kTile / 4); i += kThreads) {
        const int l4 = i % (kTile / 4), a = (i / (kTile / 4)) % n;
        const int k = (i / (kTile / 4 * n)) % nk, tl = i / (kTile / 4 * n * nk);
        const float4 x = *reinterpret_cast<const float4*>(
            rg + ((static_cast<long long>(tl) * n_steps + s0 + k) * n + a) * kTile + 4 * l4);
        *reinterpret_cast<float4*>(s_r + (k * n + a) * bp + tl * kTile + 4 * l4) = x;
      }
      __syncthreads();
      if (scorer) {
        for (int k = 0; k < nk; ++k) {
          const float* rk = s_r + k * n * bp + 4 * pq;
          float f[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j) f[i][j] = 0.0f;
          }
          for (int a = 0; a < n; ++a) {
            const float4 w4 = *reinterpret_cast<const float4*>(s_w + a * lay.w_pad + 4 * cw);
            const float4 r4 = *reinterpret_cast<const float4*>(rk + a * bp);
            const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
            const float rv[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
#pragma unroll
              for (int j = 0; j < 4; ++j) f[i][j] = fmaf(wv[i], rv[j], f[i][j]);
            }
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              narrow_update<kHedged>(f[i][j], v[i][j], peak[i][j], dd[i][j]);
            }
          }
        }
      }
    }
    if (scorer) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = 4 * cw + i;
        if (c >= n_cand) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int cp = b0 + 4 * pq + j;
          if (cp >= chunk) continue;
          const long long o =
              (static_cast<long long>(blk) * n_cand + c) * block_paths + first_path + cp;
          term[o] = v[i][j] - 1.0f;
          max_dd[o] = dd[i][j];
        }
      }
    }
    return;
  }

  // the recursion, a thread per path
  const Params q(params, n);
  const float c0 = q.c0(), a_c = q.a, b_c = q.b;
  for (int i = tid; i < kDA * kDA; i += kThreads) {
    const int r = i / kDA, c = i % kDA;
    if (c <= r) s_cs[tri(r, c)] = (r < n) ? c0 * q.s[r * n + c] : 0.0f;
  }
  load_garch(q, n, kHedged, s_g, tid, kThreads);  // hedged: the gross's 1 + mu
  if (kMode == kSolo) {
    for (int i = tid; i < n_cand * kDA; i += kThreads) {
      const int c = i / kDA, a = i % kDA;
      s_w[i] = a < n ? weights[c * n + a] : 0.0f;
    }
  }
  float* s_h = smem + lay.h;  // hedged: the hedge block, read every asset-step
  if (kHedged) {
    for (int i = tid; i < hedge_floats(n, n_legs); i += kThreads) s_h[i] = hedge[i];
  }
  __syncthreads();

  const int cp = blockIdx.x * kSoloThreads + tid;  // this thread's path of the chunk
  const int p = first_path + cp;
  const uint32_t key = block_key(seed, first_block, blk);
  const HedgeBlock legs(s_h, n, n_legs);
  constexpr int kPer = steps_per_call<kPoly>();
  float* s_q = smem + lay.q + tid;
  float* s_z = smem + lay.z + tid;
  float* s_p = smem + lay.p + tid;
  float* s_st = smem + lay.st + tid;  // solo: v, peak, dd per candidate
  float e[kDA], s2[kDA];  // s2: the variance of the coming step
#pragma unroll
  for (int i = 0; i < kDA; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      if (i < n) s_q[tri(i, j) * kS] = q.q0[i * n + j];
    }
    e[i] = i < n ? q.e0[i] : 0.0f;
    s2[i] = i < n ? first_sigma2(q, i) : 0.0f;
    if (kHedged && i < n) s_p[i * kS] = s_h[i];  // the price, from s0
  }
  if (kMode == kSolo) {
    for (int c = 0; c < n_cand; ++c) {
      s_st[(3 * c) * kS] = 1.0f;
      s_st[(3 * c + 1) * kS] = 1.0f;
      s_st[(3 * c + 2) * kS] = 0.0f;
    }
  }
  const long long tiles = (chunk + kTile - 1) / kTile;
  float* rg = rets + ((blk * tiles + cp / kTile) * n_steps) * n * kTile + cp % kTile;
  for (int s = 0; s < n_steps; ++s) {
    if (s % kPer == 0) {
      const int nk = min(kPer, n_steps - s);
#pragma unroll
      for (int i = 0; i < kDA; ++i) {
        if (i < n) {
          float za[4];
          call_draws<kPoly>(s / kPer, i, p, key, nk, 0.0f, 0.0f, za);
#pragma unroll
          for (int k = 0; k < kPer; ++k) s_z[(k * n + i) * kS] = za[k];
        }
      }
    }
    float r[kDA];
    narrow_step<kHedged, kS>(n, s_cs, s_g, s_q, s_z + (s % kPer) * n * kS, s_p, a_c, b_c, legs,
                             e, s2, r);
    if (kMode == kSolo) {
      // this path's candidates, scored from the returns in registers
      for (int c = 0; c < n_cand; ++c) {
        const float* wc = s_w + c * kDA;
        float f = 0.0f;
#pragma unroll
        for (int a = 0; a < kDA; ++a) {
          if (a < n) f = fmaf(wc[a], r[a], f);
        }
        float v = s_st[(3 * c) * kS], peak = s_st[(3 * c + 1) * kS], dd = s_st[(3 * c + 2) * kS];
        narrow_update<kHedged>(f, v, peak, dd);
        s_st[(3 * c) * kS] = v;
        s_st[(3 * c + 1) * kS] = peak;
        s_st[(3 * c + 2) * kS] = dd;
      }
    } else if (cp < tiles * kTile) {
#pragma unroll
      for (int i = 0; i < kDA; ++i) {
        if (i < n) rg[(s * n + i) * kTile] = r[i];
      }
    }
  }
  if (kMode == kSolo && cp < chunk) {
    for (int c = 0; c < n_cand; ++c) {
      const long long o = (static_cast<long long>(blk) * n_cand + c) * block_paths + p;
      term[o] = s_st[(3 * c) * kS] - 1.0f;
      max_dd[o] = s_st[(3 * c + 2) * kS];
    }
  }
}

// ---- 17 assets and more: dcc_group_kernel ---------------------------------------

constexpr int kGroupBlock = 256;        // threads per block, at every group size
constexpr int kTs = 20;                 // floats per 4 x 4 tile of the factor: 16, padded so
                                        // that consecutive tiles' float4 hit distinct banks
constexpr int kQs = 16;                 // floats per 4 x 4 tile of Q
constexpr int kGroupSmem = 232448 / 4;  // a block's shared memory on the H100, in floats

// Threads per path: a warp up to 32 assets, two warps up to 64, four up to
// 128, the whole block past that.
__host__ __device__ constexpr int group_threads(int n) {
  return n <= 32 ? 32 : n <= 64 ? 64 : n <= 128 ? 128 : kGroupBlock;
}

// Tile (ti, tj), ti >= tj, of a lower triangle of t x t tiles stored tile
// column by tile column; entry (i, j) of a tile (row 4·ti + i, column 4·tj +
// j) sits at j·4 + i, so that a tile's column is one float4.
__host__ __device__ constexpr int tix(int ti, int tj, int t) {
  return tj * t - tj * (tj - 1) / 2 + ti - tj;
}

// The idx-th tile of the triangle of tile rows and columns k0 .. t-1 in the
// same column-major order: idx 0 is its corner (k0, k0).
__device__ __forceinline__ void tile_of(int idx, int k0, int t, int& ti, int& tj) {
  const int r = t - k0, q = r * (r + 1) / 2 - 1 - idx;  // counted from the last tile
  const float x = 8.0f * static_cast<float>(q) + 1.0f;
  int m = static_cast<int>((x * rsqrtf(x) - 1.0f) * 0.5f);  // its column from the last, +-1
  if ((m + 1) * (m + 2) / 2 <= q) ++m;
  if (m * (m + 1) / 2 > q) --m;
  ti = t - 1 - (q - m * (m + 1) / 2);
  tj = t - 1 - m;
}

__device__ __forceinline__ void load_tile(const float* p, float* x) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 c = *reinterpret_cast<const float4*>(p + 4 * j);
    x[4 * j] = c.x;
    x[4 * j + 1] = c.y;
    x[4 * j + 2] = c.z;
    x[4 * j + 3] = c.w;
  }
}

__device__ __forceinline__ void store_tile(float* p, const float* x) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    *reinterpret_cast<float4*>(p + 4 * j) =
        make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
  }
}

// Factors a diagonal tile in registers whose entries hold every product of
// the earlier columns: column by column the pivot, its correctly rounded
// reciprocal square root (into inv[j]) and the column, each entry's products
// subtracted in ascending k.
__device__ __forceinline__ void factor_diag(float* x, float* inv) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float d = x[j * 4 + j];
#pragma unroll
    for (int k = 0; k < j; ++k) d = fmaf(-x[k * 4 + j], x[k * 4 + j], d);
    const float rs = __frsqrt_rn(fmaxf(d, 1e-12f));
    x[j * 4 + j] = d * rs;
#pragma unroll
    for (int i = j + 1; i < 4; ++i) {
      float num = x[j * 4 + i];
#pragma unroll
      for (int k = 0; k < j; ++k) num = fmaf(-x[k * 4 + i], x[k * 4 + j], num);
      x[j * 4 + i] = num * rs;
    }
    inv[j] = rs;
  }
}

// The tiles (ti, kt), ti > kt, below the factored corner (kt, kt) of the
// factor wm, each solved against the corner (inv: its reciprocal pivots) by
// one of the group's g threads: entry (r, c) subtracts the products of the
// corner's earlier columns in ascending k, then takes the pivot's reciprocal.
__device__ __forceinline__ void solve_below(float* wm, const float* inv, int kt, int t, int gt,
                                            int g) {
  const float* dk = wm + tix(kt, kt, t) * kTs;
  for (int ti = kt + 1 + gt; ti < t; ti += g) {
    float d[16], x[16];
    load_tile(dk, d);
    const float4 i4 = *reinterpret_cast<const float4*>(inv);
    const float iv[4] = {i4.x, i4.y, i4.z, i4.w};
    float* xp = wm + tix(ti, kt, t) * kTs;
    load_tile(xp, x);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float num = x[j * 4 + i];
#pragma unroll
        for (int k = 0; k < j; ++k) num = fmaf(-x[k * 4 + i], d[k * 4 + j], num);
        x[j * 4 + i] = num * iv[j];
      }
    }
    store_tile(xp, x);
  }
}

// The first `count` tiles of the triangle from tile row and column k0
// (tile_of's order), each reduced in registers by the products of the kNp
// solved tile columns kt .. kt + kNp - 1 of the factor wm, in ascending k (per
// column two float4 loads per 16 FMAs); the thread with idx 0, the corner
// (k0, k0), then factors it (into inv).
template <int kNp>
__device__ __forceinline__ void update_tiles(float* wm, float* inv, int k0, int count, int kt,
                                             int t, int gt, int g) {
  for (int idx = gt; idx < count; idx += g) {
    int ti, tj;
    tile_of(idx, k0, t, ti, tj);
    float* xp = wm + tix(ti, tj, t) * kTs;
    float x[16];
    load_tile(xp, x);
#pragma unroll
    for (int p = kt; p < kt + kNp; ++p) {
      const float* li = wm + tix(ti, p, t) * kTs;
      const float* lj = wm + tix(tj, p, t) * kTs;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 a4 = *reinterpret_cast<const float4*>(li + 4 * k);
        const float4 b4 = *reinterpret_cast<const float4*>(lj + 4 * k);
        const float lr[4] = {a4.x, a4.y, a4.z, a4.w}, lc[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int i = 0; i < 4; ++i) x[j * 4 + i] = fmaf(-lr[i], lc[j], x[j * 4 + i]);
        }
      }
    }
    if (idx == 0) factor_diag(x, inv);
    store_tile(xp, x);
  }
}

// A barrier over the kG threads of group gi: the warp's, a named barrier of
// gi's warps, or the block's.
template <int kG>
__device__ __forceinline__ void group_sync(int gi) {
  if constexpr (kG == 32) {
    __syncwarp();
  } else if constexpr (kG == kGroupBlock) {
    __syncthreads();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(gi + 1), "r"(kG) : "memory");
  }
}

// dcc_group_kernel's memory at A assets, in floats (each region a multiple of
// 4): per path the factor's tiles (kTs each), Q's tiles (kQs each), one
// Philox call's shocks (4 rows of 4·ceil(A/4)), per row e, sigma2, Q's
// diagonal, the gross and (hedged) the price, and the four reciprocal pivots
// of the corner being factored; per block the candidates' returns, (2, rows,
// paths), double-buffered by step. Where the block cannot hold them, Q and
// then the factor move to the CTA's slot of a device-memory scratch (`slot`
// floats), the same tile layout.
struct GroupLayout {
  int g, paths, t, nt, ap;
  int w, q, z, e, s2, qd, cum, price, inv, per_path, r, total;
  bool w_shared, q_shared;
  long long slot;
  __host__ __device__ GroupLayout(int n, bool hedged) {
    g = group_threads(n);
    paths = kGroupBlock / g;
    t = (n + 3) / 4;
    nt = t * (t + 1) / 2;
    ap = 4 * t;
    for (int mode = 0; mode < 3; ++mode) {
      w_shared = mode < 2;
      q_shared = mode < 1;
      w = 0;
      q = w + (w_shared ? nt * kTs : 0);
      z = q + (q_shared ? nt * kQs : 0);
      e = z + 4 * ap;
      s2 = e + ap;
      qd = s2 + ap;
      cum = qd + ap;
      price = cum + ap;
      inv = price + (hedged ? ap : 0);
      per_path = inv + 4;
      r = paths * per_path;
      total = r + 2 * ap * paths;
      slot = paths * ((w_shared ? 0LL : 1LL * nt * kTs) + (q_shared ? 0LL : 1LL * nt * kQs));
      if (total <= kGroupSmem) break;
    }
  }
};

// Both functions from 17 assets on, any width. A group of kG threads owns a
// path (kP = 256/kG paths per block; persistent CTAs walk units of kP paths
// gridDim.x apart); kScore: the candidates', kHedged: settled, kQShared and
// kWShared: where Q and the factor live (GroupLayout).
template <int kG, bool kQShared, bool kWShared, bool kScore, bool kHedged>
__global__ void __launch_bounds__(kGroupBlock, 2)
dcc_group_kernel(long long seed, long long first_block, int n_blocks, int block_paths,
                 int n_assets, int n_cand, int n_steps, int n_legs,
                 const float* __restrict__ params, const float* __restrict__ wt,
                 const float* __restrict__ hedge, float* __restrict__ scratch,
                 float* __restrict__ term, float* __restrict__ max_dd) {
  constexpr int kP = kGroupBlock / kG;
  extern __shared__ __align__(16) float smem[];
  const int n = n_assets;
  const GroupLayout lay(n, kHedged);
  const int t = lay.t, nt = lay.nt, ap = lay.ap;
  const int tid = threadIdx.x, gi = tid / kG, gt = tid % kG;
  float* own = smem + gi * lay.per_path;
  float* slot = (kQShared && kWShared)
                    ? nullptr
                    : scratch + (static_cast<long long>(blockIdx.x) * kP + gi) * (lay.slot / kP);
  float* wm = kWShared ? own + lay.w : slot;                                // the factor
  float* qm = kQShared ? own + lay.q : slot + (kWShared ? 0 : nt * kTs);  // Q
  float* s_z = own + lay.z;      // (4, rows) one Philox call's shocks
  float* s_e = own + lay.e;      // e of the last step (0 past A)
  float* s_s2 = own + lay.s2;    // each row's variance of the coming step
  float* s_qd = own + lay.qd;    // Q's diagonal
  float* s_cum = own + lay.cum;  // the terminal's grosses
  float* s_p = own + lay.price;  // hedged: each row's price
  float* s_inv = own + lay.inv;  // the corner's reciprocal pivots
  float* s_r = smem + lay.r;     // (2, rows, kP) r = mu + eps (hedged: r_h)
  const Params q(params, n);
  const float c0 = q.c0(), a_c = q.a, b_c = q.b;
  const HedgeBlock legs(hedge, n, n_legs);  // hedged: the legs, read from device memory
  const bool scorer = kScore && tid < n_cand;
  const long long per_blk = (block_paths + kP - 1) / kP, units = per_blk * n_blocks;
  constexpr int kPer = steps_per_call<kPoly>();

  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const int blk = static_cast<int>(u / per_blk);
    const int p0 = static_cast<int>(u % per_blk) * kP, p = p0 + gi;
    const uint32_t key = block_key(seed, first_block, blk);
    __syncthreads();  // the last unit's reads are done
    for (int idx = gt; idx < nt; idx += kG) {  // Q = q0, zero past A and above the diagonal
      int ti, tj;
      tile_of(idx, 0, t, ti, tj);
      float x[16];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 4 * ti + i, c = 4 * tj + j;
          x[j * 4 + i] = (r < n && c <= r) ? q.q0[static_cast<long long>(r) * n + c] : 0.0f;
        }
      }
      store_tile(qm + tix(ti, tj, t) * kQs, x);
    }
    for (int r = gt; r < ap; r += kG) {
      const bool real = r < n;
      s_e[r] = real ? q.e0[r] : 0.0f;
      s_s2[r] = real ? first_sigma2(q, r) : 0.0f;
      s_cum[r] = 1.0f;
      if (kHedged) s_p[r] = real ? hedge[r] : 0.0f;
    }
    float v[kP], peak[kP], dd[kP];
#pragma unroll
    for (int i = 0; i < kP; ++i) {
      v[i] = 1.0f;
      peak[i] = 1.0f;
      dd[i] = 0.0f;
    }

    for (int s0 = 0; s0 < n_steps; s0 += kPer) {
      const int nk = min(kPer, n_steps - s0);
      for (int r = gt; r < n; r += kG) {
        float za[4];
        call_draws<kPoly>(s0 / kPer, r, p, key, nk, 0.0f, 0.0f, za);
#pragma unroll
        for (int k = 0; k < kPer; ++k) s_z[k * ap + r] = za[k];
      }
      group_sync<kG>(gi);

      for (int k = 0; k < nk; ++k) {
        // Q update, tile by tile, into Q and the factor's tiles (the identity
        // past A); thread 0 owns the corner (0, 0) and factors it at once
        for (int idx = gt; idx < nt; idx += kG) {
          int ti, tj;
          tile_of(idx, 0, t, ti, tj);
          float* qp = qm + tix(ti, tj, t) * kQs;
          float x[16], qv[16];
          load_tile(qp, qv);
          const float4 e4 = *reinterpret_cast<const float4*>(s_e + 4 * ti);
          const float4 f4 = *reinterpret_cast<const float4*>(s_e + 4 * tj);
          const float er[4] = {e4.x, e4.y, e4.z, e4.w}, ec[4] = {f4.x, f4.y, f4.z, f4.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int r = 4 * ti + i, c = 4 * tj + j;
              if (r < n && c <= r) {
                const float cs = c0 * __ldg(q.s + static_cast<long long>(r) * n + c);
                const float upd = fmaf(b_c, qv[j * 4 + i], fmaf(a_c, er[i] * ec[j], cs));
                qv[j * 4 + i] = upd;
                x[j * 4 + i] = upd;
                if (r == c) s_qd[r] = upd;
              } else {
                x[j * 4 + i] = r == c ? 1.0f : 0.0f;
              }
            }
          }
          store_tile(qp, qv);
          if (idx == 0) factor_diag(x, s_inv);
          store_tile(wm + tix(ti, tj, t) * kTs, x);
        }
        group_sync<kG>(gi);
        // Cholesky of Q, right-looking by panels of nb columns: the tiles
        // below the factored corner (kt, kt) solve against it; then the
        // trailing triangle takes the panel's products, thread 0 first the
        // next corner, which it then factors. Every entry receives its
        // products in ascending k. nb = 4 up to 128 assets; past that nb = 8
        // (two tile columns kt, kt + 1: column kt + 1 first takes column kt's
        // products, its corner is factored and its tiles below solve; then
        // the trailing triangle takes both columns' 8 products, half the
        // tile loads and stores per FMA).
        if constexpr (kG == kGroupBlock) {
          for (int kt = 0; kt + 1 < t; kt += 2) {
            solve_below(wm, s_inv, kt, t, gt, kG);
            group_sync<kG>(gi);
            update_tiles<1>(wm, s_inv, kt + 1, t - kt - 1, kt, t, gt, kG);
            group_sync<kG>(gi);
            if (kt + 2 < t) {
              const int rt = t - kt - 2;
              solve_below(wm, s_inv, kt + 1, t, gt, kG);
              group_sync<kG>(gi);
              update_tiles<2>(wm, s_inv, kt + 2, rt * (rt + 1) / 2, kt, t, gt, kG);
              group_sync<kG>(gi);
            }
          }
        } else {
          for (int kt = 0; kt + 1 < t; ++kt) {
            const int rt = t - kt - 1;
            solve_below(wm, s_inv, kt, t, gt, kG);
            group_sync<kG>(gi);
            update_tiles<1>(wm, s_inv, kt + 1, rt * (rt + 1) / 2, kt, t, gt, kG);
            group_sync<kG>(gi);
          }
        }
        // e = D^{-1/2} (L z), then the GARCH update and the gross or r = mu + eps
        const float* zk = s_z + k * ap;
        float* rb = s_r + ((s0 + k) & 1) * ap * kP;
        for (int r = gt; r < n; r += kG) {
          const int ti = r / 4, i = r % 4;
          const float* lp = wm + tix(ti, 0, t) * kTs + i;
          float4 z4 = *reinterpret_cast<const float4*>(zk);
          int last = ti > 0 ? 3 : i;
          float m = lp[0] * z4.x;
          if (last >= 1) m = fmaf(lp[4], z4.y, m);
          if (last >= 2) m = fmaf(lp[8], z4.z, m);
          if (last >= 3) m = fmaf(lp[12], z4.w, m);
          for (int tj = 1; tj <= ti; ++tj) {
            lp = wm + tix(ti, tj, t) * kTs + i;
            z4 = *reinterpret_cast<const float4*>(zk + 4 * tj);
            last = tj < ti ? 3 : i;
            m = fmaf(lp[0], z4.x, m);
            if (last >= 1) m = fmaf(lp[4], z4.y, m);
            if (last >= 2) m = fmaf(lp[8], z4.z, m);
            if (last >= 3) m = fmaf(lp[12], z4.w, m);
          }
          const float ei = m * __frsqrt_rn(fmaxf(s_qd[r], 1e-12f));
          const float mu = q.mu[r], s2 = s_s2[r];
          const float eps = sqrtf(fmaxf(s2, 0.0f)) * ei;
          if (kHedged) {  // the settled return of the move P -> P·((1 + mu) + eps)
            const float pr = s_p[r], p_new = __fmul_rn(pr, __fadd_rn(__fadd_rn(1.0f, mu), eps));
            rb[r * kP + gi] = hedged_return(legs, r, pr, p_new);
            s_p[r] = p_new;
          } else if (kScore) {
            rb[r * kP + gi] = mu + eps;
          } else {
            s_cum[r] *= (1.0f + mu) + eps;
          }
          s_s2[r] = q.omega[r] + q.alpha[r] * (eps * eps) + q.beta[r] * s2;
          s_e[r] = ei;
        }
        if (kScore) {
          __syncthreads();
        } else {
          group_sync<kG>(gi);
        }
        if (scorer) {  // candidate tid over the block's paths; rb is rewritten
                       // only after the next step's block barrier
          float f[kP];
#pragma unroll
          for (int i = 0; i < kP; ++i) f[i] = 0.0f;
          for (int a = 0; a < n; ++a) {
            const float w = __ldg(wt + static_cast<long long>(a) * n_cand + tid);
#pragma unroll
            for (int i = 0; i < kP; ++i) f[i] = fmaf(w, rb[a * kP + i], f[i]);
          }
#pragma unroll
          for (int i = 0; i < kP; ++i) {
            wide_update<kHedged ? kWideHedged : kWideSimple>(f[i], &v[i], &peak[i], &dd[i]);
          }
        }
      }
    }

    if (kScore) {
      if (scorer) {
#pragma unroll
        for (int i = 0; i < kP; ++i) {
          if (p0 + i < block_paths) {
            const long long o =
                (static_cast<long long>(blk) * n_cand + tid) * block_paths + p0 + i;
            term[o] = v[i] - 1.0f;
            max_dd[o] = dd[i];
          }
        }
      }
    } else if (p < block_paths) {
      for (int r = gt; r < n; r += kG) {
        term[(static_cast<long long>(blk) * block_paths + p) * n + r] = s_cum[r] - 1.0f;
      }
    }
  }
}

// Launches dcc_group_kernel<kG, kQShared, kWShared, ...> for the function
// its arguments select: persistent CTAs, as many as the occupancy calculator
// puts on the card's SMs, no more than the units of work nor than the
// scratch has slots for.
template <int kG, bool kQShared, bool kWShared>
int launch_group(const GroupLayout& lay, long long seed, long long first_block, int n_blocks,
                 int block_paths, int n_assets, int n_cand, int n_steps, int n_legs,
                 const float* params, const float* wt, const float* hedge, float* scratch,
                 long long scratch_floats, float* out, float* dd, cudaStream_t stream) {
  auto run = [&](auto kernel) {
    const int smem = static_cast<int>(sizeof(float) * lay.total);
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           smem);
    int per_sm = 0, dev = 0, sms = 0;
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kGroupBlock, smem);
    }
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long units = static_cast<long long>(n_blocks) *
                            ((block_paths + lay.paths - 1) / lay.paths);
    long long ctas = static_cast<long long>(per_sm) * sms;
    if (ctas > units) ctas = units;
    if (lay.slot > 0 && ctas > scratch_floats / lay.slot) ctas = scratch_floats / lay.slot;
    if (ctas < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    kernel<<<static_cast<unsigned>(ctas), kGroupBlock, smem, stream>>>(
        seed, first_block, n_blocks, block_paths, n_assets, n_cand, n_steps, n_legs, params, wt,
        hedge, scratch, out, dd);
    return static_cast<int>(cudaGetLastError());
  };
  if (n_legs > 0) return run(dcc_group_kernel<kG, kQShared, kWShared, true, true>);
  if (n_cand > 0) return run(dcc_group_kernel<kG, kQShared, kWShared, true, false>);
  return run(dcc_group_kernel<kG, kQShared, kWShared, false, false>);
}

}  // namespace

extern "C" {

// Launches the terminal kernel (up to 16 assets) on `stream` for blocks
// first_block+1 .. first_block+n_blocks. params: ops/dcc.py DccTensors.packed, float32 on the
// device. Output out: (n_blocks, block_paths, n_assets) float32. Normal shocks
// (the poly tier). Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments the kernel does not take.
int mcport_dcc_terminal(long long seed, long long first_block, int n_blocks, int block_paths,
                        int n_assets, int n_steps, const void* params, void* out, void* stream) {
  if (n_assets < 1 || n_assets > kDA || n_blocks < 1 || n_blocks > 65535 || block_paths < 1 ||
      n_steps < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((block_paths + kTermThreads - 1) / kTermThreads, n_blocks);
  const size_t smem = sizeof(float) * TermLayout(n_assets).total;
  cudaError_t err = cudaFuncSetAttribute(dcc_terminal_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dcc_terminal_kernel<<<grid, kTermThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      seed, first_block, block_paths, n_assets, n_steps, static_cast<const float*>(params),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Launches the candidate kernel (up to 16 assets) on `stream` for blocks
// first_block+1 .. first_block+n_blocks. params: DccTensors.packed; weights: (n_cand,
// n_assets); float32 on the device. hedge: ops/hedged.py HedgeTensors.packed
// for n_legs legs per asset (read from device memory), or null with n_legs 0
// for the unhedged mode. Outputs term and dd: (n_blocks, n_cand, block_paths)
// float32. Normal shocks (the poly tier). Past kSoloMaxCand candidates the
// returns go through scratch (scratch_floats floats on the device), in
// chunks of paths that it holds for every block and step (a multiple of 64
// paths; ops/dcc.py dcc_narrow_plan sizes it); up to kSoloMaxCand it is
// unused and may be null. Returns cudaGetLastError() after the last launch,
// or cudaErrorInvalidValue for arguments the kernel does not take.
int mcport_dcc_multi_dd(long long seed, long long first_block, int n_blocks, int block_paths,
                        int n_assets, int n_cand, int n_steps, int n_legs, const void* params,
                        const void* weights, const void* hedge, void* term, void* dd,
                        void* scratch, long long scratch_floats, void* stream) {
  if (n_assets < 1 || n_assets > kDA || n_cand < 1 || n_cand > kMaxCand || n_blocks < 1 ||
      n_blocks > 65535 || block_paths < 1 || n_steps < 0 || n_legs < 0 ||
      (n_legs > 0 && hedge == nullptr) || scratch_floats < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static_assert(kMaxCand / 4 * score_groups(kMaxCand) <= kScoreThreads &&
                    4 * score_groups(kMaxCand) % kTile == 0 && kSoloThreads % kTile == 0,
                "a scoring block covers 256 candidates of whole tiles");
  const float* p = static_cast<const float*>(params);
  const float* w = static_cast<const float*>(weights);
  const float* h = static_cast<const float*>(hedge);
  float* r = static_cast<float*>(scratch);
  float *out = static_cast<float*>(term), *out_dd = static_cast<float*>(dd);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto run = [&](auto kernel, int mode, int threads, int paths, int first, int chunk) {
    const size_t smem = sizeof(float) * NarrowLayout(n_assets, n_cand, mode, n_legs).total;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((chunk + paths - 1) / paths, n_blocks);
    kernel<<<grid, threads, smem, st>>>(seed, first_block, block_paths, first, chunk, n_assets,
                                        n_cand, n_steps, n_legs, p, w, h, r, out, out_dd);
    return static_cast<int>(cudaGetLastError());
  };
  if (narrow_mode(n_cand) == kSolo) {
    return n_legs ? run(dcc_dd_kernel<true, kSolo>, kSolo, kSoloThreads, kSoloThreads, 0,
                        block_paths)
                  : run(dcc_dd_kernel<false, kSolo>, kSolo, kSoloThreads, kSoloThreads, 0,
                        block_paths);
  }
  // the paths of a chunk: every path where the scratch holds them all (in
  // whole 16-path tiles), else what it holds in whole solo blocks
  const long long per_path = static_cast<long long>(n_blocks) * n_steps * n_assets;
  const long long all = (block_paths + kTile - 1) / kTile * kTile;
  long long chunk = block_paths;
  if (per_path > 0 && scratch_floats / per_path < all) {
    chunk = scratch_floats / per_path / kSoloThreads * kSoloThreads;
  }
  if (chunk < 1 || (per_path > 0 && r == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  for (int first = 0; first < block_paths; first += static_cast<int>(chunk)) {
    const int m = static_cast<int>(chunk < block_paths - first ? chunk : block_paths - first);
    int err = n_steps == 0 ? 0
              : n_legs     ? run(dcc_dd_kernel<true, kReturns>, kReturns, kSoloThreads,
                                 kSoloThreads, first, m)
                           : run(dcc_dd_kernel<false, kReturns>, kReturns, kSoloThreads,
                                 kSoloThreads, first, m);
    if (err) return err;
    const int paths = 4 * score_groups(n_cand);
    err = n_legs ? run(dcc_dd_kernel<true, kScore>, kScore, kScoreThreads, paths, first, m)
                 : run(dcc_dd_kernel<false, kScore>, kScore, kScoreThreads, paths, first, m);
    if (err) return err;
  }
  return 0;
}

// Both functions from 17 assets on (dcc_group_kernel; it takes any A >= 1):
// n_cand 0 runs the terminal function (output out (n_blocks, block_paths,
// n_assets)), n_cand >= 1 the candidates' (outputs out and dd (n_blocks,
// n_cand, block_paths); weights_t (n_assets, n_cand), the weights
// transposed; hedged when n_legs > 0, the hedge block HedgeTensors.packed
// read from device memory). scratch: scratch_floats floats on the device,
// one slot per CTA where Q (and past ~300 assets the factor) leave shared
// memory (GroupLayout; ops/dcc.py dcc_wide_plan sizes it), else unused and
// may be null. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments the kernel does not take.
int mcport_dcc_wide(long long seed, long long first_block, int n_blocks, int block_paths,
                    int n_assets, int n_cand, int n_steps, int n_legs, const void* params,
                    const void* weights_t, const void* hedge, void* out, void* dd, void* scratch,
                    long long scratch_floats, void* stream) {
  if (n_assets < 1 || n_cand < 0 || n_cand > kMaxCand || n_blocks < 1 || n_blocks > 65535 ||
      block_paths < 1 || n_steps < 0 || (n_cand > 0 && (weights_t == nullptr || dd == nullptr)) ||
      n_legs < 0 || (n_legs > 0 && (hedge == nullptr || n_cand == 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static_assert(kMaxCand <= kGroupBlock, "a block's threads score its candidates");
  const GroupLayout lay(n_assets, n_legs > 0);
  if (lay.total > kGroupSmem ||
      (lay.slot > 0 && (scratch == nullptr || scratch_floats < lay.slot))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* p = static_cast<const float*>(params);
  const float* w = static_cast<const float*>(weights_t);
  const float* h = static_cast<const float*>(hedge);
  float* s = static_cast<float*>(scratch);
  float *o = static_cast<float*>(out), *o_dd = static_cast<float*>(dd);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MCPORT_DCC_GROUP(G, QS, WS)                                                            \
  launch_group<G, QS, WS>(lay, seed, first_block, n_blocks, block_paths, n_assets, n_cand,     \
                          n_steps, n_legs, p, w, h, s, scratch_floats, o, o_dd, st)
  if (lay.g < kGroupBlock && !(lay.q_shared && lay.w_shared)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (lay.g) {
    case 32:
      return MCPORT_DCC_GROUP(32, true, true);
    case 64:
      return MCPORT_DCC_GROUP(64, true, true);
    case 128:
      return MCPORT_DCC_GROUP(128, true, true);
    default:
      return lay.q_shared   ? MCPORT_DCC_GROUP(kGroupBlock, true, true)
             : lay.w_shared ? MCPORT_DCC_GROUP(kGroupBlock, false, true)
                            : MCPORT_DCC_GROUP(kGroupBlock, false, false);
  }
#undef MCPORT_DCC_GROUP
}

}  // extern "C"
