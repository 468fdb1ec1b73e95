// DCC-GARCH(1,1) paths on Hopper: the terminal simple returns of every asset
// (kernel dcc_terminal_kernel) and W candidate portfolios' rebalanced wealth
// with its maximum drawdown (kernel dcc_dd_kernel).
//
// dcc_terminal_kernel replaces mcport/ops/pallas_dcc.py::_dcc_pack_kernel (the
// garch-risk --correlation dcc and compare-models path) and ::_dcc_kernel (the
// same function in the TPU's tile layout); dcc_dd_kernel replaces
// ::_dcc_dd_kernel, both its modes (path-risk --models dcc, the DCC drawdown
// frontier and path_tail_risk, hedged or not), and ::_dcc_pack_dd_kernel (the
// unhedged function, scored in the TPU's pack layout, which takes no hedge).
// Pack and tile are TPU layouts; on the card each function is one kernel.
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
// - candidates: garch.cu's tile. A block owns 16 paths and all <= 256
//   candidates, 256 threads; here a half-warp owns one path and lane i holds
//   row i of Q and of L in registers. The column-by-column Cholesky
//   broadcasts each pivot and each L_jk by __shfl_sync within the half-warp;
//   the step's r = mu + eps goes to shared memory, and each thread then
//   updates its 4-candidate x 4-path micro-tile of values, peaks and
//   drawdowns in registers (FP32 FMAs: mcport's score_dot is float32). The
//   recursion spreads over all 256 threads, so at W = 1 it does not idle 240.
//   Hedged, lane i also keeps row i's price in a register and writes r_h.
// For 17 <= A <= 64 (dcc_wide_kernel, both functions): a path's triangle is
// 2,080 floats at A = 64, past any thread's registers and past a half-warp's.
// A group of 32 threads (A <= 32) or 64 (A <= 64) owns one path, thread r its
// row r, and a 256-thread block owns 8 or 4 paths. Each path's Q, its
// Cholesky factor L, the shocks of one Philox call and e live in shared
// memory, Q and L packed column by column (entry (r, j) at j·A - j(j-1)/2 + r
// - j), so that the rows of a column sit on consecutive banks. Per step:
// thread r updates row r of Q; then column by column, behind one barrier
// each, thread r >= j computes the pivot of column j itself (the same sum in
// the same order as thread j, so every thread holds the same rounded
// reciprocal) and its L_rj; then e_r, the GARCH update and either the gross or
// r = mu + eps into a shared (A, paths) tile, which thread c scores for
// candidate c over the block's paths (hedged: thread r keeps row r's price in
// a register and settles it before the tile is scored). The sums keep the
// narrow kernels' order (ascending k and j) and the correctly rounded rsqrt.
// A simple design: A barriers per step, and A/64 to A/32 of the threads
// working in the Cholesky's late columns.
// Past 64 assets, dcc_wider_kernel (below): one path per CTA of 256 threads,
// the same order of every sum, Q and L in device memory past ~220 assets.
// A dispatch group of blocks is one launch (gridDim.y).
//
// nvcc contracts a*b+c into FMA where the torch forms round twice, so kernels
// and plain forms agree to ulps, not bits (bound: ops/dcc.py dcc_shares).

#include "gbm_draws.cuh"
#include "wide.cuh"

namespace {

constexpr int kDA = 16;                      // the narrow kernels' asset bound
constexpr int kTri = kDA * (kDA + 1) / 2;    // entries of a lower triangle
constexpr int kTermThreads = 128;
constexpr int kDdThreads = 256;
constexpr int kTileP = 16;                   // paths per candidate block
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

struct DdLayout {  // offsets into dynamic shared memory, in floats, 16-byte aligned
  int cs, g, w, r, total;
  __host__ __device__ DdLayout(int n, int w_pad) {
    cs = 0;                    // (1-a-b) S transposed: cs[j * kDA + i] = c0 S_ij
    g = kDA * kDA;             // kDA float4 (omega, alpha, beta, mu)
    w = g + 4 * kDA;           // (A, w_pad) weights
    r = w + n * w_pad;         // (A, kTileP) r = mu + eps
    total = r + n * kTileP;
  }
};

// kHedged: per-step settlement of the n_legs legs per asset of the hedge block
// (ops/hedged.py HedgeTensors.packed, in device memory).
template <bool kHedged>
__global__ void __launch_bounds__(kDdThreads, 2)
dcc_dd_kernel(long long seed, long long first_block, int block_paths, int n_assets,
              int n_cand, int n_steps, int n_legs, const float* __restrict__ params,
              const float* __restrict__ weights, const float* __restrict__ hedge,
              float* __restrict__ term, float* __restrict__ max_dd) {
  extern __shared__ __align__(16) float smem[];
  const int n = n_assets;
  const int w_pad = round4(n_cand);
  const DdLayout lay(n, w_pad);
  float* s_cs = smem + lay.cs;
  float4* s_g = reinterpret_cast<float4*>(smem + lay.g);
  float* s_w = smem + lay.w;
  float* s_r = smem + lay.r;

  const int tid = threadIdx.x;
  const Params q(params, n);
  const float c0 = q.c0(), a_c = q.a, b_c = q.b;
  for (int i = tid; i < kDA * kDA; i += kDdThreads) {
    const int r = i % kDA, c = i / kDA;       // s_cs[c * kDA + r] = c0 S_rc
    s_cs[i] = (r < n && c < n) ? c0 * q.s[r * n + c] : 0.0f;
  }
  load_garch(q, n, kHedged, s_g, tid, kDdThreads);  // hedged: the gross's 1 + mu
  for (int i = tid; i < n * w_pad; i += kDdThreads) {
    const int a = i / w_pad, w = i % w_pad;
    s_w[i] = w < n_cand ? weights[w * n + a] : 0.0f;
  }

  const int blk = blockIdx.y;
  const int p0 = blockIdx.x * kTileP;
  const uint32_t key = block_key(seed, first_block, blk);
  // this thread's (path, asset): a half-warp per path, lane ia holds row ia
  const int ip = tid / kDA, ia = tid % kDA;
  const bool item = ia < n;
  float qr[kDA], l[kDA];
#pragma unroll
  for (int k = 0; k < kDA; ++k) {
    qr[k] = (item && k <= ia) ? q.q0[ia * n + k] : 0.0f;
    l[k] = 0.0f;
  }
  float e = item ? q.e0[ia] : 0.0f;
  float s2 = item ? first_sigma2(q, ia) : 0.0f;
  float price = (kHedged && item) ? hedge[ia] : 0.0f;  // hedged: this item's price, from s0
  const HedgeBlock legs(hedge, n, n_legs);              // hedged: the legs, read from device memory

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
  const float4 g = s_g[ia];

  constexpr int kPer = steps_per_call<kPoly>();
  for (int s0 = 0; s0 < n_steps; s0 += kPer) {
    const int nk = min(kPer, n_steps - s0);
    float za[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (item) call_draws<kPoly>(s0 / kPer, ia, p0 + ip, key, nk, 0.0f, 0.0f, za);

    for (int k = 0; k < nk; ++k) {
      const float zk = k == 0 ? za[0] : k == 1 ? za[1] : k == 2 ? za[2] : za[3];
      // Q update: row ia of the lower triangle, e_j from lane j
      float qd = 0.0f;
#pragma unroll
      for (int j = 0; j < kDA; ++j) {
        if (j < n) {
          const float ej = __shfl_sync(kFull, e, j, kDA);
          const float upd = fmaf(b_c, qr[j], fmaf(a_c, e * ej, s_cs[j * kDA + ia]));
          qr[j] = j <= ia ? upd : 0.0f;
          qd = j == ia ? upd : qd;
        }
      }
      // Cholesky of Q, column by column: lane j broadcasts its pivot and L_jk
#pragma unroll
      for (int j = 0; j < kDA; ++j) {
        if (j < n) {
          float num = qr[j];
#pragma unroll
          for (int k2 = 0; k2 < j; ++k2) {
            num = fmaf(-l[k2], __shfl_sync(kFull, l[k2], j, kDA), num);
          }
          const float d = __shfl_sync(kFull, num, j, kDA);
          const float inv = __frsqrt_rn(fmaxf(d, 1e-12f));
          l[j] = ia >= j ? num * inv : 0.0f;
        }
      }
      // e = D^{-1/2} (L z), z_j from lane j; then the GARCH update
      float m = l[0] * __shfl_sync(kFull, zk, 0, kDA);
#pragma unroll
      for (int j = 1; j < kDA; ++j) {
        if (j < n) m = fmaf(l[j], __shfl_sync(kFull, zk, j, kDA), m);
      }
      const float ei = m * __frsqrt_rn(fmaxf(qd, 1e-12f));
      const float eps = sqrtf(fmaxf(s2, 0.0f)) * ei;
      if (kHedged) {  // the settled return of the move P -> P·((1 + mu) + eps)
        const float p_new = __fmul_rn(price, __fadd_rn(g.w, eps));
        if (item) s_r[ia * kTileP + ip] = hedged_return(legs, ia, price, p_new);
        price = p_new;
      } else {
        if (item) s_r[ia * kTileP + ip] = g.w + eps;
      }
      s2 = g.x + g.y * (eps * eps) + g.z * s2;
      e = item ? ei : 0.0f;
      __syncthreads();

      if (scorer) {
        float f[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) f[i][j] = 0.0f;
        }
        for (int a = 0; a < n; ++a) {
          const float4 w4 = *reinterpret_cast<const float4*>(s_w + a * w_pad + 4 * cw);
          const float4 r4 = *reinterpret_cast<const float4*>(s_r + a * kTileP + 4 * pq);
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
        const long long o = (static_cast<long long>(blk) * n_cand + w) * block_paths + p;
        term[o] = v[i][j] - 1.0f;
        max_dd[o] = dd[i][j];
      }
    }
  }
}

// Entry (r, j), r >= j, of an n x n lower triangle packed column by column.
__device__ __forceinline__ int col_at(int j, int r, int n) { return j * n - j * (j - 1) / 2 + r - j; }

struct WideLayout {  // offsets into dynamic shared memory, in floats, 16-byte aligned
  int cs, g, w, r, paths, per_path, total;
  __host__ __device__ WideLayout(int n, int n_p, int w_pad) {
    const int t = n * (n + 1) / 2;
    cs = 0;                               // (1-a-b) S, packed by column
    g = round4(t);                        // A float4 (omega, alpha, beta, last)
    w = g + 4 * n;                        // (A, w_pad) weights (candidates only)
    r = w + n * w_pad;                    // (A, paths) r = mu + eps (candidates only)
    paths = round4(r + n * n_p);
    per_path = round4(2 * t + 5 * n);     // Q and L packed by column, z (4, A), e (A)
    total = paths + n_p * per_path;
  }
};

// Threads per path in the wide kernel: a row each, rounded up to whole warps.
__host__ __device__ constexpr int wide_rows(int n) { return n <= 32 ? 32 : 64; }

template <bool kScore, bool kHedged = false>
__global__ void __launch_bounds__(kDdThreads)
dcc_wide_kernel(long long seed, long long first_block, int block_paths, int n_assets,
                int n_cand, int n_steps, int n_legs, const float* __restrict__ params,
                const float* __restrict__ weights, const float* __restrict__ hedge,
                float* __restrict__ term, float* __restrict__ max_dd) {
  constexpr int kMaxPaths = kDdThreads / 32;
  extern __shared__ __align__(16) float smem[];
  const int n = n_assets;
  const int rows = wide_rows(n), n_p = kDdThreads / rows;
  const int w_pad = kScore ? round4(n_cand) : 0;
  const WideLayout lay(n, n_p, w_pad);
  const int tid = threadIdx.x, pl = tid / rows, row = tid % rows;
  const bool active = row < n;
  const int t = n * (n + 1) / 2;
  float* s_cs = smem + lay.cs;
  float4* s_g = reinterpret_cast<float4*>(smem + lay.g);
  float* s_w = smem + lay.w;
  float* s_r = smem + lay.r;
  float* s_q = smem + lay.paths + pl * lay.per_path;  // this path's Q
  float* s_l = s_q + t;                               // its Cholesky factor
  float* s_z = s_l + t;                               // (4, A) one Philox call's shocks
  float* s_e = s_z + 4 * n;                           // (A,) e of the last step

  const Params q(params, n);
  const float c0 = q.c0(), a_c = q.a, b_c = q.b;
  for (int i = tid; i < n * n; i += kDdThreads) {
    const int r = i / n, c = i % n;
    if (c <= r) s_cs[col_at(c, r, n)] = c0 * q.s[r * n + c];
  }
  for (int i = tid; i < n; i += kDdThreads) {  // last: mu for r, 1 + mu for a gross
    s_g[i] = make_float4(q.omega[i], q.alpha[i], q.beta[i],
                         (kScore && !kHedged) ? q.mu[i] : 1.0f + q.mu[i]);
  }
  for (int i = tid; i < n * w_pad; i += kDdThreads) {
    const int a = i / w_pad, w = i % w_pad;
    s_w[i] = w < n_cand ? weights[w * n + a] : 0.0f;
  }
  if (active) {
    for (int j = 0; j <= row; ++j) s_q[col_at(j, row, n)] = q.q0[row * n + j];
    s_e[row] = q.e0[row];
  }
  float s2 = active ? first_sigma2(q, row) : 0.0f;  // the variance of the coming step
  float cum = 1.0f;
  float price = (kHedged && active) ? hedge[row] : 0.0f;  // hedged: row's price, from s0
  const HedgeBlock legs(hedge, n, n_legs);                 // hedged: the legs (device memory)

  const int blk = blockIdx.y;
  const int p = blockIdx.x * n_p + pl;  // this thread's path of the dispatch block
  const uint32_t key = block_key(seed, first_block, blk);
  // candidate tid's values, peaks and drawdowns over the block's paths
  const bool scorer = kScore && tid < n_cand;
  float v[kMaxPaths], peak[kMaxPaths], dd[kMaxPaths];
#pragma unroll
  for (int i = 0; i < kMaxPaths; ++i) {
    v[i] = 1.0f;
    peak[i] = 1.0f;
    dd[i] = 0.0f;
  }
  __syncthreads();

  constexpr int kPer = steps_per_call<kPoly>();
  for (int s0 = 0; s0 < n_steps; s0 += kPer) {
    const int nk = min(kPer, n_steps - s0);
    if (active) {
      float za[4];
      call_draws<kPoly>(s0 / kPer, row, p, key, nk, 0.0f, 0.0f, za);
#pragma unroll
      for (int k = 0; k < kPer; ++k) s_z[k * n + row] = za[k];
    }
    __syncthreads();

    for (int k = 0; k < nk; ++k) {
      const float* z = s_z + k * n;
      // Q update: row `row` of the lower triangle
      if (active) {
        const float er = s_e[row];
        for (int j = 0; j <= row; ++j) {
          const int at = col_at(j, row, n);
          s_q[at] = fmaf(b_c, s_q[at], fmaf(a_c, er * s_e[j], s_cs[at]));
        }
      }
      __syncthreads();
      // Cholesky of Q, column by column (left-looking)
      for (int j = 0; j < n; ++j) {
        if (active && row >= j) {
          float d = s_q[col_at(j, j, n)];
          for (int k2 = 0; k2 < j; ++k2) {
            const float ljk = s_l[col_at(k2, j, n)];
            d = fmaf(-ljk, ljk, d);
          }
          const float inv = __frsqrt_rn(fmaxf(d, 1e-12f));
          float num = d;
          if (row > j) {
            num = s_q[col_at(j, row, n)];
            for (int k2 = 0; k2 < j; ++k2) {
              num = fmaf(-s_l[col_at(k2, row, n)], s_l[col_at(k2, j, n)], num);
            }
          }
          s_l[col_at(j, row, n)] = num * inv;
        }
        __syncthreads();
      }
      // e = D^{-1/2} (L z), then the GARCH update and the compounding
      if (active) {
        float m = s_l[col_at(0, row, n)] * z[0];
        for (int j = 1; j <= row; ++j) m = fmaf(s_l[col_at(j, row, n)], z[j], m);
        const float ei = m * __frsqrt_rn(fmaxf(s_q[col_at(row, row, n)], 1e-12f));
        const float4 g = s_g[row];
        const float eps = sqrtf(fmaxf(s2, 0.0f)) * ei;
        if (kHedged) {  // the settled return of the move P -> P·((1 + mu) + eps)
          const float p_new = __fmul_rn(price, __fadd_rn(g.w, eps));
          s_r[row * n_p + pl] = hedged_return(legs, row, price, p_new);
          price = p_new;
        } else if (kScore) {
          s_r[row * n_p + pl] = g.w + eps;
        } else {
          cum *= g.w + eps;
        }
        s2 = g.x + g.y * (eps * eps) + g.z * s2;
        s_e[row] = ei;
      }
      __syncthreads();
      if (scorer) {  // candidate tid over the block's paths
#pragma unroll
        for (int i = 0; i < kMaxPaths; ++i) {
          if (i < n_p) {
            float f = 0.0f;
            for (int a = 0; a < n; ++a) f = fmaf(s_w[a * w_pad + tid], s_r[a * n_p + i], f);
            v[i] = v[i] * (1.0f + f);
            if (kHedged) {  // wealth may overflow: NaN carries on (hedged.cuh)
              peak[i] = max_nan(peak[i], v[i]);
              dd[i] = min_nan(dd[i], v[i] / peak[i] - 1.0f);
            } else {
              peak[i] = fmaxf(peak[i], v[i]);
              dd[i] = fminf(dd[i], v[i] / peak[i] - 1.0f);
            }
          }
        }
      }
      // (s_r is rewritten only after the next step's barriers)
    }
  }

  if (kScore) {
    if (scorer) {
#pragma unroll
      for (int i = 0; i < kMaxPaths; ++i) {
        const int path = blockIdx.x * n_p + i;
        if (i < n_p && path < block_paths) {
          const long long o = (static_cast<long long>(blk) * n_cand + tid) * block_paths + path;
          term[o] = v[i] - 1.0f;
          max_dd[o] = dd[i];
        }
      }
    }
  } else if (active && p < block_paths) {
    term[(static_cast<long long>(blk) * block_paths + p) * n + row] = cum - 1.0f;
  }
}

// Launches the wide kernel: the terminal function (out in term) or, kScore,
// the candidates' (kHedged: settling the n_legs legs of the hedge block).
template <bool kScore, bool kHedged = false>
int launch_wide(long long seed, long long first_block, int n_blocks, int block_paths,
                int n_assets, int n_cand, int n_steps, int n_legs, const float* params,
                const float* w, const float* hedge, float* term, float* dd,
                cudaStream_t stream) {
  const int n_p = kDdThreads / wide_rows(n_assets);
  const dim3 grid((block_paths + n_p - 1) / n_p, n_blocks);
  const size_t smem =
      sizeof(float) * WideLayout(n_assets, n_p, kScore ? round4(n_cand) : 0).total;
  auto kernel = dcc_wide_kernel<kScore, kHedged>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kDdThreads, smem, stream>>>(seed, first_block, block_paths, n_assets, n_cand,
                                             n_steps, n_legs, params, w, hedge, term, dd);
  return static_cast<int>(cudaGetLastError());
}

// Both functions past 64 assets. A path's rows no longer fit one group of the
// block: a CTA of 256 threads owns one path at a time (persistent CTAs, as in
// wide.cuh, each walking paths gridDim.x apart), thread t its rows t, t + 256,
// .... The design and the order of every sum are dcc_wide_kernel's: Q and L
// packed column by column, row r of Q updated by its thread, then column by
// column behind one barrier each the pivot computed by every thread that owns
// a row at or below it (the same sum in the same order, once per thread) and
// that row's L_rj, then e, the GARCH update and the gross or r = mu + eps per
// row; candidate c = tid scores the path (hedged: each row's price in A more
// floats of shared memory, settled before the path is scored). Q and L stay
// in shared memory while they fit (kShared: A(A+1) floats beside 8·A of
// per-row state, 9·A hedged, up to A ≈ 220); past that they move to the
// CTA's slot of a device-memory scratch, the same packing, so the rows of a
// column are consecutive addresses. c0·S
// is read from the parameter block (device memory) as it is needed, the
// weights through the read-only cache.
template <bool kScore, bool kShared, bool kHedged = false>
__global__ void __launch_bounds__(kDdThreads)
dcc_wider_kernel(long long seed, long long first_block, int n_blocks, int block_paths,
                 int n_assets, int n_cand, int n_steps, int n_legs,
                 const float* __restrict__ params, const float* __restrict__ weights,
                 const float* __restrict__ hedge, float* __restrict__ scratch,
                 float* __restrict__ term, float* __restrict__ max_dd) {
  extern __shared__ __align__(16) float smem[];
  const int n = n_assets, tid = threadIdx.x;
  const long long t = static_cast<long long>(n) * (n + 1) / 2;
  float* s_z = smem;        // (4, A) one Philox call's shocks
  float* s_e = s_z + 4 * n;  // (A,) e of the last step
  float* s_s2 = s_e + n;     // (A,) each row's variance of the coming step
  float* s_cum = s_s2 + n;   // (A,) the terminal's grosses
  float* s_r = s_cum + n;    // (A,) the candidates' r = mu + eps (hedged: r_h)
  float* s_p = s_r + n;      // (A,) hedged: each row's price
  float* qm = kShared ? s_r + (kHedged ? 2 : 1) * n
                      : scratch + static_cast<long long>(blockIdx.x) * 2 * t;
  float* lm = qm + t;        // Q, then L, packed by column
  const Params q(params, n);
  const float c0 = q.c0(), a_c = q.a, b_c = q.b;
  const bool scorer = kScore && tid < n_cand;
  const HedgeBlock legs(hedge, n, n_legs);  // hedged: the legs, read from device memory
  const long long n_paths = static_cast<long long>(n_blocks) * block_paths;
  constexpr int kPer = steps_per_call<kPoly>();

  for (long long pi = blockIdx.x; pi < n_paths; pi += gridDim.x) {
    const int blk = static_cast<int>(pi / block_paths), p = static_cast<int>(pi % block_paths);
    const uint32_t key = block_key(seed, first_block, blk);
    __syncthreads();  // the last path's reads are done
    for (int r = tid; r < n; r += kDdThreads) {
      for (int j = 0; j <= r; ++j) qm[col_at(j, r, n)] = q.q0[static_cast<long long>(r) * n + j];
      s_e[r] = q.e0[r];
      s_s2[r] = first_sigma2(q, r);
      s_cum[r] = 1.0f;
      if (kHedged) s_p[r] = hedge[r];
    }
    float v = 1.0f, peak = 1.0f, dd = 0.0f;

    for (int s0 = 0; s0 < n_steps; s0 += kPer) {
      const int nk = min(kPer, n_steps - s0);
      for (int r = tid; r < n; r += kDdThreads) {
        float za[4];
        call_draws<kPoly>(s0 / kPer, r, p, key, nk, 0.0f, 0.0f, za);
#pragma unroll
        for (int k = 0; k < kPer; ++k) s_z[k * n + r] = za[k];
      }
      __syncthreads();

      for (int k = 0; k < nk; ++k) {
        const float* z = s_z + k * n;
        // Q update: this thread's rows of the lower triangle
        for (int r = tid; r < n; r += kDdThreads) {
          const float er = s_e[r];
          for (int j = 0; j <= r; ++j) {
            const int at = col_at(j, r, n);
            qm[at] = fmaf(b_c, qm[at],
                          fmaf(a_c, er * s_e[j], c0 * q.s[static_cast<long long>(r) * n + j]));
          }
        }
        __syncthreads();
        // Cholesky of Q, column by column (left-looking)
        for (int j = 0; j < n; ++j) {
          float d = 0.0f, inv = 0.0f;
          bool pivot = false;
          for (int r = tid; r < n; r += kDdThreads) {
            if (r < j) continue;
            if (!pivot) {
              d = qm[col_at(j, j, n)];
              for (int k2 = 0; k2 < j; ++k2) {
                const float ljk = lm[col_at(k2, j, n)];
                d = fmaf(-ljk, ljk, d);
              }
              inv = __frsqrt_rn(fmaxf(d, 1e-12f));
              pivot = true;
            }
            float num = d;
            if (r > j) {
              num = qm[col_at(j, r, n)];
              for (int k2 = 0; k2 < j; ++k2) {
                num = fmaf(-lm[col_at(k2, r, n)], lm[col_at(k2, j, n)], num);
              }
            }
            lm[col_at(j, r, n)] = num * inv;
          }
          __syncthreads();
        }
        // e = D^{-1/2} (L z), then the GARCH update and the compounding
        for (int r = tid; r < n; r += kDdThreads) {
          float m = lm[col_at(0, r, n)] * z[0];
          for (int j = 1; j <= r; ++j) m = fmaf(lm[col_at(j, r, n)], z[j], m);
          const float ei = m * __frsqrt_rn(fmaxf(qm[col_at(r, r, n)], 1e-12f));
          const float mu = q.mu[r], s2 = s_s2[r];
          const float eps = sqrtf(fmaxf(s2, 0.0f)) * ei;
          if (kHedged) {  // the settled return of the move P -> P·((1 + mu) + eps)
            const float p = s_p[r], p_new = __fmul_rn(p, __fadd_rn(__fadd_rn(1.0f, mu), eps));
            s_r[r] = hedged_return(legs, r, p, p_new);
            s_p[r] = p_new;
          } else if (kScore) {
            s_r[r] = mu + eps;
          } else {
            s_cum[r] *= (1.0f + mu) + eps;
          }
          s_s2[r] = q.omega[r] + q.alpha[r] * (eps * eps) + q.beta[r] * s2;
          s_e[r] = ei;
        }
        __syncthreads();
        if (scorer) {  // candidate tid over this path
          const float* w = weights + static_cast<long long>(tid) * n;
          float f = 0.0f;
          for (int a = 0; a < n; ++a) f = fmaf(__ldg(w + a), s_r[a], f);
          wide_update<kHedged ? kWideHedged : kWideSimple>(f, &v, &peak, &dd);
        }
        // (s_r is rewritten only after the next step's barriers)
      }
    }

    if (kScore) {
      if (scorer) {
        const long long o = (static_cast<long long>(blk) * n_cand + tid) * block_paths + p;
        term[o] = v - 1.0f;
        max_dd[o] = dd;
      }
    } else {
      for (int r = tid; r < n; r += kDdThreads) {
        term[(static_cast<long long>(blk) * block_paths + p) * n + r] = s_cum[r] - 1.0f;
      }
    }
  }
}

// Floats of dcc_wider_kernel's per-row state at A assets: shocks (4), e,
// sigma2, gross and r, and hedged the price.
__host__ __device__ constexpr long long wider_rows(int n, bool hedged) {
  return (hedged ? 9LL : 8LL) * n;
}

// Whether dcc_wider_kernel keeps a path's Q and L in shared memory at A
// assets: A(A+1) floats beside its per-row state within 200 KB.
__host__ __device__ constexpr bool wider_in_shared(int n, bool hedged) {
  return 4LL * (static_cast<long long>(n) * (n + 1) + wider_rows(n, hedged)) <= 204800;
}

}  // namespace

extern "C" {

// Launches the terminal kernel on `stream` for blocks first_block+1 ..
// first_block+n_blocks. params: ops/dcc.py DccTensors.packed, float32 on the
// device. Output out: (n_blocks, block_paths, n_assets) float32. Normal shocks
// (the poly tier). Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments the kernel does not take.
int mcport_dcc_terminal(long long seed, long long first_block, int n_blocks, int block_paths,
                        int n_assets, int n_steps, const void* params, void* out, void* stream) {
  if (n_assets < 1 || n_assets > kMaxAssets || n_blocks < 1 || n_blocks > 65535 ||
      block_paths < 1 || n_steps < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_assets > kDA) {
    return launch_wide<false>(seed, first_block, n_blocks, block_paths, n_assets, 1, n_steps, 0,
                              static_cast<const float*>(params), nullptr, nullptr,
                              static_cast<float*>(out), nullptr,
                              static_cast<cudaStream_t>(stream));
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

// Launches the candidate kernel on `stream` for blocks first_block+1 ..
// first_block+n_blocks. params: DccTensors.packed; weights: (n_cand,
// n_assets); float32 on the device. hedge: ops/hedged.py HedgeTensors.packed
// for n_legs legs per asset (read from device memory), or null with n_legs 0
// for the unhedged mode. Outputs term and dd: (n_blocks, n_cand, block_paths)
// float32. Normal shocks (the poly tier). Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for arguments the kernel does not take.
int mcport_dcc_multi_dd(long long seed, long long first_block, int n_blocks, int block_paths,
                        int n_assets, int n_cand, int n_steps, int n_legs, const void* params,
                        const void* weights, const void* hedge, void* term, void* dd,
                        void* stream) {
  if (n_assets < 1 || n_assets > kMaxAssets || n_cand < 1 || n_cand > kMaxCand ||
      n_blocks < 1 || n_blocks > 65535 || block_paths < 1 || n_steps < 0 || n_legs < 0 ||
      (n_legs > 0 && hedge == nullptr) || kDA * kTileP != kDdThreads ||
      kMaxCand > kDdThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* p = static_cast<const float*>(params);
  const float* w = static_cast<const float*>(weights);
  const float* h = static_cast<const float*>(hedge);
  float *out = static_cast<float*>(term), *out_dd = static_cast<float*>(dd);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_assets > kDA) {
    return n_legs ? launch_wide<true, true>(seed, first_block, n_blocks, block_paths, n_assets,
                                            n_cand, n_steps, n_legs, p, w, h, out, out_dd, st)
                  : launch_wide<true>(seed, first_block, n_blocks, block_paths, n_assets,
                                      n_cand, n_steps, 0, p, w, nullptr, out, out_dd, st);
  }
  const dim3 grid((block_paths + kTileP - 1) / kTileP, n_blocks);
  const size_t smem = sizeof(float) * DdLayout(n_assets, round4(n_cand)).total;
  auto run = [&](auto kernel) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kDdThreads, smem, st>>>(seed, first_block, block_paths, n_assets, n_cand,
                                           n_steps, n_legs, p, w, h, out, out_dd);
    return static_cast<int>(cudaGetLastError());
  };
  return n_legs ? run(dcc_dd_kernel<true>) : run(dcc_dd_kernel<false>);
}

// Both functions past 64 assets (dcc_wider_kernel): n_cand 0 runs the
// terminal function (output out (n_blocks, block_paths, n_assets)), n_cand >=
// 1 the candidates' (outputs out and dd (n_blocks, n_cand, block_paths);
// hedged when n_legs > 0, the hedge block HedgeTensors.packed read from device
// memory and each row's price in A more floats of shared memory).
// scratch: n_ctas·A(A+1) floats on the device, read only where Q and L leave
// shared memory (A past ~220); n_ctas persistent CTAs, one path each at a
// time. Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for arguments the kernel does not take.
int mcport_dcc_wide(long long seed, long long first_block, int n_blocks, int block_paths,
                    int n_assets, int n_cand, int n_steps, int n_legs, const void* params,
                    const void* weights, const void* hedge, void* out, void* dd, void* scratch,
                    int n_ctas, void* stream) {
  if (n_assets < 1 || n_cand < 0 || n_cand > kMaxCand || n_blocks < 1 || n_blocks > 65535 ||
      block_paths < 1 || n_steps < 0 || n_ctas < 1 || n_ctas > 65535 || scratch == nullptr ||
      (n_cand > 0 && (weights == nullptr || dd == nullptr)) || n_legs < 0 ||
      (n_legs > 0 && (hedge == nullptr || n_cand == 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool hedged = n_legs > 0, shared = wider_in_shared(n_assets, hedged);
  const size_t smem = sizeof(float) * (static_cast<size_t>(wider_rows(n_assets, hedged)) +
                                       (shared ? static_cast<size_t>(n_assets) * (n_assets + 1)
                                               : 0));
  auto run = [&](auto kernel) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<n_ctas, kDdThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        seed, first_block, n_blocks, block_paths, n_assets, n_cand, n_steps, n_legs,
        static_cast<const float*>(params), static_cast<const float*>(weights),
        static_cast<const float*>(hedge), static_cast<float*>(scratch),
        static_cast<float*>(out), static_cast<float*>(dd));
    return static_cast<int>(cudaGetLastError());
  };
  if (hedged) {
    return shared ? run(dcc_wider_kernel<true, true, true>)
                  : run(dcc_wider_kernel<true, false, true>);
  }
  if (n_cand > 0) {
    return shared ? run(dcc_wider_kernel<true, true>) : run(dcc_wider_kernel<true, false>);
  }
  return shared ? run(dcc_wider_kernel<false, true>) : run(dcc_wider_kernel<false, false>);
}

}  // extern "C"
