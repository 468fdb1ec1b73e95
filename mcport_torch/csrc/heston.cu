// Heston stochastic-volatility paths on Hopper: the terminal simple returns of
// every asset (kernel heston_terminal_kernel) and W candidate portfolios'
// rebalanced wealth with its maximum drawdown (kernel heston_dd_kernel).
//
// Replaces mcport/ops/pallas_heston.py::_heston_kernel (heston_terminal_returns)
// and ::_heston_dd_kernel (path-risk --models heston and the Heston drawdown
// frontier), both its modes: unhedged, and hedged (its hedge_args branch:
// path-risk --hedge and dd-frontier --hedge). The plain torch forms of the
// same functions, on the same Philox counters, are mcport_torch/ops/heston.py
// ::heston_terminal_reference and ::heston_multi_dd_reference.
//
// What they compute. For block b of a dispatch group and path p < block_paths,
// step by step: draw two normal fields, the return shocks z (STREAM_GBM) and
// the variance shocks w (STREAM_HESTON), both in the GBM shocks' layout;
// correlate zc = L_R z with the lower triangle of the correlation's Cholesky
// factor; then per asset, full-truncation Euler in mcport's order:
//   zv = rho zc + rho_c w,  vp = max(v, 0),  sv = sqrt(vp)
//   x  = (mu - vp/2) + sv zc
//   v  = v + kappa (theta - vp) + xi sv zv      (from v0; v, not vp)
// and either acc += x (terminal: out expm1(acc) per asset), or, for every
// candidate w, V *= W_w·exp(x), peak = max(peak, V), dd = min(dd, V/peak - 1)
// from V_0 = peak_0 = 1, dd_0 = 0 (out V_T - 1 and dd per candidate and path).
// Hedged, every (asset, path) also carries its price P from the spot s0: per
// step P_new = P·exp(x), the option legs settle against the move
// (hedged.cuh's hedged_return r_h), P = P_new, and every candidate compounds
// V *= 1 + W_w·r_h, the peak and drawdown carrying the NaN of overflowed
// wealth. rho_c = sqrt(1 - rho^2) arrives precomputed in float32
// (ops/heston.py).
//
// Bit-identical path state. With full truncation the recursion is chaotic
// where the Feller condition fails: sqrt at v ≈ 0 turns one ulp of v into
// sqrt(ulp) of sv, and at xi = 0.05 (bench kappa, theta) a 2-ulp change of the
// shocks grows to O(1) in the terminal log return within 252 steps
// (tests/test_torch_heston.py). No tolerance can hold a kernel that rounds
// differently from its plain form there. So both kernels round every
// operation of the path — the draws (gbm_draws.cuh kPolyStrict), the correlate
// (one product and one sum per term, in column order) and the update — as the
// torch form does, with __fmul_rn/__fadd_rn/__fsqrt_rn and no contraction:
// v, x and acc equal the plain form's bit for bit. Only the final expm1, the
// per-step exp and the candidates' score (FP32 FMAs) differ by ulps, and no
// difference feeds back into the path. The hedged mode adds the price update
// P·exp(x) (one rounded product) and the settlement, rounded as the torch form
// rounds them: the prices differ only through the exp, which
// ops/heston.py::heston_price_bound bounds.
//
// What bounds them on the card. Per path-step and asset: two draws (half a
// Philox call and one Box-Muller pair each, kernel #1's 54.75 instructions
// per draw, more when strict), the correlate's lower triangle ((A+1)/2
// products and sums on average) and the update (~12 operations with an IEEE
// sqrt); the candidate kernel adds an exp per asset-step and W·A scoring FMAs
// per path-step. Nothing is read per step and each output is stored once, so
// both are bound by instruction issue. The designs are the GARCH kernels'
// (garch.cu):
// - terminal up to 16 assets: one thread per path, asset by asset within a
//   Philox call (heston_call; all loops over assets unrolled): the call's
//   return shocks of every asset in registers, then per asset its variance
//   shocks, its row of L_R and its (mu, kappa, theta, xi) and (rho, rho_c)
//   (shared memory behind volatile 16-byte loads, once per call) and its four
//   steps. v and acc wait in the thread's slices of shared memory, so that
//   the kernel fits 128 registers and four 128-thread blocks per SM: the
//   dependent chains of the strict draws and the update leave it bound by
//   latency more than by its instruction count (PERF.md §6, #9), and more
//   warps hide it. Whole calls run without a step guard; a path's last,
//   shorter call runs a copy of its own. The correlate skips the zero upper
//   triangle at compile time: A(A+1)/2 terms per step, not A².
// - candidates up to 16 assets, the layout narrow_layout picks by W
//   (narrow_dd.cuh; ops/heston.py heston_narrow_plan): up to 12 candidates a
//   thread per path (64 per block) runs the terminal kernel's recursion (the
//   variance and the return shocks in registers, the variance shocks in a
//   per-thread slice of shared memory) and scores its own candidates; up to
//   128 the same recursion writes its returns to a device scratch and scoring
//   blocks read them; past 128 a block owns 16 paths and every candidate,
//   each (asset, path) item computing one Philox call's four steps of returns
//   into shared memory while the scorers (4 candidates x 4 paths a thread)
//   run the previous call's, one barrier per call. Hedged, the legs are
//   staged in shared memory; a thread that owns a path settles leg by leg
//   across its assets.
// - wider universes, 17 <= A <= 64 (garch.cu's wide variants): the candidate
//   kernel (heston_dd_kernel<kMaxAssets>) owns a 16-path tile and every
//   candidate, per step each (asset, path) item writing exp(x) (hedged r_h,
//   the legs read from device memory) to shared memory before a 4-candidate
//   x 4-path micro-tile per thread scores it; four (asset, path) items per
//   thread, each
//   item's variance and variance shocks in registers; the terminal kernel
//   takes the same 16-path tile (heston_terminal_tile_kernel), each item's v
//   and acc in registers, the return shocks of one Philox call in shared
//   memory. Every operation of the path is the same, in the same order and
//   rounding, so the wide kernels' path state too equals the plain form's bit
//   for bit.
// Past 64 assets both run wide.cuh's layout with the HestonWide model below,
// rounding as the plain form does: the path state stays bit for bit.
// A dispatch group of blocks is one launch (gridDim.y).

#include "gbm_draws.cuh"
#include "hedged.cuh"
#include "narrow_dd.cuh"
#include "wide.cuh"

namespace {

constexpr int kHA = 16;              // the narrow terminal kernel's asset bound
constexpr int kTermThreads = 128;    // the terminal kernel's block, and its blocks per SM:
constexpr int kTermMinBlocks = 4;    // 16 warps at <= 128 registers (tools/ab_narrow_kernels.py)
constexpr int kDdThreads = 256;
constexpr int kTileP = 16;           // paths per candidate block
constexpr int kMaxCand = 256;        // ops/multi_dd.py MAX_CANDIDATES

// Four floats of shared memory, loaded anew at every use (garch.cu's lds128):
// the volatile load keeps the compiler from holding all of L_R in registers
// across the unrolled steps of a Philox call.
__device__ __forceinline__ float4 lds128(const float* p) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
  return v;
}

// The parameter block of ops/heston.py HestonTensors.packed: L (A·A), then mu,
// kappa, theta, xi, rho, rho_c, v0 (A each).
struct Params {
  const float *l, *mu, *kappa, *theta, *xi, *rho, *rho_c, *v0;
  __device__ Params(const float* p, int a)
      : l(p), mu(p + a * a), kappa(mu + a), theta(kappa + a), xi(theta + a), rho(xi + a),
        rho_c(rho + a), v0(rho_c + a) {}
};

// Loads L's lower triangle into s_l (kCap x kCap, zero elsewhere) and, per
// asset, (mu, kappa, theta, xi) into s_g and (rho, rho_c, v0, 0) into s_h
// (kCap entries each).
template <int kCap = kHA>
__device__ __forceinline__ void load_params(const Params& q, int a_n, float* s_l, float4* s_g,
                                            float4* s_h, int tid, int n_threads) {
  for (int i = tid; i < kCap * kCap; i += n_threads) {
    const int r = i / kCap, c = i % kCap;
    s_l[i] = (r < a_n && c <= r) ? q.l[r * a_n + c] : 0.0f;
  }
  for (int i = tid; i < kCap; i += n_threads) {
    const bool in = i < a_n;
    s_g[i] = in ? make_float4(q.mu[i], q.kappa[i], q.theta[i], q.xi[i])
                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    s_h[i] = in ? make_float4(q.rho[i], q.rho_c[i], q.v0[i], 0.0f)
                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// One full-truncation step of one asset, rounded as the torch form rounds it:
// returns x and advances v. zc is the correlated return shock, w the variance
// shock, g = (mu, kappa, theta, xi), h = (rho, rho_c, ., .).
__device__ __forceinline__ float heston_step(float zc, float w, float4 g, float4 h, float* v) {
  const float zv = __fadd_rn(__fmul_rn(h.x, zc), __fmul_rn(h.y, w));
  const float vp = fmaxf(*v, 0.0f);
  const float sv = __fsqrt_rn(vp);
  const float x = __fadd_rn(__fsub_rn(g.x, __fmul_rn(0.5f, vp)), __fmul_rn(sv, zc));
  *v = __fadd_rn(__fadd_rn(*v, __fmul_rn(g.y, __fsub_rn(g.z, vp))),
                 __fmul_rn(__fmul_rn(g.w, sv), zv));
  return x;
}

// One Philox call c of the terminal kernel's path, asset by asset: the return
// shocks of every asset first; then for each asset in ascending order its
// variance shocks, its row of L and its parameters once, its (v, acc) from
// the thread's slices of shared memory (sv, sa: asset i at i·kTermThreads),
// and its steps of the call. Each asset's recursion needs the other assets
// only through its correlated shock, so every operation keeps its operands
// and its order. kTail: the last call of a path, of n < 4 steps.
template <bool kTail>
__device__ __forceinline__ void heston_call(int c, int n, uint32_t p, uint32_t key, int n_assets,
                                            const float* s_l, const float4* s_g,
                                            const float4* s_h, volatile float* sv,
                                            volatile float* sa) {
  constexpr int kPer = steps_per_call<kPolyStrict>();
  const int nd = kTail ? n : kPer;
  float z[kPer][kHA];
#pragma unroll
  for (int a = 0; a < kHA; ++a) {
    float za[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (a < n_assets) call_draws<kPolyStrict>(c, a, p, key, nd, 0.0f, 0.0f, za);
#pragma unroll
    for (int k = 0; k < kPer; ++k) z[k][a] = za[k];
  }
#pragma unroll
  for (int i = 0; i < kHA; ++i) {
    if (i < n_assets) {
      float wa[4];
      call_draws<kPolyStrict, kStreamHeston>(c, i, p, key, nd, 0.0f, 0.0f, wa);
      float l[kHA];
#pragma unroll
      for (int j = 0; j <= i; j += 4) {  // row i's lower triangle
        const float4 r = lds128(s_l + i * kHA + j);
        l[j] = r.x;
        l[j + 1] = r.y;
        l[j + 2] = r.z;
        l[j + 3] = r.w;
      }
      const float4 g = lds128(reinterpret_cast<const float*>(s_g + i));
      const float4 h = lds128(reinterpret_cast<const float*>(s_h + i));
      float v = sv[i * kTermThreads], acc = sa[i * kTermThreads];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        if (kTail && k >= n) continue;
        float y = 0.0f;
#pragma unroll
        for (int j = 0; j <= i; ++j) y = __fadd_rn(y, __fmul_rn(l[j], z[k][j]));  // column order
        acc = __fadd_rn(acc, heston_step(y, wa[k], g, h, &v));
      }
      sv[i * kTermThreads] = v;
      sa[i * kTermThreads] = acc;
    }
  }
}

__global__ void __launch_bounds__(kTermThreads, kTermMinBlocks)
heston_terminal_kernel(long long seed, long long first_block, int block_paths, int n_assets,
                       int n_steps, const float* __restrict__ params, float* __restrict__ out) {
  __shared__ __align__(16) float s_l[kHA * kHA];
  __shared__ float4 s_g[kHA];  // (mu, kappa, theta, xi)
  __shared__ float4 s_h[kHA];  // (rho, rho_c, v0, 0)
  __shared__ float s_state[2 * kHA * kTermThreads];  // (v, acc) per asset and thread
  const Params q(params, n_assets);
  load_params(q, n_assets, s_l, s_g, s_h, threadIdx.x, kTermThreads);
  __syncthreads();

  const int p = blockIdx.x * kTermThreads + threadIdx.x;
  if (p >= block_paths) return;
  const int b = blockIdx.y;
  const uint32_t key = block_key(seed, first_block, b);
  constexpr int kPer = steps_per_call<kPolyStrict>();
  volatile float* sv = s_state + threadIdx.x;  // this thread's slices: v, then acc
  volatile float* sa = sv + kHA * kTermThreads;
#pragma unroll
  for (int a = 0; a < kHA; ++a) {
    sv[a * kTermThreads] = a < n_assets ? s_h[a].z : 0.0f;
    sa[a * kTermThreads] = 0.0f;
  }
  const int whole = n_steps / kPer;
  for (int c = 0; c < whole; ++c) {
    heston_call<false>(c, kPer, p, key, n_assets, s_l, s_g, s_h, sv, sa);
  }
  if (n_steps % kPer) {
    heston_call<true>(whole, n_steps % kPer, p, key, n_assets, s_l, s_g, s_h, sv, sa);
  }

  const long long row = static_cast<long long>(b) * block_paths + p;
#pragma unroll
  for (int a = 0; a < kHA; ++a) {
    if (a < n_assets) out[row * n_assets + a] = expm1f(sa[a * kTermThreads]);
  }
}

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

struct DdLayout {  // offsets into dynamic shared memory, in floats, 16-byte aligned
  int l, g, h, w, z, e, total;
  __host__ __device__ DdLayout(int a, int w_pad, int cap) {
    l = 0;
    g = cap * cap;
    h = g + 4 * cap;
    w = h + 4 * cap;
    z = w + a * w_pad;
    e = z + 4 * a * kTileP;
    total = e + a * kTileP;
  }
};

// The (asset, path) items of a 16-path tile per thread of the 256: one for A
// <= 16, four up to kMaxAssets.
template <int kCap>
__host__ __device__ constexpr int tile_items() { return kCap * kTileP / kDdThreads; }

// The terminal kernel at 17 <= A <= 64: the candidate kernel's (asset, path)
// items without the scoring (the parameter block and the shocks in shared
// memory, the weights region empty).
template <int kCap>
__global__ void __launch_bounds__(kDdThreads, 2)
heston_terminal_tile_kernel(long long seed, long long first_block, int block_paths,
                            int n_assets, int n_steps, const float* __restrict__ params,
                            float* __restrict__ out) {
  constexpr int kIt = tile_items<kCap>();
  extern __shared__ __align__(16) float smem[];
  const int a_n = n_assets;
  const DdLayout lay(a_n, 0, kCap);
  float* s_l = smem + lay.l;                              // (kCap, kCap) lower triangle
  float4* s_g = reinterpret_cast<float4*>(smem + lay.g);  // (mu, kappa, theta, xi)
  float4* s_h = reinterpret_cast<float4*>(smem + lay.h);  // (rho, rho_c, v0, 0)
  float* s_z = smem + lay.z;                              // (4, A, kTileP) return shocks
  const int tid = threadIdx.x;
  const Params q(params, a_n);
  load_params<kCap>(q, a_n, s_l, s_g, s_h, tid, kDdThreads);
  __syncthreads();

  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kTileP;
  const uint32_t key = block_key(seed, first_block, b);
  const int n_items = a_n * kTileP;
  float var[kIt], acc[kIt];
#pragma unroll
  for (int r = 0; r < kIt; ++r) {
    const int item = tid + r * kDdThreads;
    var[r] = item < n_items ? s_h[item / kTileP].z : 0.0f;
    acc[r] = 0.0f;
  }

  constexpr int kPer = steps_per_call<kPolyStrict>();
  for (int s0 = 0; s0 < n_steps; s0 += kPer) {
    const int n = min(kPer, n_steps - s0);
    float wa[kIt][4];
#pragma unroll
    for (int r = 0; r < kIt; ++r) {
      const int item = tid + r * kDdThreads;
      if (item < n_items) {
        const int ia = item / kTileP, ip = item % kTileP;
        float za[4];
        call_draws<kPolyStrict>(s0 / kPer, ia, p0 + ip, key, n, 0.0f, 0.0f, za);
        call_draws<kPolyStrict, kStreamHeston>(s0 / kPer, ia, p0 + ip, key, n, 0.0f, 0.0f,
                                               wa[r]);
#pragma unroll
        for (int k = 0; k < kPer; ++k) s_z[(k * a_n + ia) * kTileP + ip] = za[k];
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (k >= n) continue;
#pragma unroll
      for (int r = 0; r < kIt; ++r) {
        const int item = tid + r * kDdThreads;
        if (item < n_items) {
          const int ia = item / kTileP, ip = item % kTileP;
          float y = 0.0f;
          for (int j = 0; j <= ia; ++j) {
            y = __fadd_rn(y, __fmul_rn(s_l[ia * kCap + j], s_z[(k * a_n + j) * kTileP + ip]));
          }
          acc[r] = __fadd_rn(acc[r], heston_step(y, wa[r][k], s_g[ia], s_h[ia], &var[r]));
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
      out[(static_cast<long long>(b) * block_paths + p) * a_n + a] = expm1f(acc[r]);
    }
  }
}

// kCap: the asset bound (kMaxAssets: four (asset, path) items per thread).
// kHedged: per-step settlement of the n_legs legs per asset of the hedge block
// (ops/hedged.py HedgeTensors.packed, in device memory).
template <int kCap, bool kHedged>
__global__ void __launch_bounds__(kDdThreads, 2)
heston_dd_kernel(long long seed, long long first_block, int block_paths, int n_assets,
                 int n_cand, int n_steps, int n_legs, const float* __restrict__ params,
                 const float* __restrict__ weights, const float* __restrict__ hedge,
                 float* __restrict__ term, float* __restrict__ max_dd) {
  constexpr int kIt = tile_items<kCap>();
  extern __shared__ __align__(16) float smem[];
  const int a_n = n_assets;
  const int w_pad = round4(n_cand);
  const DdLayout lay(a_n, w_pad, kCap);
  float* s_l = smem + lay.l;                              // (kCap, kCap) lower triangle
  float4* s_g = reinterpret_cast<float4*>(smem + lay.g);  // (mu, kappa, theta, xi)
  float4* s_h = reinterpret_cast<float4*>(smem + lay.h);  // (rho, rho_c, v0, 0)
  float* s_w = smem + lay.w;                              // (A, w_pad) weights
  float* s_z = smem + lay.z;                              // (4, A, kTileP) return shocks
  float* s_e = smem + lay.e;                              // (A, kTileP) exp(x), hedged r_h

  const int tid = threadIdx.x;
  const Params q(params, a_n);
  load_params<kCap>(q, a_n, s_l, s_g, s_h, tid, kDdThreads);
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
  float var[kIt];  // each item's variance, from v0
  float price[kIt];  // hedged: each item's price, from s0
#pragma unroll
  for (int r = 0; r < kIt; ++r) {
    const int item = tid + r * kDdThreads;
    var[r] = item < n_items ? s_h[item / kTileP].z : 0.0f;
    price[r] = (kHedged && item < n_items) ? hedge[item / kTileP] : 0.0f;
  }
  const HedgeBlock legs(hedge, a_n, n_legs);  // hedged: the legs, read from device memory

  constexpr int kPer = steps_per_call<kPolyStrict>();
  for (int s0 = 0; s0 < n_steps; s0 += kPer) {
    const int n = min(kPer, n_steps - s0);
    float wa[kIt][4];
#pragma unroll
    for (int r = 0; r < kIt; ++r) {
      const int item = tid + r * kDdThreads;
      if (item < n_items) {
        const int ia = item / kTileP, ip = item % kTileP;
        float za[4];
        call_draws<kPolyStrict>(s0 / kPer, ia, p0 + ip, key, n, 0.0f, 0.0f, za);
        call_draws<kPolyStrict, kStreamHeston>(s0 / kPer, ia, p0 + ip, key, n, 0.0f, 0.0f,
                                               wa[r]);
#pragma unroll
        for (int k = 0; k < kPer; ++k) s_z[(k * a_n + ia) * kTileP + ip] = za[k];
      }
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (k >= n) continue;
#pragma unroll
      for (int r = 0; r < kIt; ++r) {
        const int item = tid + r * kDdThreads;
        if (item < n_items) {
          const int ia = item / kTileP, ip = item % kTileP;
          float y = 0.0f;
          for (int j = 0; j <= ia; ++j) {
            y = __fadd_rn(y, __fmul_rn(s_l[ia * kCap + j], s_z[(k * a_n + j) * kTileP + ip]));
          }
          const float g = expf(heston_step(y, wa[r][k], s_g[ia], s_h[ia], &var[r]));
          if (kHedged) {  // the settled return of the move P -> P·exp(x)
            const float p_new = __fmul_rn(price[r], g);
            s_e[ia * kTileP + ip] = hedged_return(legs, ia, price[r], p_new);
            price[r] = p_new;
          } else {
            s_e[ia * kTileP + ip] = g;
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
            if (kHedged) {  // wealth may overflow: NaN carries on (hedged.cuh)
              v[i][j] = v[i][j] * (1.0f + f[i][j]);
              peak[i][j] = max_nan(peak[i][j], v[i][j]);
              dd[i][j] = min_nan(dd[i][j], v[i][j] / peak[i][j] - 1.0f);
            } else {
              v[i][j] = v[i][j] * f[i][j];
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

// ---- kernel #10 up to 16 assets: the redesigned layouts (narrow_dd.cuh) -----------------

// Where the layouts switch (ops/heston.py heston_narrow_plan mirrors them): a
// thread per path scores its own candidates up to kSoloMaxCand, the split
// layout runs up to kSplitMaxCand, the tile layout past that (narrow_dd.cuh).
// Measured on an H100 at 15 assets and 131,072 x 252
// (tools/ab_narrow_kernels.py): solo is the faster up to about 12 candidates
// in both modes, split up to 128 (64 hedged, 1% apart at 128), tile from 192
// (4% faster at 256, 14% hedged).
constexpr int kSoloMaxCand = 12;
constexpr int kSplitMaxCand = 128;

__host__ __device__ constexpr int narrow_layout(int n_cand) {
  return n_cand <= kSoloMaxCand ? kSolo : n_cand <= kSplitMaxCand ? kSplit : kTileLayout;
}

// The recursion part's shared memory, in floats: L's lower triangle (kHA x
// kHA), (mu, kappa, theta, xi) and (rho, rho_c, v0, 0) per asset, the hedge
// block (hedged), the solo part's weights (W, kHA); then per thread slices
// (stride kSoloThreads): one Philox call's variance shocks (4 x kHA), the
// prices (kHA, hedged) and the solo part's values, peaks and drawdowns (3 x
// W).
struct RecurLayout {
  int l, g, h, hedge, w, wv, p, st, total;
  __host__ __device__ RecurLayout(int n, int n_cand, int mode, int n_legs) {
    l = 0;
    g = kHA * kHA;
    h = g + 4 * kHA;
    hedge = h + 4 * kHA;
    w = hedge + (n_legs ? round4n(hedge_floats(n, n_legs)) : 0);
    wv = w + (mode == kOwn ? n_cand * kHA : 0);
    p = wv + 4 * kHA * kSoloThreads;
    st = p + (n_legs ? kHA * kSoloThreads : 0);
    total = st + (mode == kOwn ? 3 * n_cand * kSoloThreads : 0);
  }
};

// The recursion, a thread per path, for chunk paths 0 .. chunk-1 (path
// first_path + cp of each dispatch block): the terminal kernel's path (the
// strict draws, the column-order correlate of the lower triangle under
// __fmul_rn/__fadd_rn, heston_step) with its variance in registers, then
// exp(x), hedged the price __fmul_rn(P, exp(x)) and the settled return.
// kOwn scores the thread's own candidates (narrow_dd.cuh solo_score),
// kReturns writes the returns to rets (returns_slot).
template <bool kHedged, int kMode>
__global__ void __launch_bounds__(kSoloThreads, 4)
heston_recur_kernel(long long seed, long long first_block, int block_paths, int first_path,
                    int chunk, int n_assets, int n_cand, int n_steps, int n_legs,
                    const float* __restrict__ params, const float* __restrict__ weights,
                    const float* __restrict__ hedge, float* __restrict__ rets,
                    float* __restrict__ term, float* __restrict__ max_dd) {
  constexpr int kS = kSoloThreads;  // the per-thread slices' stride
  extern __shared__ __align__(16) float smem[];
  const int n = n_assets, tid = threadIdx.x, blk = blockIdx.y;
  const RecurLayout lay(n, n_cand, kMode, kHedged ? n_legs : 0);
  float* s_l = smem + lay.l;
  float4* s_g = reinterpret_cast<float4*>(smem + lay.g);
  float4* s_hh = reinterpret_cast<float4*>(smem + lay.h);
  float* s_hedge = smem + lay.hedge;
  float* s_w = smem + lay.w;
  const Params q(params, n);
  load_params(q, n, s_l, s_g, s_hh, tid, kS);
  if (kHedged) {
    for (int i = tid; i < hedge_floats(n, n_legs); i += kS) s_hedge[i] = hedge[i];
  }
  if (kMode == kOwn) {
    for (int i = tid; i < n_cand * kHA; i += kS) {
      const int c = i / kHA, a = i % kHA;
      s_w[i] = a < n ? weights[c * n + a] : 0.0f;
    }
  }
  __syncthreads();

  const int cp = blockIdx.x * kS + tid;  // this thread's path of the chunk
  const uint32_t p = static_cast<uint32_t>(first_path + cp);
  const uint32_t key = block_key(seed, first_block, blk);
  const HedgeBlock legs(s_hedge, n, n_legs);
  float* s_wv = smem + lay.wv + tid;  // the call's variance shocks, (4, kHA)
  float* s_p = smem + lay.p + tid;    // hedged: the prices, from s0
  float* s_st = smem + lay.st + tid;
  if (kHedged) {
    for (int a = 0; a < n; ++a) s_p[a * kS] = s_hedge[a];
  }
  if (kMode == kOwn) solo_start(n_cand, s_st);
  float* rg = kMode == kReturns ? returns_slot(rets, blk, chunk, cp, n_steps, n) : nullptr;
  const bool writes = cp < (chunk + kTile - 1) / kTile * kTile;  // whole tiles of the scratch
  float var[kHA];
#pragma unroll
  for (int a = 0; a < kHA; ++a) var[a] = a < n ? s_hh[a].z : 0.0f;
  constexpr int kPer = steps_per_call<kPolyStrict>();
  for (int s0 = 0; s0 < n_steps; s0 += kPer) {
    const int nk = min(kPer, n_steps - s0);
    float z[kPer][kHA];
#pragma unroll
    for (int a = 0; a < kHA; ++a) {
      float za[4] = {0.0f, 0.0f, 0.0f, 0.0f}, wa[4];
      if (a < n) {
        call_draws<kPolyStrict>(s0 / kPer, a, p, key, nk, 0.0f, 0.0f, za);
        call_draws<kPolyStrict, kStreamHeston>(s0 / kPer, a, p, key, nk, 0.0f, 0.0f, wa);
#pragma unroll
        for (int k = 0; k < kPer; ++k) s_wv[(k * kHA + a) * kS] = wa[k];
      }
#pragma unroll
      for (int k = 0; k < kPer; ++k) z[k][a] = za[k];
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (k >= nk) continue;  // (not break: a loop that may break is not unrolled)
      float e[kHA];
#pragma unroll
      for (int i = 0; i < kHA; ++i) {
        e[i] = 0.0f;
        if (i < n) {
          float y = 0.0f;
#pragma unroll
          for (int j = 0; j <= i; j += 4) {  // row i's lower triangle only, in column order
            const float4 l = lds128(s_l + i * kHA + j);
            y = __fadd_rn(y, __fmul_rn(l.x, z[k][j]));
            if (j + 1 <= i) y = __fadd_rn(y, __fmul_rn(l.y, z[k][j + 1]));
            if (j + 2 <= i) y = __fadd_rn(y, __fmul_rn(l.z, z[k][j + 2]));
            if (j + 3 <= i) y = __fadd_rn(y, __fmul_rn(l.w, z[k][j + 3]));
          }
          const float4 g = lds128(reinterpret_cast<const float*>(s_g + i));
          const float4 h = lds128(reinterpret_cast<const float*>(s_hh + i));
          const float gx = expf(heston_step(y, s_wv[(k * kHA + i) * kS], g, h, &var[i]));
          // hedged: the move P -> P·exp(x), settled below
          e[i] = kHedged ? __fmul_rn(s_p[i * kS], gx) : gx;
        }
      }
      if (kHedged) settle_all<kS>(legs, n, s_p, e);
      if (kMode == kOwn) {
        solo_score<kHedged ? kSimpleNan : kGross>(n, n_cand, s_w, s_st, e);
      } else if (writes) {
#pragma unroll
        for (int i = 0; i < kHA; ++i) {
          if (i < n) rg[((s0 + k) * n + i) * kTile] = e[i];
        }
      }
    }
  }
  if (kMode == kOwn && cp < chunk) solo_store(n_cand, blk, block_paths, p, s_st, term, max_dd);
}

// The tile layout's shared memory, in floats: L's lower triangle (kHA x kHA),
// (mu, kappa, theta, xi) and (rho, rho_c, v0, 0) per asset, the hedge block
// (hedged), the weights (A, w_pad), then two buffers each of one Philox
// call's return shocks (4, A, kTile) and of its returns (4, A, kTile).
struct TileLayout {
  int l, g, h, hedge, w, z, e, total;
  __host__ __device__ TileLayout(int n, int w_pad, int n_legs) {
    l = 0;
    g = kHA * kHA;
    h = g + 4 * kHA;
    hedge = h + 4 * kHA;
    w = hedge + (n_legs ? round4n(hedge_floats(n, n_legs)) : 0);
    z = w + n * w_pad;
    e = z + 2 * 4 * n * kTile;
    total = e + 2 * 4 * n * kTile;
  }
};

// The tile layout: a block owns 16 paths and every candidate; thread tid is
// the (asset, path) item (tid / 16, tid % 16) of the tile, its variance and
// one Philox call's variance shocks in registers, and the scorer of
// candidates 4·(tid / 4) .. +3 of tile paths 4·(tid % 4) .. +3. Per Philox
// call c, between two barriers: the items compute call c's four steps of
// returns from its return shocks (buffer c % 2) into s_e (buffer c % 2),
// then draw call c + 1's shocks into the other buffer, and the scorers run
// call c - 1's four steps of returns.
template <bool kHedged>
__global__ void __launch_bounds__(kDdThreads, 2)
heston_tile_kernel(long long seed, long long first_block, int block_paths, int n_assets,
                   int n_cand, int n_steps, int n_legs, const float* __restrict__ params,
                   const float* __restrict__ weights, const float* __restrict__ hedge,
                   float* __restrict__ term, float* __restrict__ max_dd) {
  extern __shared__ __align__(16) float smem[];
  const int n = n_assets, tid = threadIdx.x;
  const int w_pad = round4(n_cand);
  const TileLayout lay(n, w_pad, kHedged ? n_legs : 0);
  float* s_l = smem + lay.l;
  float4* s_g = reinterpret_cast<float4*>(smem + lay.g);
  float4* s_hh = reinterpret_cast<float4*>(smem + lay.h);
  float* s_hedge = smem + lay.hedge;
  float* s_w = smem + lay.w;
  const Params q(params, n);
  load_params(q, n, s_l, s_g, s_hh, tid, kDdThreads);
  if (kHedged) {
    for (int i = tid; i < hedge_floats(n, n_legs); i += kDdThreads) s_hedge[i] = hedge[i];
  }
  for (int i = tid; i < n * w_pad; i += kDdThreads) {
    const int a = i / w_pad, w = i % w_pad;
    s_w[i] = w < n_cand ? weights[w * n + a] : 0.0f;
  }

  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kTile;
  const uint32_t key = block_key(seed, first_block, b);
  constexpr int kPer = steps_per_call<kPolyStrict>();
  const bool item = tid < n * kTile;
  const int ia = tid / kTile, ip = tid % kTile;
  const HedgeBlock legs(s_hedge, n, n_legs);
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
  float wa[4];  // the item's variance shocks of the call it computes next
  // call c's return shocks into buffer c % 2, its variance shocks into wa
  auto draw = [&](int c) {
    if (item) {
      const int nk = min(kPer, n_steps - c * kPer);
      float za[4];
      call_draws<kPolyStrict>(c, ia, p0 + ip, key, nk, 0.0f, 0.0f, za);
      call_draws<kPolyStrict, kStreamHeston>(c, ia, p0 + ip, key, nk, 0.0f, 0.0f, wa);
      float* zb = smem + lay.z + (c % 2) * 4 * n * kTile;
#pragma unroll
      for (int k = 0; k < kPer; ++k) zb[(k * n + ia) * kTile + ip] = za[k];
    }
  };
  const int calls = (n_steps + kPer - 1) / kPer;
  __syncthreads();
  float var = item ? s_hh[ia].z : 0.0f;                   // from v0
  float price = (kHedged && item) ? s_hedge[ia] : 0.0f;  // hedged: from s0
  if (calls > 0) draw(0);
  __syncthreads();
  for (int c = 0; c <= calls; ++c) {
    if (c < calls) {
      const int nk = min(kPer, n_steps - c * kPer), buf = c % 2;
      if (item) {
        const float* zb = smem + lay.z + buf * 4 * n * kTile;
        float* eb = smem + lay.e + buf * 4 * n * kTile;
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          if (k >= nk) continue;
          float y = 0.0f;
          for (int j = 0; j <= ia; ++j) {
            y = __fadd_rn(y, __fmul_rn(s_l[ia * kHA + j], zb[(k * n + j) * kTile + ip]));
          }
          const float gx = expf(heston_step(y, wa[k], s_g[ia], s_hh[ia], &var));
          if (kHedged) {  // the settled return of the move P -> P·exp(x)
            const float p_new = __fmul_rn(price, gx);
            eb[(k * n + ia) * kTile + ip] = settle(legs, ia, price, p_new);
            price = p_new;
          } else {
            eb[(k * n + ia) * kTile + ip] = gx;
          }
        }
      }
      if (c + 1 < calls) draw(c + 1);
    }
    if (c > 0 && scorer) {
      const int nk = min(kPer, n_steps - (c - 1) * kPer);
      const float* eb = smem + lay.e + ((c - 1) % 2) * 4 * n * kTile;
      for (int k = 0; k < nk; ++k) {
        tile_score<kHedged ? kSimpleNan : kGross>(n, w_pad, cw, pq, s_w, eb + k * n * kTile,
                                                  kTile, v, peak, dd);
      }
    }
    __syncthreads();
  }
  if (scorer) tile_store(n_cand, b, block_paths, p0, cw, pq, v, dd, term, max_dd);
}

// Kernels #9 and #10 past 64 assets: wide.cuh's layout with the narrow
// kernels' path, every operation rounded as the plain form rounds it (the
// strict draws, the column-order correlate under __fmul_rn/__fadd_rn,
// heston_step), so the path state equals the plain form's bit for bit at any
// width. State: the variance and the call's four variance shocks, and the
// terminal's log sum or, hedged, the price.
template <bool kCand, bool kHedged = false>
struct HestonWide : WideModelBase {
  static constexpr int kState = (kCand && !kHedged) ? 5 : 6;
  static constexpr int kPer = steps_per_call<kPolyStrict>();
  static constexpr int kValue = kHedged ? kWideHedged : kWideGross;
  const float *params, *hedge;  // HestonTensors.packed; the hedge block
  int n_legs;

  __host__ __device__ static int smem_floats(int a, int tp) { return kPer * a * tp; }
  __device__ void start(const WideTile& t, int a, int p) const {
    t.at(0, a, p) = __ldg(Params(params, t.a_n).v0 + a);
    if (!kCand) t.at(5, a, p) = 0.0f;
    if (kHedged) t.at(5, a, p) = __ldg(hedge + a);
  }
  __device__ void draw(const WideTile& t, float* s, int call, int n, int a, int p) const {
    float za[4], wa[4];
    wide_draw<kPolyStrict>(t, s, call, n, a, p, 0.0f, 0.0f, za);
    call_draws<kPolyStrict, kStreamHeston>(call, a, t.p0 + p, t.key, n, 0.0f, 0.0f, wa);
#pragma unroll
    for (int k = 0; k < kPer; ++k) t.at(1 + k, a, p) = wa[k];
  }
  __device__ float step(const WideTile& t, float* s, int k, int a, int p) const {
    const Params q(params, t.a_n);
    const float* row = q.l + static_cast<long long>(a) * t.a_n;
    const float* z = s + k * t.a_n * t.tp + p;
    float y = 0.0f;
    for (int j = 0; j <= a; ++j) y = __fadd_rn(y, __fmul_rn(__ldg(row + j), z[j * t.tp]));
    const float4 g = make_float4(__ldg(q.mu + a), __ldg(q.kappa + a), __ldg(q.theta + a),
                                 __ldg(q.xi + a));
    const float4 h = make_float4(__ldg(q.rho + a), __ldg(q.rho_c + a), 0.0f, 0.0f);
    const float x = heston_step(y, t.at(1 + k, a, p), g, h, &t.at(0, a, p));
    if (!kCand) {
      t.at(5, a, p) = __fadd_rn(t.at(5, a, p), x);
      return 0.0f;
    }
    if (kHedged) {  // the settled return of the move P -> P·exp(x)
      float& price = t.at(5, a, p);
      const float p_new = __fmul_rn(price, expf(x));
      const float e = hedged_return(HedgeBlock(hedge, t.a_n, n_legs), a, price, p_new);
      price = p_new;
      return e;
    }
    return expf(x);
  }
  __device__ float out(const WideTile& t, int a, int p) const { return expm1f(t.at(5, a, p)); }
};

}  // namespace

extern "C" {

// Launches the terminal kernel on `stream` for blocks first_block+1 ..
// first_block+n_blocks. params: ops/heston.py HestonTensors.packed, float32 on
// the device. Output out: (n_blocks, block_paths, n_assets) float32. wide:
// nonzero runs the tile kernel of 17-64 assets at any width. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for arguments
// the kernel does not take.
int mcport_heston_terminal(long long seed, long long first_block, int n_blocks,
                           int block_paths, int n_assets, int n_steps, int wide,
                           const void* params, void* out, void* stream) {
  if (n_assets < 1 || n_assets > kMaxAssets || n_blocks < 1 || n_blocks > 65535 ||
      block_paths < 1 || n_steps < 0 ||
      kMaxAssets * kTileP != tile_items<kMaxAssets>() * kDdThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_assets > kHA || wide) {
    const dim3 grid((block_paths + kTileP - 1) / kTileP, n_blocks);
    const size_t smem = sizeof(float) * DdLayout(n_assets, 0, kMaxAssets).total;
    auto kernel = heston_terminal_tile_kernel<kMaxAssets>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kDdThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        seed, first_block, block_paths, n_assets, n_steps, static_cast<const float*>(params),
        static_cast<float*>(out));
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid((block_paths + kTermThreads - 1) / kTermThreads, n_blocks);
  heston_terminal_kernel<<<grid, kTermThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      seed, first_block, block_paths, n_assets, n_steps, static_cast<const float*>(params),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Launches the candidate function on `stream` for blocks first_block+1 ..
// first_block+n_blocks. params: HestonTensors.packed; weights: (n_cand,
// n_assets); float32 on the device. hedge: ops/hedged.py HedgeTensors.packed
// for n_legs legs per asset, or null with n_legs 0 for the unhedged mode.
// Outputs term and dd: (n_blocks, n_cand, block_paths) float32. Up to 16
// assets the layout is narrow_layout(n_cand) (layout -1), or the one named (0
// solo, 1 split, 2 tile); the split layout takes its
// returns through scratch (scratch_floats floats on the device) in chunks of
// paths that it holds for every block and step (a multiple of 64 paths;
// ops/heston.py heston_narrow_plan sizes it), the others take no scratch
// (null, 0). From 17 assets, or with wide nonzero at any width, the 64-asset
// instantiation runs (the hedge read from device memory; layout -1). Returns
// cudaGetLastError() after the last launch, or cudaErrorInvalidValue for
// arguments the kernel does not take.
int mcport_heston_multi_dd(long long seed, long long first_block, int n_blocks,
                           int block_paths, int n_assets, int n_cand, int n_steps, int wide,
                           int n_legs, const void* params, const void* weights,
                           const void* hedge, void* term, void* dd, void* scratch,
                           long long scratch_floats, int layout, void* stream) {
  if (n_assets < 1 || n_assets > kMaxAssets || n_cand < 1 || n_cand > kMaxCand ||
      n_blocks < 1 || n_blocks > 65535 || block_paths < 1 || n_steps < 0 || n_legs < 0 ||
      (n_legs > 0 && hedge == nullptr) ||
      kHA * kTileP != tile_items<kHA>() * kDdThreads ||
      kMaxAssets * kTileP != tile_items<kMaxAssets>() * kDdThreads || scratch_floats < 0 ||
      layout < -1 || layout > kTileLayout || ((wide || n_assets > kHA) && layout >= 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static_assert(kHA == kNA && kMaxCand / 4 * score_groups(kMaxCand) <= kScoreThreads &&
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
  if (wide || n_assets > kHA) {  // heston_dd_kernel<kMaxAssets>, the 17-64-asset layout
    const dim3 grid((block_paths + kTileP - 1) / kTileP, n_blocks);
    const size_t smem = sizeof(float) * DdLayout(n_assets, round4(n_cand), kMaxAssets).total;
    auto run = [&](auto kernel) {
      int err = start(kernel, smem);
      if (err) return err;
      kernel<<<grid, kDdThreads, smem, st>>>(seed, first_block, block_paths, n_assets, n_cand,
                                             n_steps, n_legs, prm, wts, hdg, out, out_dd);
      return static_cast<int>(cudaGetLastError());
    };
    return n_legs ? run(heston_dd_kernel<kMaxAssets, true>)
                  : run(heston_dd_kernel<kMaxAssets, false>);
  }
  if (layout < 0) layout = narrow_layout(n_cand);
  if (layout == kTileLayout) {
    const dim3 grid((block_paths + kTile - 1) / kTile, n_blocks);
    const size_t smem = sizeof(float) * TileLayout(n_assets, round4(n_cand), n_legs).total;
    auto run = [&](auto kernel) {
      int err = start(kernel, smem);
      if (err) return err;
      kernel<<<grid, kDdThreads, smem, st>>>(seed, first_block, block_paths, n_assets, n_cand,
                                             n_steps, n_legs, prm, wts, hdg, out, out_dd);
      return static_cast<int>(cudaGetLastError());
    };
    return n_legs ? run(heston_tile_kernel<true>) : run(heston_tile_kernel<false>);
  }
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
    return n_legs ? recur(heston_recur_kernel<true, kOwn>, kOwn, 0, block_paths)
                  : recur(heston_recur_kernel<false, kOwn>, kOwn, 0, block_paths);
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
              : n_legs     ? recur(heston_recur_kernel<true, kReturns>, kReturns, first, m)
                           : recur(heston_recur_kernel<false, kReturns>, kReturns, first, m);
    if (err) return err;
    auto score = [&](auto kernel) {
      int e = start(kernel, score_smem);
      if (e) return e;
      const dim3 grid((m + paths - 1) / paths, n_blocks);
      kernel<<<grid, kScoreThreads, score_smem, st>>>(block_paths, first, m, n_assets, n_cand,
                                                      n_steps, wts, r, out, out_dd);
      return static_cast<int>(cudaGetLastError());
    };
    err = n_legs ? score(score_kernel<kSimpleNan>) : score(score_kernel<kGross>);
    if (err) return err;
  }
  return 0;
}

// Both functions past 64 assets (wide.cuh's layout with the HestonWide
// model): n_cand 0 runs the terminal function (output out (n_blocks,
// block_paths, n_assets)), n_cand >= 1 the candidates' (hedged when n_legs >
// 0, the hedge block read from device memory; outputs out and dd (n_blocks,
// n_cand, block_paths)). scratch: WIDE_CTAS·tp·A·kState floats on the device
// (6, the unhedged candidates' 5), tp paths per tile, n_ctas persistent CTAs.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments the layout does not take.
int mcport_heston_wide(long long seed, long long first_block, int n_blocks, int block_paths,
                       int n_assets, int n_cand, int n_steps, int n_legs, const void* params,
                       const void* weights, const void* hedge, void* out, void* dd,
                       void* scratch, int tp, int n_ctas, void* stream) {
  if (n_cand < 0 || n_cand > kMaxCand || n_legs < 0 || (n_legs > 0 && hedge == nullptr) ||
      (n_cand == 0 && n_legs > 0)) {
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
    return wide_launch(g, model, n_ctas, static_cast<cudaStream_t>(stream));
  };
  if (!cand) return run(HestonWide<false>{});
  return n_legs ? run(HestonWide<true, true>{}) : run(HestonWide<true, false>{});
}

}  // extern "C"
