// Many candidate portfolios scored over one shared set of common-jump Merton
// paths on Hopper: per (candidate, path), the terminal simple return and the
// maximum drawdown of per-period rebalanced wealth.
//
// Replaces mcport/ops/pallas_jump.py::_jump_dd_kernel, both modes, the TPU
// kernel of path-risk --models jump and the jump drawdown frontier, hedged or
// not. The plain torch form of the same function, on the same Philox
// counters, is mcport_torch/ops/jump.py::merton_multi_dd_reference.
//
// What it computes. For block b of a dispatch group and path p < block_paths,
// step by step: draw z (gbm_draws.cuh, STREAM_GBM: kernel #3's shocks), x = m
// + L z; draw the step's jump clock (STREAM_JUMP: one Philox call per two
// steps of a path — words 0 and 1 the event uniforms, words 2 and 3 one poly
// Box-Muller pair, the common jump normals jn) and, where the uniform is below
// float32(lambda), add muJ + sigJ·jn to every asset's x (the same jn for all
// assets: systemic jumps); then for every candidate w, V *= W_w·exp(x), peak =
// max(peak, V), dd = min(dd, V/peak - 1) from V_0 = peak_0 = 1, dd_0 = 0. Out:
// V_T - 1 and dd per (candidate, path). Scores are FP32 FMAs (mcport's
// score_dot is float32). Hedged (kHedged, mcport's hedged branch,
// pallas_jump.py:100-120): each (asset, path) item carries its price P from
// s0 in a register, P_new = P·exp(x) with the same jump clock, the item
// writes hedged.cuh's settled return r_h(P, P_new) in place of exp(x), and
// V *= 1 + W_w·r_h — multi_dd.cu's hedged step on the jumped increment,
// its peak and dd carrying a NaN of overflowed wealth as multi_dd.cu's do.
//
// The diffusion and the score are multi_dd.cu's rebalanced float32 code,
// copied operation for operation (and not shared through a header, which
// would change kernel #3's build): at lambda = 0 no step jumps, x gains
// nothing, and this kernel's output is kernel #3's rebalanced output bit for
// bit. The jump term is added with __fadd_rn/__fmul_rn in the plain form's
// order, x + (muJ + sigJ·jn), so the jump itself is not contracted.
//
// What bounds it on the card. Per path-step: kernel #3's rebalanced work (A
// shocks at a quarter of a Philox call each, A² FMAs of L z and A exps,
// shared by all candidates, and W·A scoring FMAs) plus half a Philox call and
// half a Box-Muller pair for the jump clock, and A FADDs on a jump step. At W
// = 256 and A = 15 the scoring is ~90% of the arithmetic: bound by FP32 issue;
// nothing is read per step and 8·W bytes per path are stored once. At W = 1
// (the path-risk engine) the recursion is nearly all the work. The designs:
// - up to 16 assets, the layout narrow_layout picks by W (narrow_dd.cuh;
//   ops/jump.py merton_narrow_plan): up to 10 candidates a thread per path
//   (64 per block) runs the recursion with one Philox call's shocks and its
//   two jump calls in registers and scores its own candidates; past 10 the
//   same recursion writes its returns to a device scratch and scoring blocks
//   (each thread 4 candidates x 4 paths) read them. Hedged, the thread keeps
//   its prices in a slice of shared memory and settles leg by leg across the
//   assets.
// - 17-64 assets (jump_dd_kernel, kernel #3's design): a block owns a tile of
//   16 paths and all candidates; per Philox call (four steps) its threads
//   draw the (asset, path) shocks into shared memory, and 32 threads draw the
//   tile's two jump calls per path (the four steps' events and normals); per
//   step each (asset, path) item correlates, adds its jump and writes exp(x)
//   to shared memory; then each thread updates a 4-candidate x 4-path
//   micro-tile whose values, peaks and drawdowns stay in registers.
// Every layout computes each path's operations in the same order, so their
// outputs are equal bit for bit. A dispatch group of blocks is one launch
// (gridDim.y; the split layout's two per chunk).
//
// Past 64 assets the kernel runs wide.cuh's layout with its GbmWide model
// (the same operations; the hedge read from device memory).
//
// Candidate rows past W and paths past block_paths are computed (weights zero,
// valid counters) but never stored.

#include "gbm_draws.cuh"
#include "hedged.cuh"
#include "narrow_dd.cuh"
#include "wide.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileP = 16;          // paths per block
constexpr int kMaxCand = 256;       // ops/multi_dd.py MAX_CANDIDATES
constexpr int kItems = 4;           // (asset, path) items per thread: kMaxAssets·kTileP / kThreads

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

struct Layout {  // offsets into dynamic shared memory, in floats, 16-byte aligned
  int chol, mean, muj, sigj, w, z, e, ev, jn, hedge, total;
  __host__ __device__ Layout(int a, int w_pad, int n_legs) {
    chol = 0;
    mean = round4(chol + a * a);
    muj = round4(mean + a);
    sigj = round4(muj + a);
    w = round4(sigj + a);
    z = w + a * w_pad;
    e = z + 4 * a * kTileP;
    ev = e + a * kTileP;
    jn = ev + 4 * kTileP;
    hedge = jn + 4 * kTileP;
    total = hedge + (n_legs ? hedge_floats(a, n_legs) : 0);
  }
};

template <bool kHedged>
__global__ void __launch_bounds__(kThreads, 2)
jump_dd_kernel(long long seed, long long first_block, int block_paths, int n_assets,
               int n_cand, int n_steps, int n_legs, float lam,
               const float* __restrict__ params, const float* __restrict__ weights,
               const float* __restrict__ hedge, float* __restrict__ term,
               float* __restrict__ max_dd) {
  extern __shared__ __align__(16) float smem[];
  const int a_n = n_assets;
  const int w_pad = round4(n_cand);
  const Layout lay(a_n, w_pad, kHedged ? n_legs : 0);
  float* s_chol = smem + lay.chol;  // (A, A)
  float* s_mean = smem + lay.mean;  // (A,)
  float* s_muj = smem + lay.muj;    // (A,) jump means
  float* s_sigj = smem + lay.sigj;  // (A,) jump vols
  float* s_w = smem + lay.w;        // (A, w_pad) score weights
  float* s_z = smem + lay.z;        // (4, A, kTileP): the shocks of one Philox call
  float* s_e = smem + lay.e;        // (A, kTileP): exp(x)
  float* s_ev = smem + lay.ev;      // (4, kTileP): 1 on a jump step, else 0
  float* s_jn = smem + lay.jn;      // (4, kTileP): the steps' common jump normals
  float* s_h = smem + lay.hedge;    // hedged: the hedge block (hedged.cuh)

  // params: ops/jump.py's block — L (A·A), then m, muJ, sigJ (A each)
  const int tid = threadIdx.x;
  if (kHedged) {
    for (int i = tid; i < hedge_floats(a_n, n_legs); i += kThreads) s_h[i] = hedge[i];
  }
  const HedgeBlock legs(s_h, a_n, n_legs);
  for (int i = tid; i < a_n * a_n; i += kThreads) s_chol[i] = params[i];
  for (int i = tid; i < a_n; i += kThreads) {
    s_mean[i] = params[a_n * a_n + i];
    s_muj[i] = params[a_n * a_n + a_n + i];
    s_sigj[i] = params[a_n * a_n + 2 * a_n + i];
  }
  for (int i = tid; i < a_n * w_pad; i += kThreads) {
    const int a = i / w_pad, w = i % w_pad;
    s_w[i] = w < n_cand ? weights[w * a_n + a] : 0.0f;
  }

  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kTileP;
  const uint32_t key = block_key(seed, first_block, b);
  constexpr int kPer = steps_per_call<kPoly>();
  const int n_items = a_n * kTileP;
  float price[kItems];  // hedged: the price of this thread's (asset, path) items
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int item = tid + r * kThreads;
    price[r] = (kHedged && item < n_items) ? hedge[item / kTileP] : 0.0f;
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
        call_draws<kPoly>(s0 / kPer, a, p0 + p, key, n, 0.0f, 0.0f, za);
#pragma unroll
        for (int k = 0; k < kPer; ++k) s_z[(k * a_n + a) * kTileP + p] = za[k];
      }
    }
    if (tid < 2 * kTileP) {  // the jump clock: calls s0/2 and s0/2 + 1 of each path
      const int half = tid / kTileP, p = tid % kTileP;
      const Words wd = philox4x32_10(static_cast<uint32_t>(s0 / 2 + half), 0u,
                                     static_cast<uint32_t>(p0 + p), kStreamJump, key, 0u);
      float j1, j2;
      boxmuller<false>(bits_to_unit(wd.w2), bits_to_unit(wd.w3), &j1, &j2);
      const int k = 2 * half;
      s_ev[k * kTileP + p] = bits_to_unit(wd.w0) < lam ? 1.0f : 0.0f;
      s_ev[(k + 1) * kTileP + p] = bits_to_unit(wd.w1) < lam ? 1.0f : 0.0f;
      s_jn[k * kTileP + p] = j1;
      s_jn[(k + 1) * kTileP + p] = j2;
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
          float x = s_mean[a] + y;
          if (s_ev[k * kTileP + p] != 0.0f) {
            x = __fadd_rn(x, __fadd_rn(s_muj[a], __fmul_rn(s_sigj[a], s_jn[k * kTileP + p])));
          }
          if (kHedged) {  // the settled return of the move P -> P·exp(x)
            const float p_new = price[r] * expf(x);
            s_e[item] = hedged_return(legs, a, price[r], p_new);
            price[r] = p_new;
          } else {
            s_e[item] = expf(x);
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
            v[i][j] = kHedged ? v[i][j] * (1.0f + f[i][j]) : v[i][j] * f[i][j];
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

// ---- up to 16 assets: the redesigned layouts (narrow_dd.cuh) ------------------------

// Where the layouts switch (ops/jump.py merton_narrow_plan mirrors it): a
// thread per path scores its own candidates up to kSoloMaxCand; past that
// the split layout (narrow_dd.cuh). Measured on an H100 at 15 assets and
// 131,072 x 252 (tools/ab_narrow_kernels.py): solo is the faster up to about
// 10 candidates in both modes, split from there to 256, where the tile layout
// was as fast hedged and 7% slower unhedged, so the jump kernel has no tile
// layout.
constexpr int kSoloMaxCand = 10;

__host__ __device__ constexpr int narrow_layout(int n_cand) {
  return n_cand <= kSoloMaxCand ? kSolo : kSplit;
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

// The recursion part's shared memory, in floats: L (kNA x kNA, zero outside A
// x A), per asset (mean, muJ, sigJ, 0), the hedge block (hedged), the solo
// part's weights (W, kNA), the prices (kNA x paths, hedged) and the solo
// part's values, peaks and drawdowns (3 x W x paths).
struct RecurLayout {
  int l, m, h, w, p, st, total;
  __host__ __device__ RecurLayout(int n, int n_cand, int mode, int n_legs) {
    l = 0;
    m = kNA * kNA;
    h = m + 4 * kNA;
    w = h + (n_legs ? round4n(hedge_floats(n, n_legs)) : 0);
    p = w + (mode == kOwn ? n_cand * kNA : 0);
    st = p + (n_legs ? kNA * kSoloThreads : 0);
    total = st + (mode == kOwn ? 3 * n_cand * kSoloThreads : 0);
  }
};

// The recursion, a thread per path, for chunk paths 0 .. chunk-1 (path
// first_path + cp of each dispatch block): kernel #8's per-path operations in
// their order — the shocks of one Philox call and its two jump calls in
// registers (all loops over assets unrolled), x = m + L z one fmaf per term
// over the row, the jump added as x + (muJ + sigJ·jn), exp(x), hedged the
// price P·exp(x) and the settled return. kOwn scores the thread's own
// candidates (narrow_dd.cuh solo_score), kReturns writes the returns to rets
// (returns_slot).
template <bool kHedged, int kMode>
__global__ void __launch_bounds__(kSoloThreads, 4)
jump_recur_kernel(long long seed, long long first_block, int block_paths, int first_path,
                  int chunk, int n_assets, int n_cand, int n_steps, int n_legs, float lam,
                  const float* __restrict__ params, const float* __restrict__ weights,
                  const float* __restrict__ hedge, float* __restrict__ rets,
                  float* __restrict__ term, float* __restrict__ max_dd) {
  constexpr int kS = kSoloThreads;  // the per-thread slices' stride
  extern __shared__ __align__(16) float smem[];
  const int n = n_assets, tid = threadIdx.x, blk = blockIdx.y;
  const RecurLayout lay(n, n_cand, kMode, kHedged ? n_legs : 0);
  float* s_l = smem + lay.l;
  float* s_m = smem + lay.m;
  float* s_h = smem + lay.h;
  float* s_w = smem + lay.w;
  for (int i = tid; i < kNA * kNA; i += kS) {
    const int r = i / kNA, c = i % kNA;
    s_l[i] = (r < n && c < n) ? params[r * n + c] : 0.0f;
  }
  for (int i = tid; i < 4 * kNA; i += kS) {
    const int a = i / 4, f = i % 4;
    s_m[i] = (a < n && f < 3) ? params[n * n + f * n + a] : 0.0f;
  }
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
  float* s_p = smem + lay.p + tid;   // hedged: the prices, from s0
  float* s_st = smem + lay.st + tid;
  if (kHedged) {
    for (int a = 0; a < n; ++a) s_p[a * kS] = s_h[a];
  }
  if (kMode == kOwn) solo_start(n_cand, s_st);
  float* rg = kMode == kReturns ? returns_slot(rets, blk, chunk, cp, n_steps, n) : nullptr;
  const bool writes = cp < (chunk + kTile - 1) / kTile * kTile;  // whole tiles of the scratch
  constexpr int kPer = steps_per_call<kPoly>();
  for (int s0 = 0; s0 < n_steps; s0 += kPer) {
    const int nk = min(kPer, n_steps - s0);
    float z[kPer][kNA];
#pragma unroll
    for (int a = 0; a < kNA; ++a) {
      float za[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (a < n) call_draws<kPoly>(s0 / kPer, a, p, key, nk, 0.0f, 0.0f, za);
#pragma unroll
      for (int k = 0; k < kPer; ++k) z[k][a] = za[k];
    }
    // the jump clock: calls s0/2 and s0/2 + 1 of the path, two steps each
    bool ev[kPer];
    float jn[kPer];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const Words wd = philox4x32_10(static_cast<uint32_t>(s0 / 2 + half), 0u, p, kStreamJump,
                                     key, 0u);
      boxmuller<false>(bits_to_unit(wd.w2), bits_to_unit(wd.w3), &jn[2 * half],
                       &jn[2 * half + 1]);
      ev[2 * half] = bits_to_unit(wd.w0) < lam;
      ev[2 * half + 1] = bits_to_unit(wd.w1) < lam;
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (k >= nk) continue;  // (not break: a loop that may break is not unrolled)
      float e[kNA];
#pragma unroll
      for (int i = 0; i < kNA; ++i) {
        e[i] = 0.0f;
        if (i < n) {
          float y = 0.0f;
#pragma unroll
          for (int j = 0; j < kNA; j += 4) {  // the row in column order
            if (j < n) {
              const float4 l = lds4(s_l + i * kNA + j);
              y = fmaf(l.x, z[k][j], y);
              if (j + 1 < n) y = fmaf(l.y, z[k][j + 1], y);
              if (j + 2 < n) y = fmaf(l.z, z[k][j + 2], y);
              if (j + 3 < n) y = fmaf(l.w, z[k][j + 3], y);
            }
          }
          const float4 m = lds4(s_m + 4 * i);
          float x = m.x + y;
          if (ev[k]) x = __fadd_rn(x, __fadd_rn(m.y, __fmul_rn(m.z, jn[k])));
          // hedged: the move P -> P·exp(x), settled below
          e[i] = kHedged ? s_p[i * kS] * expf(x) : expf(x);
        }
      }
      if (kHedged) settle_all<kS>(legs, n, s_p, e);
      if (kMode == kOwn) {
        solo_score<kHedged ? kSimpleNan : kGross>(n, n_cand, s_w, s_st, e);
      } else if (writes) {
#pragma unroll
        for (int i = 0; i < kNA; ++i) {
          if (i < n) rg[((s0 + k) * n + i) * kTile] = e[i];
        }
      }
    }
  }
  if (kMode == kOwn && cp < chunk) solo_store(n_cand, blk, block_paths, p, s_st, term, max_dd);
}

}  // namespace

extern "C" {

// Launches the candidate function on `stream` for blocks first_block+1 ..
// first_block+n_blocks. params: ops/jump.py's block — L (n_assets, n_assets)
// row-major, then the per-step mean, jump mean and jump vol (n_assets each);
// weights: (n_cand, n_assets); float32 on the device. lam: the per-step jump
// probability as a float32. hedge: ops/hedged.py HedgeTensors.packed for
// n_legs legs per asset, or null (n_legs 0) for the unhedged mode. Outputs
// term and dd: (n_blocks, n_cand, block_paths) float32. Up to 16 assets the
// layout is narrow_layout(n_cand) (layout -1), or the one named (0 solo, 1
// split); the split layout takes its returns through scratch (scratch_floats
// floats on the device) in chunks of paths that it holds for every block and
// step (a multiple of 64 paths; ops/jump.py merton_narrow_plan sizes it), the
// solo layout takes no scratch (null, 0). From 17 assets jump_dd_kernel runs
// (layout -1). Returns cudaGetLastError()
// after the last launch, or cudaErrorInvalidValue for arguments the kernel
// does not take (among them a hedge too large for a block's shared memory).
int mcport_merton_multi_dd(long long seed, long long first_block, int n_blocks,
                           int block_paths, int n_assets, int n_cand, int n_steps, int n_legs,
                           float lam, const void* params, const void* weights,
                           const void* hedge, void* term, void* dd, void* scratch,
                           long long scratch_floats, int layout, void* stream) {
  if (n_assets < 1 || n_assets > kMaxAssets || n_cand < 1 || n_cand > kMaxCand ||
      n_blocks < 1 || n_blocks > 65535 || block_paths < 1 || n_steps < 0 || n_legs < 0 ||
      (n_legs > 0 && hedge == nullptr) || kMaxAssets * kTileP > kItems * kThreads ||
      scratch_floats < 0 || layout < -1 || layout > kSplit || (n_assets > kNA && layout >= 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static_assert(kMaxCand / 4 * score_groups(kMaxCand) <= kScoreThreads &&
                    4 * score_groups(kMaxCand) % kTile == 0 && kSoloThreads % kTile == 0,
                "a scoring block covers 256 candidates of whole tiles");
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
  if (n_assets > kNA) {  // jump_dd_kernel, the 17-64-asset layout
    const dim3 grid((block_paths + kTileP - 1) / kTileP, n_blocks);
    const size_t smem = sizeof(float) * Layout(n_assets, round4(n_cand), n_legs).total;
    auto run = [&](auto kernel) {
      int err = start(kernel, smem);
      if (err) return err;
      kernel<<<grid, kThreads, smem, st>>>(seed, first_block, block_paths, n_assets, n_cand,
                                           n_steps, n_legs, lam, prm, wts, hdg, out, out_dd);
      return static_cast<int>(cudaGetLastError());
    };
    return n_legs ? run(jump_dd_kernel<true>) : run(jump_dd_kernel<false>);
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
                                             n_assets, n_cand, n_steps, n_legs, lam, prm, wts,
                                             hdg, r, out, out_dd);
    return static_cast<int>(cudaGetLastError());
  };
  if (layout < 0) layout = narrow_layout(n_cand);
  if (layout == kSolo) {
    return n_legs ? recur(jump_recur_kernel<true, kOwn>, kOwn, 0, block_paths)
                  : recur(jump_recur_kernel<false, kOwn>, kOwn, 0, block_paths);
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
              : n_legs     ? recur(jump_recur_kernel<true, kReturns>, kReturns, first, m)
                           : recur(jump_recur_kernel<false, kReturns>, kReturns, first, m);
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

// The same function past 64 assets: wide.cuh's layout with its GbmWide model
// and the jump clock (kJump); at lam = 0 its output is mcport_multi_dd_wide's
// rebalanced one bit for bit. The arguments of mcport_merton_multi_dd, plus
// scratch (WIDE_CTAS·tp·A floats on the device), tp paths per tile and n_ctas
// persistent CTAs; the hedge is read from device memory. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for arguments
// the layout does not take.
int mcport_merton_multi_dd_wide(long long seed, long long first_block, int n_blocks,
                                int block_paths, int n_assets, int n_cand, int n_steps,
                                int n_legs, float lam, const void* params, const void* weights,
                                const void* hedge, void* term, void* dd, void* scratch, int tp,
                                int n_ctas, void* stream) {
  if (n_cand < 1 || n_cand > kMaxCand || n_legs < 0 || (n_legs > 0 && hedge == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  WideArgs g{seed, first_block, n_blocks, block_paths, n_assets, n_cand, n_steps, tp,
             static_cast<const float*>(weights), static_cast<float*>(scratch),
             static_cast<float*>(term), static_cast<float*>(dd), nullptr};
  const float* q = static_cast<const float*>(params);  // L (A·A), then m, muJ, sigJ
  const long long a2 = static_cast<long long>(n_assets) * n_assets;
  auto run = [&](auto model) {
    model.chol = q;
    model.mean = q + a2;
    model.muj = q + a2 + n_assets;
    model.sigj = q + a2 + 2 * n_assets;
    model.hedge = static_cast<const float*>(hedge);
    model.n_legs = n_legs;
    model.df = model.neg2_over_df = 0.0f;
    model.lam = lam;
    return wide_launch(g, model, n_ctas, static_cast<cudaStream_t>(stream));
  };
  return n_legs ? run(GbmWide<kPoly, kWideHedged, kWideF32, true>{})
                : run(GbmWide<kPoly, kWideGross, kWideF32, true>{});
}

}  // extern "C"
