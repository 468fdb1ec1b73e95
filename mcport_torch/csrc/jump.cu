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
// nothing is read per step and 8·W bytes per path are stored once. The design
// is kernel #3's: a block owns a tile of 16 paths and all candidates; per
// Philox call (four steps) its threads draw the (asset, path) shocks into
// shared memory, and 32 threads draw the tile's two jump calls per path (the
// four steps' events and normals); per step each (asset, path) item
// correlates, adds its jump and writes exp(x) to shared memory; then each
// thread updates a 4-candidate x 4-path micro-tile whose values, peaks and
// drawdowns stay in registers. A dispatch group of blocks is one launch
// (gridDim.y).
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

}  // namespace

extern "C" {

// Launches the kernel on `stream` for blocks first_block+1 .. first_block+n_blocks.
// params: ops/jump.py's block — L (n_assets, n_assets) row-major, then the
// per-step mean, jump mean and jump vol (n_assets each); weights: (n_cand,
// n_assets); float32 on the device. lam: the per-step jump probability as a
// float32. hedge: ops/hedged.py HedgeTensors.packed for n_legs legs per
// asset, or null (n_legs 0) for the unhedged mode. Outputs term and dd:
// (n_blocks, n_cand, block_paths) float32. Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for arguments the kernel does not take
// (among them a hedge too large for a block's shared memory).
int mcport_merton_multi_dd(long long seed, long long first_block, int n_blocks,
                           int block_paths, int n_assets, int n_cand, int n_steps, int n_legs,
                           float lam, const void* params, const void* weights,
                           const void* hedge, void* term, void* dd, void* stream) {
  if (n_assets < 1 || n_assets > kMaxAssets || n_cand < 1 || n_cand > kMaxCand ||
      n_blocks < 1 || n_blocks > 65535 || block_paths < 1 || n_steps < 0 || n_legs < 0 ||
      (n_legs > 0 && hedge == nullptr) || kMaxAssets * kTileP > kItems * kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((block_paths + kTileP - 1) / kTileP, n_blocks);
  const size_t smem = sizeof(float) * Layout(n_assets, round4(n_cand), n_legs).total;
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  auto run = [&](auto kernel) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        seed, first_block, block_paths, n_assets, n_cand, n_steps, n_legs, lam,
        static_cast<const float*>(params), static_cast<const float*>(weights),
        static_cast<const float*>(hedge), static_cast<float*>(term), static_cast<float*>(dd));
    return static_cast<int>(cudaGetLastError());
  };
  return n_legs ? run(jump_dd_kernel<true>) : run(jump_dd_kernel<false>);
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
