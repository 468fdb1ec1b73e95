// The layout of every kernel for universes past 64 assets: one mechanism,
// shared by all kernel files.
//
// The kernels' 1..64-asset layouts keep a path's per-asset state in registers
// (or a thread's local memory) and L, the weights and the shocks in shared
// memory: at A = 200, L alone is 160 KB and the weights of 256 candidates 200
// KB, past a block's 227 KB. Past 64 assets (kMaxAssets) every kernel runs the
// layout below instead; the narrow code is not touched.
//
// The layout. A CTA of 256 threads owns a tile of tp <= 16 paths of one
// dispatch block (tp: as many as keep one Philox call's shocks, 4·A·tp
// floats, within about 100 KB of shared memory; the wrapper picks it,
// ops/gbm.py wide_tile) and walks the assets in chunks of 64: chunk item li =
// tid + r·256 (r < 4) is asset a0 + li/16, tile path li%16 — the 17-64-asset
// tile code's mapping with kCap = 64, one chunk after the other. The same
// thread owns the same (asset, path) item at every step, so an item's state
// needs no barrier. That state — the GBM log sums or prices, GARCH's sigma2
// and gross, Heston's variance and variance shocks, the hedged prices — lives
// in a device-memory scratch the wrapper allocates per launch, laid out
// (state, asset, CTA, tile path) so that a warp's 32 items (two assets x 16
// paths) read two 64-byte segments. The CTAs are persistent (the wrapper
// launches WIDE_CTAS of them, each walking tiles gridDim.x apart), so the
// scratch is WIDE_CTAS·tp·A floats per state, whatever the path count. L (A²
// floats) and the candidate weights (W x A) stay in device memory, read with
// __ldg: both stay resident in the 50 MB L2. Per step, chunk by chunk, each
// item writes its return into a (64, 16) shared tile and each thread adds the
// chunk to the 4-candidate x 4-path micro-tile of scores it holds in
// registers (multi_dd.cu's scoring, in ascending asset order as the plain
// forms sum); after the last chunk it updates its values, peaks and
// drawdowns. Two barriers per chunk and step, one per Philox call.
//
// A model (a struct in each kernel file) supplies the arithmetic: its state
// count kState, steps per Philox call kPer, value mode kValue and score tier
// kScore, and
//   smem_floats(a, tp)            its shared memory (the shocks, ...);
//   begin(t, s, tid)              once per tile, before anything else;
//   start(t, a, p)                an item's initial state;
//   draw(t, s, call, n, a, p)     an item's shocks of one Philox call;
//   draw_path(t, s, call, n, p)   a tile path's (jump clock, row indices), by
//                                 thread p < tp;
//   step(t, s, k, a, p)           advance an item one step, return what the
//                                 candidates score (exp(x), r, r_h, ...);
//   final_e(t, a, p)              buy-and-hold: the terminal state's score;
//   out(t, a, p)                  the per-asset terminal output.
// The order of operations inside step is each kernel's own narrow order, so
// the wide kernels meet the same bounds, and the bit-identical ones stay bit
// for bit.
//
// What bounds it on the card. The narrow kernels' work plus, per
// item-step, kState scratch loads and stores (coalesced, L2-resident at these
// sizes) and A·__ldg of L, and W·A weight loads per path-step from L1/L2. A
// simple layout that is right; making it fast is later work (ROADMAP.md).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "gbm_draws.cuh"
#include "hedged.cuh"

namespace {

constexpr int kWideThreads = 256;
constexpr int kWideTile = 16;   // most paths per tile: the micro-tile's width
constexpr int kWideChunk = 64;  // assets per chunk: 64 x 16 items, four per thread

// How a candidate's value takes the step's score f: V = f (buy-and-hold), V *= f
// (gross returns), V *= 1 + f (simple returns), V *= 1 + f carrying NaN (hedged).
enum WideValue { kWideHold = 0, kWideGross = 1, kWideSimple = 2, kWideHedged = 3 };
enum WideScore { kWideF32 = 0, kWideSplit = 1, kWideBf16 = 2 };

__host__ __device__ constexpr int wide_round4(int n) { return (n + 3) & ~3; }

// float -> the nearest bfloat16 (ties to even), as a float (multi_dd.cu's
// bf16_round).
__device__ __forceinline__ float wide_bf16(float x) {
  uint32_t u = __float_as_uint(x);
  u += 0x7FFFu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xFFFF0000u);
}

// The launch's arguments.
struct WideArgs {
  long long seed, first_block;
  int n_blocks, block_paths, n_assets, n_cand, n_steps, tp;
  const float* weights;  // (n_cand, A), or null without candidates
  float* scratch;        // (kState, A, gridDim.x, tp)
  float* term;           // candidates: (n_blocks, n_cand, block_paths)
  float* dd;             // candidates: (n_blocks, n_cand, block_paths)
  float* out;            // per-asset terminal output (n_blocks, block_paths, A), or null
};

// One CTA's tile: its dispatch block, first path, Philox key and scratch.
struct WideTile {
  int b, p0, tp, a_n;
  uint32_t key;
  float* scratch;       // this CTA's slots: + (s·A + a)·stride + p
  long long stride;     // gridDim.x · tp
  __device__ float& at(int s, int a, int p) const {
    return scratch[(static_cast<long long>(s) * a_n + a) * stride + p];
  }
};

// Draws one GBM-stream Philox call of item (a, p) into the shock tile s_z
// (kPer, A, tp): gbm_draws.cuh's call_draws, consumed as every kernel does.
template <int kTier, uint32_t kStream = kStreamGbm>
__device__ __forceinline__ void wide_draw(const WideTile& t, float* s_z, int call, int n, int a,
                                          int p, float df, float neg2_over_df, float za[4]) {
  call_draws<kTier, kStream>(call, a, t.p0 + p, t.key, n, df, neg2_over_df, za);
  constexpr int kPer = steps_per_call<kTier>();
#pragma unroll
  for (int k = 0; k < kPer; ++k) s_z[(k * t.a_n + a) * t.tp + p] = za[k];
}

// (L z)_a of step k for tile path p, FMAs in ascending j over j < n_j (A for
// a full row, a + 1 for a lower triangle), L read from device memory.
__device__ __forceinline__ float wide_correlate(const float* __restrict__ chol, const float* s_z,
                                                const WideTile& t, int k, int a, int p, int n_j) {
  const float* row = chol + static_cast<long long>(a) * t.a_n;
  const float* z = s_z + k * t.a_n * t.tp + p;
  float y = 0.0f;
  for (int j = 0; j < n_j; ++j) y = fmaf(__ldg(row + j), z[j * t.tp], y);
  return y;
}

// Adds chunk a0 .. a0+na-1 of the step's returns to this thread's micro-tile
// of scores: candidates 4·cw .. +3, tile paths 4·pq .. +3, in the tier's
// numerics (multi_dd.cu's products, in its order).
template <int kScore>
__device__ __forceinline__ void wide_score(float f[4][4], const float* __restrict__ w, int a_n,
                                           int n_cand, int a0, int na, const float* s_e1,
                                           const float* s_e2, int cw, int pq) {
  for (int i = 0; i < na; ++i) {
    float wv[4], wl[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int cand = 4 * cw + c;
      const float x = cand < n_cand ? __ldg(w + static_cast<long long>(cand) * a_n + a0 + i)
                                    : 0.0f;
      wv[c] = kScore == kWideF32 ? x : wide_bf16(x);
      wl[c] = kScore == kWideSplit ? wide_bf16(x - wv[c]) : 0.0f;
    }
    const float4 e1 = *reinterpret_cast<const float4*>(s_e1 + i * kWideTile + 4 * pq);
    const float ev[4] = {e1.x, e1.y, e1.z, e1.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int j = 0; j < 4; ++j) f[c][j] = fmaf(wv[c], ev[j], f[c][j]);
    }
    if (kScore == kWideSplit) {
      const float4 e2 = *reinterpret_cast<const float4*>(s_e2 + i * kWideTile + 4 * pq);
      const float el[4] = {e2.x, e2.y, e2.z, e2.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          f[c][j] = fmaf(wv[c], el[j], f[c][j]);
          f[c][j] = fmaf(wl[c], ev[j], f[c][j]);
        }
      }
    }
  }
}

// One step of a candidate's value, peak and drawdown (the narrow kernels'
// update for each value mode; hedged wealth carries a NaN, hedged.cuh).
template <int kValue>
__device__ __forceinline__ void wide_update(float f, float* v, float* peak, float* dd) {
  *v = kValue == kWideHold     ? f
       : kValue == kWideGross  ? *v * f
                               : *v * (1.0f + f);
  if (kValue == kWideHedged) {
    *peak = max_nan(*peak, *v);
    *dd = min_nan(*dd, *v / *peak - 1.0f);
  } else {
    *peak = fmaxf(*peak, *v);
    *dd = fminf(*dd, *v / *peak - 1.0f);
  }
}

// Calls fn(a, p) for each (asset, path) item this thread owns: chunk item li
// = tid + r·256 is asset a0 + li/16, tile path li%16.
template <typename Fn>
__device__ __forceinline__ void wide_items(int a_n, int tp, int a0, Fn fn) {
#pragma unroll
  for (int r = 0; r < kWideChunk * kWideTile / kWideThreads; ++r) {
    const int li = threadIdx.x + r * kWideThreads;
    const int a = a0 + li / kWideTile, p = li % kWideTile;
    if (a < a_n && p < tp) fn(a, p);
  }
}

template <typename Fn>
__device__ __forceinline__ void wide_all_items(int a_n, int tp, Fn fn) {
  for (int a0 = 0; a0 < a_n; a0 += kWideChunk) wide_items(a_n, tp, a0, fn);
}

// The wide kernel of model M: candidates when n_cand > 0 (their term and dd),
// per-asset terminal outputs when out is set; both for the path-stats kernel.
template <class M>
__global__ void __launch_bounds__(kWideThreads)
wide_kernel(WideArgs g, M m) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, a_n = g.n_assets, tp = g.tp;
  float* s_m = smem;  // the model's
  float* s_e1 = smem + wide_round4(M::smem_floats(a_n, tp));  // (64, 16) a chunk's returns
  float* s_e2 = s_e1 + kWideChunk * kWideTile;                // the split tier's low parts
  const bool score = g.n_cand > 0;
  const int cw = tid / 4, pq = tid % 4;
  const bool scorer = score && 4 * cw < g.n_cand;
  const int tiles = (g.block_paths + tp - 1) / tp;
  const long long n_tiles = static_cast<long long>(tiles) * g.n_blocks;

  for (long long ti = blockIdx.x; ti < n_tiles; ti += gridDim.x) {
    WideTile t;
    t.b = static_cast<int>(ti / tiles);
    t.p0 = static_cast<int>(ti % tiles) * tp;
    t.tp = tp;
    t.a_n = a_n;
    t.key = block_key(g.seed, g.first_block, t.b);
    t.stride = static_cast<long long>(gridDim.x) * tp;
    t.scratch = g.scratch + static_cast<long long>(blockIdx.x) * tp;

    __syncthreads();  // the last tile's reads of shared memory are done
    m.begin(t, s_m, tid);
    wide_all_items(a_n, tp, [&](int a, int p) { m.start(t, a, p); });
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

    for (int s0 = 0; s0 < g.n_steps; s0 += M::kPer) {
      const int n = min(M::kPer, g.n_steps - s0);
      const int call = s0 / M::kPer;
      wide_all_items(a_n, tp, [&](int a, int p) { m.draw(t, s_m, call, n, a, p); });
      if (tid < tp) m.draw_path(t, s_m, call, n, tid);
      __syncthreads();

      for (int k = 0; k < n; ++k) {
        if (!score) {
          wide_all_items(a_n, tp, [&](int a, int p) { m.step(t, s_m, k, a, p); });
          continue;
        }
        float f[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) f[i][j] = 0.0f;
        }
        for (int a0 = 0; a0 < a_n; a0 += kWideChunk) {
#pragma unroll
          for (int r = 0; r < kWideChunk * kWideTile / kWideThreads; ++r) {
            const int li = tid + r * kWideThreads;
            const int a = a0 + li / kWideTile, p = li % kWideTile;
            const float e = (a < a_n && p < tp) ? m.step(t, s_m, k, a, p) : 0.0f;
            if (M::kScore == kWideF32) {
              s_e1[li] = e;
            } else {
              const float hi = wide_bf16(e);
              s_e1[li] = hi;
              if (M::kScore == kWideSplit) s_e2[li] = wide_bf16(e - hi);
            }
          }
          __syncthreads();
          if (scorer) {
            wide_score<M::kScore>(f, g.weights, a_n, g.n_cand, a0, min(kWideChunk, a_n - a0),
                                  s_e1, s_e2, cw, pq);
          }
          __syncthreads();
        }
        if (scorer) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j) wide_update<M::kValue>(f[i][j], &v[i][j], &peak[i][j],
                                                               &dd[i][j]);
          }
        }
      }
      __syncthreads();  // the next call's draws overwrite the model's shared memory
    }

    if (M::kValue == kWideHold && score) {
      // the terminal return is the FP32 score of the terminal state in every
      // tier (Σ w when n_steps == 0), as multi_dd.cu's
      float f[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) f[i][j] = 0.0f;
      }
      for (int a0 = 0; a0 < a_n; a0 += kWideChunk) {
        wide_items(a_n, tp, a0, [&](int a, int p) {
          s_e1[(a - a0) * kWideTile + p] = m.final_e(t, a, p);
        });
        __syncthreads();
        if (scorer) {
          wide_score<kWideF32>(f, g.weights, a_n, g.n_cand, a0, min(kWideChunk, a_n - a0),
                               s_e1, s_e1, cw, pq);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) v[i][j] = f[i][j];
      }
    }

    if (scorer) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int w = 4 * cw + i;
        if (w >= g.n_cand) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int tpath = 4 * pq + j, p = t.p0 + tpath;
          if (tpath >= tp || p >= g.block_paths) continue;
          const long long o = (static_cast<long long>(t.b) * g.n_cand + w) * g.block_paths + p;
          g.term[o] = v[i][j] - 1.0f;
          g.dd[o] = dd[i][j];
        }
      }
    }
    if (g.out != nullptr) {
      wide_all_items(a_n, tp, [&](int a, int p) {
        if (t.p0 + p < g.block_paths) {
          g.out[(static_cast<long long>(t.b) * g.block_paths + t.p0 + p) * a_n + a] =
              m.out(t, a, p);
        }
      });
    }
  }
}

// Shared memory of a wide launch of model M, in bytes.
template <class M>
size_t wide_smem(int a_n, int tp) {
  return sizeof(float) * (wide_round4(M::smem_floats(a_n, tp)) + 2 * kWideChunk * kWideTile);
}

// Checks a wide launch's arguments and launches it: WIDE_CTAS persistent CTAs
// (n_ctas, the scratch's third axis). Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for what the layout does not take.
template <class M>
int wide_launch(const WideArgs& g, const M& m, int n_ctas, cudaStream_t stream) {
  const bool tp_ok = g.tp == 1 || g.tp == 2 || g.tp == 4 || g.tp == 8 || g.tp == 16;
  if (g.n_assets < 1 || g.n_cand < 0 || g.n_cand > 4 * (kWideThreads / 4) || g.n_blocks < 1 ||
      g.block_paths < 1 || g.n_steps < 0 || !tp_ok || n_ctas < 1 || n_ctas > 65535 ||
      g.scratch == nullptr || (g.n_cand > 0 && (g.weights == nullptr || g.term == nullptr ||
                                                g.dd == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = wide_smem<M>(g.n_assets, g.tp);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = wide_kernel<M>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_ctas, kWideThreads, smem, stream>>>(g, m);
  return static_cast<int>(cudaGetLastError());
}

// The default hooks of a model: no per-tile or per-path work, no buy-and-hold
// or per-asset output, the float32 score.
struct WideModelBase {
  static constexpr int kScore = kWideF32;
  __device__ void begin(const WideTile&, float*, int) const {}
  __device__ void draw_path(const WideTile&, float*, int, int, int) const {}
  __device__ float final_e(const WideTile&, int, int) const { return 0.0f; }
  __device__ float out(const WideTile&, int, int) const { return 0.0f; }
};

// The correlated-GBM model of kernels #2, #3 and #8 (path_stats.cu,
// multi_dd.cu, jump.cu): x = m + L z over the full row of L, plus, with
// kJump, the step's common jump muJ + sigJ·jn where its uniform is below lam
// (jump.cu's clock: Philox calls 2·call and 2·call + 1 of each path on
// STREAM_JUMP, words 0 and 1 the events, 2 and 3 one Box-Muller pair); the
// state is logS, or the price P from s0 when hedged; the step scores exp(logS)
// (buy-and-hold), exp(x) (rebalanced) or r_h(P, P·exp(x)) (hedged), each as
// the narrow kernels compute it. At lam = 0 no step jumps and kernel #8's
// wide output is kernel #3's rebalanced one bit for bit.
template <int kTier, int kValue_, int kScore_, bool kJump>
struct GbmWide : WideModelBase {
  static constexpr int kState = 1;
  static constexpr int kPer = steps_per_call<kTier>();
  static constexpr int kValue = kValue_;
  static constexpr int kScore = kScore_;
  const float *chol, *mean, *muj, *sigj, *hedge;  // L (A, A), m, muJ, sigJ (A); the hedge block
  int n_legs;
  float df, neg2_over_df, lam;

  __host__ __device__ static int smem_floats(int a, int tp) {
    return kPer * a * tp + (kJump ? 2 * 4 * kWideTile : 0);  // shocks; events, jump normals
  }
  __device__ void start(const WideTile& t, int a, int p) const {
    t.at(0, a, p) = kValue == kWideHedged ? __ldg(hedge + a) : 0.0f;
  }
  __device__ void draw(const WideTile& t, float* s, int call, int n, int a, int p) const {
    float za[4];
    wide_draw<kTier>(t, s, call, n, a, p, df, neg2_over_df, za);
  }
  __device__ void draw_path(const WideTile& t, float* s, int call, int, int p) const {
    if (!kJump) return;
    float* s_ev = s + kPer * t.a_n * t.tp;  // (4, 16): 1 on a jump step
    float* s_jn = s_ev + 4 * kWideTile;     // (4, 16): the steps' common jump normals
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const Words wd = philox4x32_10(static_cast<uint32_t>(2 * call + half), 0u,
                                     static_cast<uint32_t>(t.p0 + p), kStreamJump, t.key, 0u);
      float j1, j2;
      boxmuller<false>(bits_to_unit(wd.w2), bits_to_unit(wd.w3), &j1, &j2);
      const int k = 2 * half;
      s_ev[k * kWideTile + p] = bits_to_unit(wd.w0) < lam ? 1.0f : 0.0f;
      s_ev[(k + 1) * kWideTile + p] = bits_to_unit(wd.w1) < lam ? 1.0f : 0.0f;
      s_jn[k * kWideTile + p] = j1;
      s_jn[(k + 1) * kWideTile + p] = j2;
    }
  }
  __device__ float step(const WideTile& t, float* s, int k, int a, int p) const {
    float x = __ldg(mean + a) + wide_correlate(chol, s, t, k, a, p, t.a_n);
    if (kJump) {
      const float* s_ev = s + kPer * t.a_n * t.tp;
      if (s_ev[k * kWideTile + p] != 0.0f) {
        const float jn = s_ev[4 * kWideTile + k * kWideTile + p];
        x = __fadd_rn(x, __fadd_rn(__ldg(muj + a), __fmul_rn(__ldg(sigj + a), jn)));
      }
    }
    float& st = t.at(0, a, p);
    if (kValue == kWideHedged) {  // the settled return of the move P -> P·exp(x)
      const float p_new = st * expf(x);
      const float e = hedged_return(HedgeBlock(hedge, t.a_n, n_legs), a, st, p_new);
      st = p_new;
      return e;
    }
    st += x;
    return expf(kValue == kWideHold ? st : x);
  }
  __device__ float final_e(const WideTile& t, int a, int p) const { return expf(t.at(0, a, p)); }
  __device__ float out(const WideTile& t, int a, int p) const { return t.at(0, a, p); }
};

}  // namespace
