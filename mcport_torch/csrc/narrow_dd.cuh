// The candidate kernels' layouts up to 16 assets (jump.cu's kernel #8,
// heston.cu's #10, garch.cu's #5, bootstrap.cu's #7, gbm_narrow.cu's #3):
// what they share.
//
// No TPU kernel of its own: the pieces that jump.cu, heston.cu, garch.cu and
// bootstrap.cu assemble into their redesigned candidate kernels (ops/jump.py
// merton_narrow_plan, ops/heston.py heston_narrow_plan, ops/garch.py
// garch_narrow_plan and ops/bootstrap.py bootstrap_narrow_plan pick a layout
// by W, where each measured the fastest on an H100):
// - kSolo, few candidates (the path-risk engine's W = 1): a thread per path
//   runs the recursion and scores its own candidates from the step's returns
//   in registers, their values, peaks and drawdowns in shared memory; one
//   launch, no barrier (64 threads a block; the bootstrap's light recursion
//   128);
// - kSplit: the same recursion (kReturns) writes every step's returns to a
//   device scratch the wrapper allocates (tile-major: 16 paths of a step and
//   asset contiguous), then score_kernel below scores them, each thread 4
//   candidates x 4 paths, its block as many paths as ceil(W/4) candidate
//   groups leave of 256 threads;
// - kTile: a block owns a 16-path tile and every candidate (heston.cu past
//   128 candidates: each (asset, path) item writes one Philox call's four
//   steps of returns to shared memory, the scorers then run those four
//   steps, and the block's phases are pipelined with double buffers so that
//   one barrier per Philox call separates them; bootstrap.cu, by name
//   only: its kernel of 17-64 assets, two barriers per step).
// The score is one FP32 fmaf per asset, ascending from 0.0f (mcport's
// score_dot is float32), then the value update (ValueUpdate): V *= W·g for
// the gross returns g = exp(x) of #8 and #10 (kGross), V *= 1 + W·r for the
// simple returns of #5 and #7 (kSimple), and V *= 1 + W·r_h hedged (every
// family: kSimpleNan, a NaN of overflowed wealth carried), then the running
// peak and the drawdown: the 17-64-asset kernels' operations in their order,
// so every layout's output is theirs bit for bit. Hedged, the legs settle with hedged.cuh's
// operations in its order, but branch-free (the leg type picks its numerator
// by selects), so items of different assets in one warp do not diverge, and
// a thread that owns a path settles leg by leg across its assets.

#pragma once

#include "gbm_draws.cuh"
#include "hedged.cuh"

namespace {

constexpr int kNA = 16;             // the redesigned layouts' widest universe
constexpr int kSoloThreads = 64;    // paths (and threads) per recursion block
constexpr int kScoreThreads = 256;  // threads of a scoring block
constexpr int kTile = 16;           // paths of a tile (the scratch's, the tile layout's)
constexpr int kStageFloats = 8192;  // returns a scoring block stages at once
enum NarrowLayout { kSolo = 0, kSplit = 1, kTileLayout = 2 };

// The recursion kernel's two parts: scoring its own candidates, or writing
// its returns to the scratch.
enum RecurMode { kOwn = 0, kReturns = 1 };

// A candidate's value update from its step's score f: V *= f on gross returns
// (kGross), V *= 1 + f on simple ones (kSimple), V *= 1 + f with a NaN of
// overflowed wealth carried on (kSimpleNan, the hedged modes), and V = f, the
// score of the state itself (kLevel: GBM buy-and-hold, f = W·exp(logS)).
enum ValueUpdate { kGross = 0, kSimple = 1, kSimpleNan = 2, kLevel = 3 };

// The scoring block's groups of 4 paths at W candidates: the most, a power of
// two from 4, that ceil(W/4) groups of candidates leave of its 256 threads
// (4 at W = 256, 16 paths; 128 at W = 5-8, 512 paths).
__host__ __device__ constexpr int score_groups(int n_cand) {
  int pg = 4;
  while (pg * 2 * ((n_cand + 3) / 4) <= kScoreThreads) pg *= 2;
  return pg;
}

// Steps of returns a scoring block stages in shared memory at once: what
// kStageFloats hold of its paths, 1 to 16.
__host__ __device__ constexpr int score_steps(int n, int n_cand) {
  const int k = kStageFloats / (n * 4 * score_groups(n_cand));
  return k < 1 ? 1 : k > 16 ? 16 : k;
}

__host__ __device__ constexpr int round4n(int n) { return (n + 3) & ~3; }

// The scoring block's shared memory, in floats: the weights (A, w_pad), then
// the staged returns (steps, A, paths).
__host__ __device__ constexpr int score_floats(int n, int n_cand) {
  return n * round4n(n_cand) + score_steps(n, n_cand) * n * 4 * score_groups(n_cand);
}

// Leg l's numerator over the move p_prev -> p_new (up = p_new - p_prev):
// hedged.cuh's switch as selects.
__device__ __forceinline__ float leg_numer(const HedgeBlock& h, int l, float up, float p_new) {
  const float k = h.strike[l], prem = h.premium[l];
  const float call_iv = fmaxf(__fsub_rn(p_new, k), 0.0f);
  const float put_iv = fmaxf(__fsub_rn(k, p_new), 0.0f);
  const int ty = static_cast<int>(h.type[l]);
  return ty == 0              ? up
         : ty == 1 || ty == 6 ? -up
         : ty == 2            ? __fsub_rn(call_iv, prem)
         : ty == 3            ? __fsub_rn(prem, call_iv)
         : ty == 4            ? __fsub_rn(put_iv, prem)
         : ty == 5            ? __fsub_rn(prem, put_iv)
                              : 0.0f;
}

// The settled sum r over the price p_prev, correctly rounded: where r is 0
// and p_prev > 0 the quotient is r itself (its signed zero), taken without
// the division (the assets without legs of a hedge settle to 0 every step).
__device__ __forceinline__ float settled(float r, float p_prev) {
  if (r == 0.0f && p_prev > 0.0f) return r;
  return __fdiv_rn(r, p_prev);
}

// The settled return of asset a over the move p_prev -> p_new: hedged.cuh's
// hedged_return, every operation the same in the same order, with the leg
// type's numerator picked by selects instead of a switch.
__device__ __forceinline__ float settle(const HedgeBlock& h, int a, float p_prev, float p_new) {
  const float up = __fsub_rn(p_new, p_prev);
  float r = 0.0f;
  for (int l = a * h.n_legs; l < (a + 1) * h.n_legs; ++l) {
    r = __fadd_rn(r, __fmul_rn(h.qty[l], leg_numer(h, l, up, p_new)));
  }
  return settled(r, p_prev);
}

// Every asset's settled return at once, for a thread that owns a path: the
// prices s_p[i * kS] move to e[i], then e[i] becomes asset i's settled
// return — settle's operations for each asset in its order, taken leg by leg
// across the assets so that the assets' settlements interleave.
template <int kS>
__device__ __forceinline__ void settle_all(const HedgeBlock& h, int n, float* s_p,
                                           float (&e)[kNA]) {
  float acc[kNA];
#pragma unroll
  for (int i = 0; i < kNA; ++i) acc[i] = 0.0f;
  for (int l = 0; l < h.n_legs; ++l) {
#pragma unroll
    for (int i = 0; i < kNA; ++i) {
      if (i < n) {
        const int at = i * h.n_legs + l;
        const float up = __fsub_rn(e[i], s_p[i * kS]);
        acc[i] = __fadd_rn(acc[i], __fmul_rn(h.qty[at], leg_numer(h, at, up, e[i])));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kNA; ++i) {
    if (i < n) {
      const float price = s_p[i * kS];
      s_p[i * kS] = e[i];
      e[i] = settled(acc[i], price);
    }
  }
}

// One (candidate, path)'s wealth after a step whose score is f (ValueUpdate
// kUpd), then its running peak and drawdown.
template <int kUpd>
__device__ __forceinline__ void value_update(float f, float& v, float& peak, float& dd) {
  if (kUpd == kSimpleNan) {  // hedged: wealth may overflow, NaN carries on (hedged.cuh)
    v = v * (1.0f + f);
    peak = max_nan(peak, v);
    dd = min_nan(dd, v / peak - 1.0f);
  } else {
    v = kUpd == kSimple ? v * (1.0f + f) : kUpd == kLevel ? f : v * f;
    peak = fmaxf(peak, v);
    dd = fminf(dd, v / peak - 1.0f);
  }
}

// The solo part's candidates: the values, peaks and drawdowns of candidate c
// at s_st[(3c + 0/1/2) * kS] (this thread's slice of a kS-thread block),
// weights (W, kNA) at s_w; the step's returns e[] of n assets.
template <int kUpd, int kS = kSoloThreads>
__device__ __forceinline__ void solo_score(int n, int n_cand, const float* s_w, float* s_st,
                                           const float (&e)[kNA]) {
  for (int c = 0; c < n_cand; ++c) {
    const float* wc = s_w + c * kNA;
    float f = 0.0f;
#pragma unroll
    for (int a = 0; a < kNA; ++a) {
      if (a < n) f = fmaf(wc[a], e[a], f);
    }
    float* st = s_st + 3 * c * kS;
    float v = st[0], peak = st[kS], dd = st[2 * kS];
    value_update<kUpd>(f, v, peak, dd);
    st[0] = v;
    st[kS] = peak;
    st[2 * kS] = dd;
  }
}

// The solo part's start and end: V = peak = 1, dd = 0; out V_T - 1 and dd.
template <int kS = kSoloThreads>
__device__ __forceinline__ void solo_start(int n_cand, float* s_st) {
  for (int c = 0; c < n_cand; ++c) {
    s_st[3 * c * kS] = 1.0f;
    s_st[(3 * c + 1) * kS] = 1.0f;
    s_st[(3 * c + 2) * kS] = 0.0f;
  }
}

template <int kS = kSoloThreads>
__device__ __forceinline__ void solo_store(int n_cand, int blk, int block_paths, int p,
                                           const float* s_st, float* term, float* max_dd) {
  for (int c = 0; c < n_cand; ++c) {
    const long long o = (static_cast<long long>(blk) * n_cand + c) * block_paths + p;
    term[o] = s_st[3 * c * kS] - 1.0f;
    max_dd[o] = s_st[(3 * c + 2) * kS];
  }
}

// Where the kReturns part writes chunk path cp's returns: step s of asset a at
// [(s · A + a) · 16] from the returned pointer, its tile's returns contiguous
// (rets[(((blk · tiles + t) · n_steps + s) · A + a) · 16 + l], cp = 16·t + l).
__device__ __forceinline__ float* returns_slot(float* rets, int blk, int chunk, int cp,
                                               int n_steps, int n) {
  const long long tiles = (chunk + kTile - 1) / kTile;
  return rets + ((blk * tiles + cp / kTile) * n_steps) * n * kTile + cp % kTile;
}

// A scorer's step: thread (cw, pq) updates candidates 4·cw .. +3 of paths
// 4·pq .. +3 with the step's returns s_e (A rows of `stride` paths) and the
// weights s_w (A, w_pad).
template <int kUpd>
__device__ __forceinline__ void tile_score(int n, int w_pad, int cw, int pq, const float* s_w,
                                           const float* s_e, int stride, float (&v)[4][4],
                                           float (&peak)[4][4], float (&dd)[4][4]) {
  float f[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) f[i][j] = 0.0f;
  }
  for (int a = 0; a < n; ++a) {
    const float4 w4 = *reinterpret_cast<const float4*>(s_w + a * w_pad + 4 * cw);
    const float4 e4 = *reinterpret_cast<const float4*>(s_e + a * stride + 4 * pq);
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
    for (int j = 0; j < 4; ++j) value_update<kUpd>(f[i][j], v[i][j], peak[i][j], dd[i][j]);
  }
}

// The split layout's scoring launch: the returns of chunk paths 0 .. chunk-1
// of every dispatch block (written by a kReturns launch) scored for W
// candidates, weights (W, A); outputs at paths first_path + cp of each
// block's rows. Thread tid holds candidates 4·cw .. +3 of the block's paths
// 4·pq .. +3, their values, peaks and drawdowns in registers; the block's
// returns are staged in shared memory score_steps steps at a time; kUpd the
// family's value update (ValueUpdate).
template <int kUpd>
__global__ void __launch_bounds__(kScoreThreads, 2)
score_kernel(int block_paths, int first_path, int chunk, int n, int n_cand, int n_steps,
             const float* __restrict__ weights, const float* __restrict__ rets,
             float* __restrict__ term, float* __restrict__ max_dd) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, blk = blockIdx.y, w_pad = round4n(n_cand);
  float* s_w = smem;
  float* s_r = smem + n * w_pad;  // (ks, A, bp)
  for (int i = tid; i < n * w_pad; i += kScoreThreads) {
    const int a = i / w_pad, c = i % w_pad;
    s_w[i] = c < n_cand ? weights[c * n + a] : 0.0f;
  }
  const int pg = score_groups(n_cand), bp = 4 * pg, ks = score_steps(n, n_cand);
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
      *reinterpret_cast<float4*>(s_r + (k * n + a) * bp + tl * kTile + 4 * l4) = x;
    }
    __syncthreads();
    if (scorer) {
      for (int k = 0; k < nk; ++k) {
        tile_score<kUpd>(n, w_pad, cw, pq, s_w, s_r + k * n * bp, bp, v, peak, dd);
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
}

// The tile layout's outputs: thread (cw, pq)'s candidates and paths of the
// tile at p0.
__device__ __forceinline__ void tile_store(int n_cand, int blk, int block_paths, int p0, int cw,
                                           int pq, const float (&v)[4][4], const float (&dd)[4][4],
                                           float* term, float* max_dd) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = 4 * cw + i;
    if (c >= n_cand) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = p0 + 4 * pq + j;
      if (p >= block_paths) continue;
      const long long o = (static_cast<long long>(blk) * n_cand + c) * block_paths + p;
      term[o] = v[i][j] - 1.0f;
      max_dd[o] = dd[i][j];
    }
  }
}

}  // namespace
