// The GBM shock stream shared by the port's kernels: Philox4x32-10 bits and
// mcport's polynomial normal and Student-t draws.
//
// Every kernel that draws GBM shocks includes this header, so that
// terminal_noise.cu (mcport/ops/pallas_gbm.py::_terminal_noise_kernel),
// path_stats.cu (::_path_stats_kernel) and multi_dd.cu
// (mcport/ops/pallas_multi_dd.py::_multi_dd_kernel) read the same draw for the
// same (block, path, asset, step). The plain torch forms of the same functions
// are in mcport_torch/ops/gbm.py and mcport_torch/rng.py.
//
// Random bits. Philox4x32-10, key (uint32(seed + (first_block + b + 1) *
// SEED_STRIDE), 0) — the int32 block seed of mcport/engine/mc_engine.py — and
// counter (draw, asset, path_in_block, STREAM_GBM). Normal pair i takes words
// (0,1) of draw i/2 when i is even, words (2,3) when odd; t pair i takes draw i
// whole. An odd n_steps adds pair n_steps/2, of which only the first draw
// counts. Bits map to [2^-23, 1] as 1 - (bits >> 9) * 2^-23, exact in float,
// so the kernels and the plain form see bit-identical uniforms. Nothing
// depends on the launch geometry: any sub-range of paths regenerates bit for
// bit.
//
// nvcc contracts a*b+c into FMA where the torch form rounds twice, so the
// kernels and the plain form agree to ulps, not bits. The t tier's ln and exp
// are the exception: see t_draw.
//
// Each .cu file that includes this header is built into a library of its own
// (mcport_torch/_build.py), so the extern "C" function below is defined once
// per library.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxAssets = 64;                // the narrow layouts' bound (ops/gbm.py MAX_ASSETS);
                                              // past it every kernel runs wide.cuh's layout
constexpr long long kSeedStride = 1LL << 14;  // mcport_torch/seeding.py SEED_STRIDE
constexpr uint32_t kStreamGbm = 0;            // mcport_torch/rng.py STREAM_GBM
constexpr uint32_t kStreamBoot = 1;           // mcport_torch/rng.py STREAM_BOOT
constexpr uint32_t kStreamJump = 2;           // mcport_torch/rng.py STREAM_JUMP
constexpr uint32_t kStreamHeston = 3;         // mcport_torch/rng.py STREAM_HESTON

// kPolyStrict is the poly tier with every operation rounded as the torch form
// rounds it (no contraction): bit-identical draws, for kernels whose state
// must follow the plain form bit for bit (heston.cu). The wrappers never pass
// it as a tier code.
enum Tier { kPoly = 0, kPolyFast = 1, kStudentT = 2, kPolyStrict = 3 };

struct Words {
  uint32_t w0, w1, w2, w3;
};

__device__ __forceinline__ Words philox4x32_10(uint32_t c0, uint32_t c1, uint32_t c2,
                                               uint32_t c3, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c0, hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2, hi1 = __umulhi(0xCD9E8D57u, c2);
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return {c0, c1, c2, c3};
}

// Philox key word of block b of a dispatch group starting after first_block.
__device__ __forceinline__ uint32_t block_key(long long seed, long long first_block, int b) {
  return static_cast<uint32_t>(
      static_cast<unsigned long long>(seed + (first_block + b + 1) * kSeedStride));
}

__device__ __forceinline__ float bits_to_unit(uint32_t bits) {
  return 1.0f - __uint2float_rn(bits >> 9) * 0x1p-23f;
}

// Constants are the float32 values of mcport's Python literals, written in hex
// so that the kernels and the torch form use the same bits.

// a*b + c, rounded twice when kStrict (as the torch form computes it) and left
// to the compiler, which fuses it into one FMA, otherwise.
template <bool kStrict>
__device__ __forceinline__ float madd(float a, float b, float c) {
  return kStrict ? __fadd_rn(__fmul_rn(a, b), c) : a * b + c;
}

template <bool kStrict>
__device__ __forceinline__ float mul(float a, float b) {
  return kStrict ? __fmul_rn(a, b) : a * b;
}

// ln(u), u in (0, 1]: exponent extraction, fold at sqrt(2), x·P(x) for ln(1+x).
template <bool kFast, bool kStrict = false>
__device__ __forceinline__ float ln_poly(float u) {
  const uint32_t bits = __float_as_uint(u);
  const int e = static_cast<int>(bits >> 23) - 127;
  float m = __uint_as_float((bits & 0x007FFFFFu) | 0x3F800000u);
  const bool big = m >= 0x1.6a09e6p+0f;  // 1.4142135
  m = big ? 0.5f * m : m;
  const float ef = static_cast<float>(e) + (big ? 1.0f : 0.0f);
  const float x = m - 1.0f;
  float p;
  if (kFast) {  // _LN1P_FAST_COEF
    p = -0x1.22239ep-3f;
    p = madd<kStrict>(p, x, 0x1.bebfeep-3f);
    p = madd<kStrict>(p, x, -0x1.03bb1p-2f);
    p = madd<kStrict>(p, x, 0x1.54bf8p-2f);
    p = madd<kStrict>(p, x, -0x1.ffebdap-2f);
    p = madd<kStrict>(p, x, 0x1.00003p+0f);
  } else {  // _LN1P_COEF
    p = 0x1.1079d2p-4f;
    p = madd<kStrict>(p, x, -0x1.da1f38p-4f);
    p = madd<kStrict>(p, x, 0x1.e6a3cep-4f);
    p = madd<kStrict>(p, x, -0x1.fcc7c8p-4f);
    p = madd<kStrict>(p, x, 0x1.2340c2p-3f);
    p = madd<kStrict>(p, x, -0x1.555776p-3f);
    p = madd<kStrict>(p, x, 0x1.99a49ep-3f);
    p = madd<kStrict>(p, x, -0x1.000018p-2f);
    p = madd<kStrict>(p, x, 0x1.555546p-2f);
    p = madd<kStrict>(p, x, -0x1p-1f);
    p = madd<kStrict>(p, x, 0x1p+0f);
  }
  return madd<kStrict>(p, x, mul<kStrict>(ef, 0x1.62e43p-1f));  // + ef · ln 2
}

// (cos, sin)(2πu), u in [0, 1]: quadrant reduction, polynomials on [-π/4, π/4].
template <bool kFast>
__device__ __forceinline__ void sincos_poly(float u, float* cos_t, float* sin_t) {
  const float t = 4.0f * u;
  float q = floorf(t + 0.5f);
  const float r = (t - q) * 0x1.921fb6p+0f;  // π/2
  const float r2 = r * r;
  float s, c;
  if (kFast) {
    s = r * (0x1.ffffdep-1f + r2 * (-0x1.55438ep-3f + r2 * 0x1.0ba5bep-7f));
    c = 0x1.ffff18p-1f + r2 * (-0x1.ffc202p-2f + r2 * 0x1.4bdfe8p-5f);
  } else {  // Taylor to r^9 / r^8; coefficients 1/n! rounded to float
    s = r * (1.0f + r2 * (-0x1.555556p-3f + r2 * (0x1.111112p-7f +
             r2 * (-0x1.a01a02p-13f + r2 * 0x1.71de3ap-19f))));
    c = 1.0f + r2 * (-0.5f + r2 * (0x1.555556p-5f + r2 * (-0x1.6c16c2p-10f +
             r2 * 0x1.a01a02p-16f)));
  }
  q = (q == 4.0f) ? 0.0f : q;
  if (q == 1.0f) {
    *cos_t = -s;
    *sin_t = c;
  } else if (q == 2.0f) {
    *cos_t = -c;
    *sin_t = -s;
  } else if (q == 3.0f) {
    *cos_t = s;
    *sin_t = -c;
  } else {
    *cos_t = c;
    *sin_t = s;
  }
}

// exp(x) = 2^k · P(f), k = round-half-even(x log2 e) clamped to [-126, 127].
template <bool kStrict>
__device__ __forceinline__ float exp_poly(float x) {
  const float t = mul<kStrict>(x, 0x1.715476p+0f);  // log2 e
  float k = rintf(t);
  const float f = t - k;
  k = fminf(fmaxf(k, -126.0f), 127.0f);
  const float scale = __int_as_float((static_cast<int>(k) + 127) << 23);
  float p = 0x1.4454c6p-13f;  // _EXP2_COEF
  p = madd<kStrict>(p, f, 0x1.5f2638p-10f);
  p = madd<kStrict>(p, f, 0x1.3b29f8p-7f);
  p = madd<kStrict>(p, f, 0x1.c6af14p-5f);
  p = madd<kStrict>(p, f, 0x1.ebfbep-3f);
  p = madd<kStrict>(p, f, 0x1.62e43p-1f);
  p = madd<kStrict>(p, f, 0x1p+0f);
  return mul<kStrict>(p, scale);
}

template <bool kFast>
__device__ __forceinline__ void boxmuller(float u1, float u2, float* z1, float* z2) {
  const float r = sqrtf(-2.0f * ln_poly<kFast>(u1));
  float c, s;
  sincos_poly<kFast>(u2, &c, &s);
  *z1 = r * c;
  *z2 = r * s;
}

// sincos_poly<false> with every product and sum rounded once, in the torch
// form's order (ops/gbm.py sincos_poly): bit-identical to it.
__device__ __forceinline__ void sincos_poly_strict(float u, float* cos_t, float* sin_t) {
  const float t = 4.0f * u;
  float q = floorf(t + 0.5f);
  const float r = __fmul_rn(__fsub_rn(t, q), 0x1.921fb6p+0f);  // π/2
  const float r2 = __fmul_rn(r, r);
  float s = __fadd_rn(-0x1.a01a02p-13f, __fmul_rn(r2, 0x1.71de3ap-19f));
  s = __fadd_rn(0x1.111112p-7f, __fmul_rn(r2, s));
  s = __fadd_rn(-0x1.555556p-3f, __fmul_rn(r2, s));
  s = __fmul_rn(r, __fadd_rn(1.0f, __fmul_rn(r2, s)));
  float c = __fadd_rn(-0x1.6c16c2p-10f, __fmul_rn(r2, 0x1.a01a02p-16f));
  c = __fadd_rn(0x1.555556p-5f, __fmul_rn(r2, c));
  c = __fadd_rn(-0.5f, __fmul_rn(r2, c));
  c = __fadd_rn(1.0f, __fmul_rn(r2, c));
  q = (q == 4.0f) ? 0.0f : q;
  if (q == 1.0f) {
    *cos_t = -s;
    *sin_t = c;
  } else if (q == 2.0f) {
    *cos_t = -c;
    *sin_t = -s;
  } else if (q == 3.0f) {
    *cos_t = s;
    *sin_t = -c;
  } else {
    *cos_t = c;
    *sin_t = s;
  }
}

// boxmuller<false> rounded as the torch form rounds it: bit-identical draws.
__device__ __forceinline__ void boxmuller_strict(float u1, float u2, float* z1, float* z2) {
  const float r = __fsqrt_rn(-2.0f * ln_poly<false, true>(u1));
  float c, s;
  sincos_poly_strict(u2, &c, &s);
  *z1 = __fmul_rn(r, c);
  *z2 = __fmul_rn(r, s);
}

// Student-t(df) by Bailey's polar transform (not unit variance: the wrapper
// folds the scale into L). p = u^(-2/df) - 1 cancels as u → 1, where sqrt(df p)
// magnifies one ulp of the exp to ~2e-5 in the draw; so ln and exp are
// evaluated strictly here, and p is bit-identical to the torch form's.
__device__ __forceinline__ float t_draw(float u, float v, float df, float neg2_over_df) {
  const float p = exp_poly<true>(mul<true>(neg2_over_df, ln_poly<false, true>(u))) - 1.0f;
  const float r = sqrtf(df * fmaxf(p, 0.0f));
  float c, s;
  sincos_poly<false>(v, &c, &s);
  return r * c;
}

// Steps of one (path, asset) that one Philox call feeds: two Box-Muller pairs
// for the normal tiers, two polar-t draws for the t tier.
template <int kTier>
__host__ __device__ constexpr int steps_per_call() {
  return kTier == kStudentT ? 2 : 4;
}

// The shocks of steps c·steps_per_call .. + n-1 of one (path, asset): Philox
// call c of stream kStream, consumed as the terminal-noise kernel consumes it.
// z[k] for k >= n is left 0.
template <int kTier, uint32_t kStream = kStreamGbm>
__device__ __forceinline__ void call_draws(uint32_t c, uint32_t asset, uint32_t path,
                                           uint32_t key, int n, float df,
                                           float neg2_over_df, float z[4]) {
  const Words w = philox4x32_10(c, asset, path, kStream, key, 0u);
  z[0] = z[1] = z[2] = z[3] = 0.0f;
  if (kTier == kStudentT) {
    z[0] = t_draw(bits_to_unit(w.w0), bits_to_unit(w.w1), df, neg2_over_df);
    if (n > 1) z[1] = t_draw(bits_to_unit(w.w2), bits_to_unit(w.w3), df, neg2_over_df);
  } else if (kTier == kPolyStrict) {
    boxmuller_strict(bits_to_unit(w.w0), bits_to_unit(w.w1), &z[0], &z[1]);
    if (n > 2) boxmuller_strict(bits_to_unit(w.w2), bits_to_unit(w.w3), &z[2], &z[3]);
  } else {
    constexpr bool kFast = kTier == kPolyFast;
    boxmuller<kFast>(bits_to_unit(w.w0), bits_to_unit(w.w1), &z[0], &z[1]);
    if (n > 2) boxmuller<kFast>(bits_to_unit(w.w2), bits_to_unit(w.w3), &z[2], &z[3]);
  }
}

}  // namespace

extern "C" const char* mcport_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
