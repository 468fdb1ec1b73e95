// Correlated-GBM terminal noise on Hopper: out[b, p, :] = L · Σ_{t<n_steps} z_t.
//
// Replaces mcport/ops/pallas_gbm.py::_terminal_noise_kernel (the TPU kernel of
// the gbm-risk main path). The plain torch form of the same function, on the
// same Philox counters, is mcport_torch/ops/gbm.py::terminal_noise_reference.
//
// What it computes. For block b of a dispatch group and path p < block_paths,
// each asset a sums n_steps shocks z: Box-Muller normals ("poly" and
// "poly_fast" tiers) or Student-t draws by Bailey's polar transform (t tier),
// all with mcport's polynomials for ln, sin/cos and exp. Then one matrix-vector
// product with L correlates the sums. The drift, the antithetic mirror and the
// t scale are the wrapper's (ops/gbm.py::block_terminal_log_returns).
//
// Random bits. Philox4x32-10, key (uint32(seed + (first_block + b + 1) *
// SEED_STRIDE), 0) — the int32 block seed of mcport/engine/mc_engine.py — and
// counter (draw, asset, path_in_block, STREAM_GBM). Normal pair i takes words
// (0,1) of draw i/2 when i is even, words (2,3) when odd; t pair i takes draw i
// whole. An odd n_steps adds pair n_steps/2, of which only the first draw
// counts. Bits map to [2^-23, 1] as 1 - (bits >> 9) * 2^-23, exact in float,
// so the kernel and the plain form see bit-identical uniforms. Nothing depends
// on the launch geometry: any sub-range of paths regenerates bit for bit.
//
// What bounds it on the card. Per path-step and asset: half a Philox call (ten
// rounds of two 32x32 multiplies, hi and lo, and four XORs) plus ~40
// floating-point operations of polynomials and one sqrt. It reads nothing per
// step and stores 4·A bytes per path once, so it is bound by integer and FMA
// issue, not by memory. The design follows: one thread per path keeps its
// running sum in a register, draws are computed where they are used, L sits in
// shared memory and is read once per path, and a whole dispatch group of
// blocks is one launch (gridDim.y = blocks) so that even 8,192-path blocks fill
// the 132 SMs. Coalescing the store and sharing key schedules are left to
// later work: the store is a small fraction of the time.
//
// nvcc contracts a*b+c into FMA where the torch form rounds twice, so kernel
// and plain form agree to ulps, not bits (bound stated in chip_smoke.py). The
// t tier's ln and exp are the exception: see t_draw.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxAssets = 64;  // 4·(A² + kThreads·A) bytes ≤ 48 KB of shared memory;
                                // ops/gbm.py MAX_ASSETS
constexpr long long kSeedStride = 1LL << 14;  // mcport/seeding.py SEED_STRIDE
constexpr uint32_t kStreamGbm = 0;            // mcport_torch/rng.py STREAM_GBM

enum Tier { kPoly = 0, kPolyFast = 1, kStudentT = 2 };

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

__device__ __forceinline__ float bits_to_unit(uint32_t bits) {
  return 1.0f - __uint2float_rn(bits >> 9) * 0x1p-23f;
}

// Constants are the float32 values of mcport's Python literals, written in hex
// so that the kernel and the torch form use the same bits.

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

template <int kTier>
__global__ void __launch_bounds__(kThreads)
terminal_noise_kernel(long long seed, long long first_block, int block_paths, int n_assets,
                      int n_steps, float df, float neg2_over_df,
                      const float* __restrict__ chol, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* s_chol = smem;                          // (A, A) row-major
  float* s_acc = smem + n_assets * n_assets;     // (A, kThreads): this block's sums
  for (int i = threadIdx.x; i < n_assets * n_assets; i += blockDim.x) s_chol[i] = chol[i];
  __syncthreads();

  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= block_paths) return;
  const int b = blockIdx.y;
  const uint32_t key = static_cast<uint32_t>(
      static_cast<unsigned long long>(seed + (first_block + b + 1) * kSeedStride));
  const int n_pairs = n_steps / 2;
  const int total = n_pairs + (n_steps & 1);

  for (int a = 0; a < n_assets; ++a) {
    float acc = 0.0f;
    if (kTier == kStudentT) {
      for (int i = 0; i < total; ++i) {
        const Words w = philox4x32_10(i, a, p, kStreamGbm, key, 0u);
        const float t1 = t_draw(bits_to_unit(w.w0), bits_to_unit(w.w1), df, neg2_over_df);
        if (i < n_pairs) {
          acc = acc + (t1 + t_draw(bits_to_unit(w.w2), bits_to_unit(w.w3), df, neg2_over_df));
        } else {
          acc = acc + t1;
        }
      }
    } else {
      constexpr bool kFast = kTier == kPolyFast;
      for (int i = 0; i < total; i += 2) {
        const Words w = philox4x32_10(i / 2, a, p, kStreamGbm, key, 0u);
        float z1, z2;
        boxmuller<kFast>(bits_to_unit(w.w0), bits_to_unit(w.w1), &z1, &z2);
        acc = (i < n_pairs) ? acc + (z1 + z2) : acc + z1;
        if (i + 1 < total) {
          boxmuller<kFast>(bits_to_unit(w.w2), bits_to_unit(w.w3), &z1, &z2);
          acc = (i + 1 < n_pairs) ? acc + (z1 + z2) : acc + z1;
        }
      }
    }
    s_acc[a * kThreads + threadIdx.x] = acc;
  }

  float* row = out + (static_cast<long long>(b) * block_paths + p) * n_assets;
  for (int i = 0; i < n_assets; ++i) {
    float s = 0.0f;
    for (int j = 0; j < n_assets; ++j) s += s_chol[i * n_assets + j] * s_acc[j * kThreads + threadIdx.x];
    row[i] = s;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` for blocks first_block+1 .. first_block+n_blocks.
// chol: (n_assets, n_assets) float32 row-major on the device; out: (n_blocks,
// block_paths, n_assets) float32. tier: 0 poly, 1 poly_fast, 2 Student-t (df,
// neg2_over_df = -2/df used only then). Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for arguments the kernel does not take.
int mcport_terminal_noise(long long seed, long long first_block, int n_blocks,
                          int block_paths, int n_assets, int n_steps, int tier, float df,
                          float neg2_over_df, const void* chol, void* out, void* stream) {
  if (n_assets < 1 || n_assets > kMaxAssets || n_blocks < 1 || n_blocks > 65535 ||
      block_paths < 1 || n_steps < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((block_paths + kThreads - 1) / kThreads, n_blocks);
  const size_t smem = sizeof(float) * (n_assets * n_assets + kThreads * n_assets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(chol);
  float* o = static_cast<float*>(out);
  switch (tier) {
    case kPoly:
      terminal_noise_kernel<kPoly><<<grid, kThreads, smem, s>>>(
          seed, first_block, block_paths, n_assets, n_steps, df, neg2_over_df, l, o);
      break;
    case kPolyFast:
      terminal_noise_kernel<kPolyFast><<<grid, kThreads, smem, s>>>(
          seed, first_block, block_paths, n_assets, n_steps, df, neg2_over_df, l, o);
      break;
    case kStudentT:
      terminal_noise_kernel<kStudentT><<<grid, kThreads, smem, s>>>(
          seed, first_block, block_paths, n_assets, n_steps, df, neg2_over_df, l, o);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* mcport_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
