// Hedged per-step settlement inside the path kernels: the option legs of one
// asset settled at intrinsic value against one simulated price move.
//
// Replaces mcport/ops/pallas_multi_dd.py::make_hedged_returns, the settlement
// shared by the TPU kernels' hedged modes; the plain torch form of the same
// function is mcport_torch/ops/hedged.py::hedged_returns_reference. Included by
// multi_dd.cu (kernel #3), garch.cu (#5), bootstrap.cu (#7), jump.cu (#8),
// heston.cu (#10) and wide.cuh (their layouts past 64 assets).
//
// What it computes. For a move p_prev -> p_new of one asset and its L legs
// (type, strike K, premium, qty; ops/hedged.py HedgeTensors.packed, in shared
// memory), with up = p_new - p_prev, call = max(p_new - K, 0) and put =
// max(K - p_new, 0):
//   numer = up (BUY_ASSET), -up (SELL_ASSET, SELL_FUTURES), call - premium,
//           premium - call, put - premium, premium - put (the options), else 0
//   r    += qty * numer      (leg by leg)
//   return r / p_prev
// A runtime loop over the legs; an unknown type and the qty-0 padding give
// exactly 0. Every operation is rounded once (__fsub_rn, __fmul_rn,
// __fadd_rn, an IEEE division; the build uses no fast-math), as the torch form
// rounds it, so equal prices settle to equal returns bit for bit.
//
// What it costs. Per asset-step: one subtraction, then per leg two
// subtractions and two maxima, the select, a multiply and an add, and one
// division — a few dozen instructions beside a step's draw and correlate.

#pragma once

#include <cuda_runtime.h>

namespace {

// The hedge block in shared memory: s0 (A), then the legs' type ids (exact
// small integers as floats), strikes, premiums and quantities, (A, L) each.
struct HedgeBlock {
  const float *s0, *type, *strike, *premium, *qty;
  int n_legs;
  __device__ HedgeBlock(const float* h, int n_assets, int legs)
      : s0(h), type(h + n_assets), strike(type + n_assets * legs),
        premium(strike + n_assets * legs), qty(premium + n_assets * legs), n_legs(legs) {}
};

// Floats of the hedge block for A assets of L legs.
__host__ __device__ constexpr int hedge_floats(int n_assets, int n_legs) {
  return n_assets * (1 + 4 * n_legs);
}

// The running peak and drawdown of hedged wealth, as torch.maximum and
// torch.minimum take them: a NaN operand gives NaN, where fmaxf/fminf drop it.
// Per-step settlement can overflow the wealth (V = inf, then V/peak = NaN); the
// plain form and mcport then carry NaN, and so must the kernels.
__device__ __forceinline__ float max_nan(float a, float b) { return (b > a || b != b) ? b : a; }
__device__ __forceinline__ float min_nan(float a, float b) { return (b < a || b != b) ? b : a; }

// The hedged return of asset a over the move p_prev -> p_new.
__device__ __forceinline__ float hedged_return(const HedgeBlock& h, int a, float p_prev,
                                               float p_new) {
  const float up = __fsub_rn(p_new, p_prev);
  float r = 0.0f;
  for (int l = a * h.n_legs; l < (a + 1) * h.n_legs; ++l) {
    const float k = h.strike[l], prem = h.premium[l];
    const float call_iv = fmaxf(__fsub_rn(p_new, k), 0.0f);
    const float put_iv = fmaxf(__fsub_rn(k, p_new), 0.0f);
    float numer;
    switch (static_cast<int>(h.type[l])) {
      case 0:
        numer = up;
        break;
      case 1:
      case 6:
        numer = -up;
        break;
      case 2:
        numer = __fsub_rn(call_iv, prem);
        break;
      case 3:
        numer = __fsub_rn(prem, call_iv);
        break;
      case 4:
        numer = __fsub_rn(put_iv, prem);
        break;
      case 5:
        numer = __fsub_rn(prem, put_iv);
        break;
      default:
        numer = 0.0f;
    }
    r = __fadd_rn(r, __fmul_rn(h.qty[l], numer));
  }
  return __fdiv_rn(r, p_prev);
}

}  // namespace
