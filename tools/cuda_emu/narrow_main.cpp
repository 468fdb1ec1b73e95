// One candidate launch of a tree's csrc/jump.cu (-DFAMILY_JUMP, kernel #8),
// csrc/heston.cu (-DFAMILY_HESTON, #10), csrc/garch.cu (-DFAMILY_GARCH, #5) or
// csrc/bootstrap.cu (-DFAMILY_BOOTSTRAP, #7) — or of the GBM kernels #3 and
// #2 (-DFAMILY_GBM, -DFAMILY_GBM_TILE, -DFAMILY_GBM_STATS: gbm_main.inc) —
// under the host emulation
// (cuda_runtime.h), its outputs written as raw float32 (tools/cuda_emu/
// narrow_ab.py and tests/test_torch_narrow_plans.py build and run it):
//   narrow_emu A PATHS STEPS NBLOCKS NCAND NLEGS LAYOUT CASE OUTFILE [SCRATCH_FLOATS]
// Seed 11, blocks 7 .. 6 + NBLOCKS. Its inputs go to OUTFILE.in, raw float32:
// the parameter block (bootstrap: the history), (jump) the rate, the weights
// (NCAND, A) and the hedge block (NLEGS legs per asset of every type, or
// none). LAYOUT -1 lets the entry point pick; 0-2 name one (trees built with
// -DNARROW_LAYOUTS, whose entry points take a scratch and a layout; the
// scratch holds the whole launch's returns, or SCRATCH_FLOATS; only the
// Heston kernel has layout 2). CASE 0: the bench's jump rate 0.02, Heston vol of
// vol 3e-3, GARCH persistence, a 365-row history in shared memory; 1: rate
// 0.3, a Feller-violating 0.05, a GARCH of larger shocks, a 4,099-row history
// read from device memory. NCAND 0 (-DFAMILY_HESTON, -DFAMILY_GARCH) runs the
// terminal function instead, kernel #9 or #4, in the layout LAYOUT names
// (-1 and 0 the one the entry point routes to, 1 the 17-64-asset tile):
// OUTFILE gets (NBLOCKS, PATHS, A) and OUTFILE.in the parameter block; CASE 2
// and 3 are CASE 0 and 1 with, for Heston, the log sum in place of its
// expm1 (cuda_runtime.h g_emu_log_sum) and, for GARCH, Student-t(5.5) shocks
// (the t scale folded into L as ops/gbm.py t_scaled_chol folds it; OUTFILE.in
// holds the unscaled block).
// `narrow_emu layout OUTFILE` (trees built with -DNARROW_LAYOUTS) writes the
// redesigned layouts' arithmetic as int32 rows (A, W, legs, narrow_layout,
// RecurLayout kOwn and kReturns totals, the tile layout's total (jump, GARCH,
// bootstrap: 0), score_floats, score_groups; the bootstrap's layouts without
// the history, then its RecurLayout kOwn and kReturns totals with a 365-row
// history in shared memory) for A = 1-16, W = 1-256 and legs 0-4.
#include "cuda_runtime.h"
#if defined(FAMILY_GBM) || defined(FAMILY_GBM_TILE) || defined(FAMILY_GBM_STATS)
#include "gbm_main.inc"
#elif defined(FAMILY_JUMP)
#include "jump.cu"
#elif defined(FAMILY_GARCH)
#include "garch.cu"
#elif defined(FAMILY_BOOTSTRAP)
#include "bootstrap.cu"
#else
#include "heston.cu"
#endif
#include <random>
#include <string>

#if !(defined(FAMILY_GBM) || defined(FAMILY_GBM_TILE) || defined(FAMILY_GBM_STATS))
int main(int argc, char** argv) {
#ifdef NARROW_LAYOUTS
  if (std::string(argv[1]) == "layout") {
    std::vector<int> rows;
    for (int a = 1; a <= kNA; ++a)
      for (int w = 1; w <= 256; ++w)
        for (int l = 0; l <= 4; ++l) {
#if defined(FAMILY_BOOTSTRAP)
          rows.insert(rows.end(), {a, w, l, narrow_layout(w, l > 0),
                                   RecurLayout(365, a, w, kOwn, l, false).total,
                                   RecurLayout(365, a, w, kReturns, l, false).total,
                                   0,  // no tile layout up to 16 assets
                                   score_floats(a, w), score_groups(w),
                                   RecurLayout(365, a, w, kOwn, l, true).total,
                                   RecurLayout(365, a, w, kReturns, l, true).total});
#else
          rows.insert(rows.end(), {a, w, l, narrow_layout(w), RecurLayout(a, w, kOwn, l).total,
                                   RecurLayout(a, w, kReturns, l).total,
#if defined(FAMILY_JUMP) || defined(FAMILY_GARCH)
                                   0,  // the jump and GARCH kernels have no tile layout
#else
                                   TileLayout(a, round4(w), l).total,
#endif
                                   score_floats(a, w), score_groups(w)});
#endif
        }
    FILE* f = std::fopen(argv[2], "wb");
    std::fwrite(rows.data(), 4, rows.size(), f);
    std::fclose(f);
    return 0;
  }
#endif
  const int a = std::atoi(argv[1]), paths = std::atoi(argv[2]), steps = std::atoi(argv[3]),
            nb = std::atoi(argv[4]), w_cnt = std::atoi(argv[5]), legs = std::atoi(argv[6]),
            layout = std::atoi(argv[7]);
  const int t_tier = std::atoi(argv[8]) / 2, cs = std::atoi(argv[8]) % 2;  // t: GARCH terminal
  std::mt19937 rng(a * 7 + 1);
  std::uniform_real_distribution<float> u(0.0f, 1.0f);
  // the shocks' factor: the Cholesky factor of 0.5 I + 0.5, perturbed
  std::vector<double> c(a * a, 0.0);
  for (int i = 0; i < a; ++i) {
    for (int j = 0; j <= i; ++j) {
      double s = (i == j ? 1.0 : 0.5 + 0.02 * (u(rng) - 0.5));
      for (int k = 0; k < j; ++k) s -= c[i * a + k] * c[j * a + k];
      c[i * a + j] = i == j ? std::sqrt(s) : s / c[j * a + j];
    }
  }
  std::vector<float> p;
#if defined(FAMILY_JUMP)
  for (int i = 0; i < a * a; ++i) p.push_back(static_cast<float>(0.02 * c[i]));   // L
  for (int i = 0; i < a; ++i) p.push_back(5e-4f + 1e-3f * (u(rng) - 0.5f));      // mean
  for (int i = 0; i < a; ++i) p.push_back(cs ? -0.2f : -0.08f);                   // muJ
  for (int i = 0; i < a; ++i) p.push_back(cs ? 0.1f : 0.04f);                     // sigJ
  const float lam = cs ? 0.3f : 0.02f;
#elif defined(FAMILY_GARCH)
  for (int i = 0; i < a * a; ++i) p.push_back(static_cast<float>(c[i]));          // L_R
  for (int i = 0; i < a; ++i) p.push_back(1e-3f + 1e-3f * (u(rng) - 0.5f));       // mu
  for (int i = 0; i < a; ++i) p.push_back(cs ? 1e-4f : 4e-5f);                    // omega
  for (int i = 0; i < a; ++i) p.push_back(cs ? 0.15f : 0.08f);                    // alpha
  for (int i = 0; i < a; ++i) p.push_back(cs ? 0.8f : 0.9f);                      // beta
  for (int i = 0; i < a; ++i) p.push_back(cs ? 1e-3f : 4e-4f);                    // sigma2_0
  for (int i = 0; i < a; ++i) p.push_back(cs ? 2e-3f : 4e-4f);                    // eps2_0
#elif defined(FAMILY_BOOTSTRAP)
  const int t_len = cs ? 4099 : 365;
  std::normal_distribution<float> ret(1e-3f, 0.02f);
  for (int i = 0; i < t_len * a; ++i) p.push_back(ret(rng));                     // history
  const float p_restart = 0.2f;
#else
  for (int i = 0; i < a * a; ++i) p.push_back(static_cast<float>(c[i]));          // L_R
  for (int i = 0; i < a; ++i) p.push_back(1e-3f + 1e-3f * (u(rng) - 0.5f));       // mu
  for (int i = 0; i < a; ++i) p.push_back(0.15f);                                 // kappa
  for (int i = 0; i < a; ++i) p.push_back(4e-4f);                                 // theta
  for (int i = 0; i < a; ++i) p.push_back(cs ? 0.05f : 3e-3f);                    // xi
  for (int i = 0; i < a; ++i) p.push_back(-0.5f);                                 // rho
  for (int i = 0; i < a; ++i) p.push_back(static_cast<float>(std::sqrt(1.0 - 0.25)));  // rho_c
  for (int i = 0; i < a; ++i) p.push_back(4e-4f);                                 // v0
#endif
#if defined(FAMILY_GARCH) || defined(FAMILY_HESTON)
  if (w_cnt == 0) {  // the terminal function (kernels #4 and #9)
    std::vector<float> out(1LL * nb * paths * a, -999.0f);
#if defined(FAMILY_GARCH)
    std::vector<float> q(p);  // the t tier folds its scale into L (ops/gbm.py t_scaled_chol)
    const float df = 5.5f, scale = std::sqrt(static_cast<float>(5.5 / 3.5));
    if (t_tier) for (int i = 0; i < a * a; ++i) q[i] = p[i] / scale;
    const int err = mcport_garch_terminal(11, 6, nb, paths, a, steps, layout < 0 ? 0 : layout,
                                          t_tier ? kStudentT : kPoly, t_tier ? df : 0.0f,
                                          t_tier ? -2.0f / df : 0.0f, q.data(), out.data(),
                                          nullptr);
#else
    g_emu_log_sum = t_tier;  // CASE 2, 3: the log sum before expm1
    const int err = mcport_heston_terminal(11, 6, nb, paths, a, steps, layout < 0 ? 0 : layout,
                                           p.data(), out.data(), nullptr);
#endif
    if (err) { std::fprintf(stderr, "error %d\n", err); return 1; }
    FILE* in = std::fopen((std::string(argv[9]) + ".in").c_str(), "wb");
    std::fwrite(p.data(), 4, p.size(), in);
    std::fclose(in);
    FILE* f = std::fopen(argv[9], "wb");
    std::fwrite(out.data(), 4, out.size(), f);
    std::fclose(f);
    return 0;
  }
#endif
  std::vector<float> w(w_cnt * a);
  for (int k = 0; k < w_cnt; ++k) {
    float t = 0;
    for (int i = 0; i < a; ++i) t += (w[k * a + i] = u(rng) + 0.01f);
    for (int i = 0; i < a; ++i) w[k * a + i] /= t;
  }
  std::vector<float> h;
  if (legs > 0) {
    std::vector<float> s0(a), ty(a * legs), k(a * legs), pr(a * legs), qt(a * legs);
    for (int i = 0; i < a; ++i) s0[i] = 20.0f + 180.0f * u(rng);
    for (int i = 0; i < a * legs; ++i) {
      ty[i] = static_cast<float>(i % 7);
      k[i] = s0[i / legs] * (0.9f + 0.2f * u(rng));
      pr[i] = s0[i / legs] * 0.02f * u(rng);
      qt[i] = 0.2f + 0.6f * u(rng);
    }
    qt.back() = 0.0f;
    for (auto* v : {&s0, &ty, &k, &pr, &qt}) h.insert(h.end(), v->begin(), v->end());
  }
  const long long out_n = 1LL * nb * w_cnt * paths;
  std::vector<float> out(out_n, -999.0f), dd(out_n, -999.0f);
  const float* hp = legs ? h.data() : nullptr;
  int err;
#ifdef NARROW_LAYOUTS
  std::vector<float> rets(argc > 10 ? std::atoll(argv[10])
                                    : 1LL * nb * ((paths + 15) / 16 * 16) * steps * a + 1);
  const long long rn = static_cast<long long>(rets.size());
#if defined(FAMILY_JUMP)
  err = mcport_merton_multi_dd(11, 6, nb, paths, a, w_cnt, steps, legs, lam, p.data(), w.data(),
                               hp, out.data(), dd.data(), rets.data(), rn, layout, nullptr);
#elif defined(FAMILY_GARCH)
  err = mcport_garch_multi_dd(11, 6, nb, paths, a, w_cnt, steps, 0, legs, p.data(), w.data(), hp,
                              out.data(), dd.data(), rets.data(), rn, layout, nullptr);
#elif defined(FAMILY_BOOTSTRAP)
  err = mcport_bootstrap_multi_dd(11, 6, nb, paths, t_len, a, w_cnt, steps, legs, p_restart,
                                  cs ? 0 : 1, p.data(), w.data(), hp, out.data(), dd.data(),
                                  rets.data(), rn, layout, nullptr);
#else
  err = mcport_heston_multi_dd(11, 6, nb, paths, a, w_cnt, steps, 0, legs, p.data(), w.data(),
                               hp, out.data(), dd.data(), rets.data(), rn, layout, nullptr);
#endif
#else
  (void)layout;
#if defined(FAMILY_JUMP)
  err = mcport_merton_multi_dd(11, 6, nb, paths, a, w_cnt, steps, legs, lam, p.data(), w.data(),
                               hp, out.data(), dd.data(), nullptr);
#elif defined(FAMILY_GARCH)
  err = mcport_garch_multi_dd(11, 6, nb, paths, a, w_cnt, steps, 0, legs, p.data(), w.data(), hp,
                              out.data(), dd.data(), nullptr);
#elif defined(FAMILY_BOOTSTRAP)
  err = mcport_bootstrap_multi_dd(11, 6, nb, paths, t_len, a, w_cnt, steps, legs, p_restart,
                                  cs ? 0 : 1, p.data(), w.data(), hp, out.data(), dd.data(),
                                  nullptr);
#else
  err = mcport_heston_multi_dd(11, 6, nb, paths, a, w_cnt, steps, 0, legs, p.data(), w.data(),
                               hp, out.data(), dd.data(), nullptr);
#endif
#endif
  if (err) { std::fprintf(stderr, "error %d\n", err); return 1; }
  FILE* in = std::fopen((std::string(argv[9]) + ".in").c_str(), "wb");
  std::fwrite(p.data(), 4, p.size(), in);
#ifdef FAMILY_JUMP
  std::fwrite(&lam, 4, 1, in);
#endif
  std::fwrite(w.data(), 4, w.size(), in);
  std::fwrite(h.data(), 4, h.size(), in);
  std::fclose(in);
  FILE* f = std::fopen(argv[9], "wb");
  std::fwrite(out.data(), 4, out.size(), f);
  std::fwrite(dd.data(), 4, dd.size(), f);
  std::fclose(f);
  return 0;
}
#endif
