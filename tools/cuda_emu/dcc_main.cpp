// One DCC launch of a tree's csrc/dcc.cu under the host emulation
// (cuda_runtime.h), its outputs written as raw float32 (tools/cuda_emu/dcc_ab.py
// builds and runs it):
//   dcc_emu MODE A PATHS STEPS NBLOCKS NCAND NLEGS CASE OUTFILE [SCRATCH_FLOATS]
// Its inputs go to OUTFILE.in, raw float32: the parameter block, the weights
// (NCAND, A) and the hedge block (tests/test_torch_dcc_narrow.py rebuilds the
// launch from them). `dcc_emu layout OUTFILE` (trees built with
// -DDCC_NARROW_SCRATCH) writes the narrow candidate kernel's layout as int32
// rows (A, W, legs, mode, NarrowLayout total, score_groups, score_steps) for
// A = 1-16, W = 1-256, legs 0-4 and its three modes.
// MODE 0 the terminal function, 1 the candidates' (hedged when NLEGS > 0,
// every leg type); CASE 0 q0 = S, e0 = 0, 1 q0 = S + 0.05 I, e0 = 3. S is
// 0.5 I + 0.5 with small asymmetric perturbations, the GARCH parameters the
// bench's, a = 0.05, b = 0.9. Built with -DDCC_CTAS_API for trees whose
// mcport_dcc_wide takes a CTA count and whose narrow entry points take up to
// 64 assets; otherwise the weights go to mcport_dcc_wide transposed, with
// the scratch's float count. Built with -DDCC_NARROW_SCRATCH for trees whose
// narrow candidate entry point takes a scratch (its returns past a few
// candidates), sized for the whole launch.
#include "cuda_runtime.h"
#include "dcc.cu"
#include <random>
#include <string>

int main(int argc, char** argv) {
#ifdef DCC_NARROW_SCRATCH
  if (std::string(argv[1]) == "layout") {
    std::vector<int> rows;
    for (int a = 1; a <= kDA; ++a)
      for (int w = 1; w <= kMaxCand; ++w)
        for (int l = 0; l <= 4; ++l)
          for (int m : {kSolo, kReturns, kScore})
            rows.insert(rows.end(), {a, w, l, m, NarrowLayout(a, w, m, l).total,
                                     score_groups(w), score_steps(a, w)});
    FILE* f = std::fopen(argv[2], "wb");
    std::fwrite(rows.data(), 4, rows.size(), f);
    std::fclose(f);
    return 0;
  }
#endif
  const int mode = std::atoi(argv[1]), a = std::atoi(argv[2]), paths = std::atoi(argv[3]),
            steps = std::atoi(argv[4]), nb = std::atoi(argv[5]), w_cnt = std::atoi(argv[6]),
            legs = std::atoi(argv[7]), cs = std::atoi(argv[8]);
  std::mt19937 rng(a * 7 + 1);
  std::uniform_real_distribution<float> u(0.0f, 1.0f);
  std::vector<float> p;
  // S: 0.5 I + 0.5 perturbed symmetric-ish (as corr_chol corr_chol' in float32 would be)
  std::vector<float> s(a * a), q0(a * a);
  for (int i = 0; i < a; ++i)
    for (int j = 0; j < a; ++j) s[i * a + j] = i == j ? 1.0f : 0.5f + 0.01f * (u(rng) - 0.5f);
  for (int i = 0; i < a * a; ++i) q0[i] = s[i] + (cs == 1 && i % (a + 1) == 0 ? 0.05f : 0.0f);
  p.insert(p.end(), s.begin(), s.end());
  p.insert(p.end(), q0.begin(), q0.end());
  for (int i = 0; i < a; ++i) p.push_back(1e-3f + 5e-4f * (u(rng) - 0.5f));  // mu
  for (int i = 0; i < a; ++i) p.push_back(4e-5f);                            // omega
  for (int i = 0; i < a; ++i) p.push_back(0.08f);                            // alpha
  for (int i = 0; i < a; ++i) p.push_back(0.9f);                             // beta
  for (int i = 0; i < a; ++i) p.push_back(4e-4f);                            // sigma2_0
  for (int i = 0; i < a; ++i) p.push_back(4e-4f);                            // eps2_0
  for (int i = 0; i < a; ++i) p.push_back(cs == 1 ? 3.0f : 0.0f);            // e0
  p.push_back(0.05f);
  p.push_back(0.9f);
  std::vector<float> w(w_cnt * a), wt(a * w_cnt);
  for (int c = 0; c < w_cnt; ++c) {
    float t = 0;
    for (int i = 0; i < a; ++i) t += (w[c * a + i] = u(rng) + 0.01f);
    for (int i = 0; i < a; ++i) w[c * a + i] /= t;
  }
  for (int c = 0; c < w_cnt; ++c)
    for (int i = 0; i < a; ++i) wt[i * w_cnt + c] = w[c * a + i];
  std::vector<float> h;
  if (legs > 0) {
    std::vector<float> s0(a), ty(a * legs), k(a * legs), pr(a * legs), qt(a * legs);
    for (int i = 0; i < a; ++i) s0[i] = 20.0f + 180.0f * u(rng);
    for (int i = 0; i < a * legs; ++i) {
      ty[i] = static_cast<float>(i % 7);
      k[i] = s0[i / legs] * (0.85f + 0.3f * u(rng));
      pr[i] = s0[i / legs] * 0.02f * u(rng);
      qt[i] = 0.2f + 1.3f * u(rng);
    }
    qt.back() = 0.0f;
    for (auto* v : {&s0, &ty, &k, &pr, &qt}) h.insert(h.end(), v->begin(), v->end());
  }
  const long long out_n = mode == 0 ? 1LL * nb * paths * a : 1LL * nb * w_cnt * paths;
  std::vector<float> out(out_n, -999.0f), dd(out_n, -999.0f);
  std::vector<float> scratch(1 << 22);
  int err;
#ifdef DCC_CTAS_API
  if (a <= 64) {
    err = mode == 0 ? mcport_dcc_terminal(11, 6, nb, paths, a, steps, p.data(), out.data(), nullptr)
                    : mcport_dcc_multi_dd(11, 6, nb, paths, a, w_cnt, steps, legs, p.data(), w.data(),
                                          legs ? h.data() : nullptr, out.data(), dd.data(), nullptr);
  } else {
    scratch.resize(8LL * a * (a + 1));
    err = mcport_dcc_wide(11, 6, nb, paths, a, mode == 0 ? 0 : w_cnt, steps, legs, p.data(),
                          mode ? w.data() : nullptr, legs ? h.data() : nullptr, out.data(),
                          mode ? dd.data() : nullptr, scratch.data(), 8, nullptr);
  }
#else
  if (a <= 16) {
#ifdef DCC_NARROW_SCRATCH
    // the narrow candidates' scratch: the whole launch's returns, or
    // SCRATCH_FLOATS (chunks of paths)
    std::vector<float> rets(argc > 10 ? std::atoll(argv[10])
                                      : 1LL * nb * ((paths + 15) / 16 * 16) * steps * a + 1);
    err = mode == 0 ? mcport_dcc_terminal(11, 6, nb, paths, a, steps, p.data(), out.data(), nullptr)
                    : mcport_dcc_multi_dd(11, 6, nb, paths, a, w_cnt, steps, legs, p.data(), w.data(),
                                          legs ? h.data() : nullptr, out.data(), dd.data(),
                                          rets.data(), static_cast<long long>(rets.size()),
                                          nullptr);
#else
    err = mode == 0 ? mcport_dcc_terminal(11, 6, nb, paths, a, steps, p.data(), out.data(), nullptr)
                    : mcport_dcc_multi_dd(11, 6, nb, paths, a, w_cnt, steps, legs, p.data(), w.data(),
                                          legs ? h.data() : nullptr, out.data(), dd.data(), nullptr);
#endif
  } else {
    err = mcport_dcc_wide(11, 6, nb, paths, a, mode == 0 ? 0 : w_cnt, steps, legs, p.data(),
                          mode ? wt.data() : nullptr, legs ? h.data() : nullptr, out.data(),
                          mode ? dd.data() : nullptr, scratch.data(),
                          static_cast<long long>(scratch.size()), nullptr);
  }
#endif
  if (err) { std::fprintf(stderr, "error %d\n", err); return 1; }
  FILE* in = std::fopen((std::string(argv[9]) + ".in").c_str(), "wb");
  std::fwrite(p.data(), 4, p.size(), in);
  std::fwrite(w.data(), 4, w.size(), in);
  std::fwrite(h.data(), 4, h.size(), in);
  std::fclose(in);
  FILE* f = std::fopen(argv[9], "wb");
  std::fwrite(out.data(), 4, out.size(), f);
  if (mode) std::fwrite(dd.data(), 4, dd.size(), f);
  std::fclose(f);
  return 0;
}
