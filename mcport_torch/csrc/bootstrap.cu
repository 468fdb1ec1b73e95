// Stationary block-bootstrap paths on Hopper: the terminal simple returns of
// every asset (kernel bootstrap_terminal_kernel) and W candidate portfolios'
// rebalanced wealth with its maximum drawdown (kernel bootstrap_dd_kernel).
//
// Replaces mcport/ops/pallas_bootstrap.py::_bootstrap_kernel (the
// bootstrap-risk main path) and ::_bootstrap_dd_kernel, both modes (path-risk
// --models bootstrap and the bootstrap drawdown frontier, hedged or not). The plain
// torch forms of the same functions, on the same Philox counters, are
// mcport_torch/ops/bootstrap.py::bootstrap_terminal_reference and
// ::bootstrap_multi_dd_reference.
//
// What they compute. For block b of a dispatch group and path p < block_paths,
// over a (T, A) history of per-period simple returns: a start row, then per
// step the row idx = restart ? jump : (idx + 1) mod T (Politis-Romano,
// circular), and either gross *= 1 + hist[idx] per asset (terminal: out
// gross - 1), or for every candidate w, V *= 1 + w·hist[idx], peak, dd from
// V_0 = peak_0 = 1, dd_0 = 0 (out V_T - 1 and dd per candidate and path).
// Hedged (kHedged, pallas_bootstrap.py:147-164): each (asset, path) item
// carries its price from s0, P_new = P·(1 + row), one add and one multiply as
// the plain form rounds them, so the prices and hedged.cuh's settled returns
// equal the plain form's bit for bit; V *= 1 + w·r_h, a NaN of overflowed
// wealth carried. Past 64 assets both functions run wide.cuh's layout with
// the BootWide model below (the history read from device memory).
//
// Uniforms: Philox4x32-10 (gbm_draws.cuh), key the block seed, counter (call,
// 0, path, STREAM_BOOT). Call 0 word 0 gives the start row; call 1 + s/2 gives
// step s its (restart, jump) words, (0, 1) for an even step, (2, 3) for an odd
// one. With m = bits >> 9: restart when m·2^-23 < p_restart (float32, exact on
// both sides), jump row (m·T) >> 23 in integers. So the kernels pick the rows
// the plain forms pick, and the terminal kernel equals its plain form bit for
// bit: gross *= 1 + row is one add and one multiply, with nothing to contract.
//
// What bounds them on the card. Per path-step: half a Philox call (~60
// instructions), the index update, then per asset one shared load and one add
// and multiply; the candidate kernel adds W·A scoring FMAs. Nothing is read
// from device memory per step, each output is stored once: instruction issue
// bounds them. The designs: the history lives in (dynamic, opt-in) shared
// memory for the whole launch, so selection is a load — the TPU's one-hot
// matmul gather and its 3-way bf16 split are not ported. A history past a
// block's shared memory (kShared false, chosen by ops/bootstrap.py
// history_in_shared) stays in device memory, and each selected row is read
// through the read-only cache (__ldg): the same rows, the same arithmetic, so
// the same results; only the load's source moves. Terminal: one thread
// per path, the asset grosses in registers for A <= 16 (local memory from 17
// to 64). Candidates up to 16 assets, the layout narrow_layout picks by W
// (narrow_dd.cuh; ops/bootstrap.py bootstrap_narrow_plan): for few
// candidates a thread per path (kBootThreads per block: the recursion is
// light, and a block's history takes a share of the SM's shared memory)
// walks its row index, reads its row and scores its own candidates
// (bootstrap_recur_kernel<shared, hedged, kOwn>); for more the same walk
// writes its rows to a device scratch and scoring blocks (each thread 4
// candidates x 4 paths) read them (kReturns, then narrow_dd.cuh's
// score_kernel). Hedged, the thread keeps its prices in a slice of shared
// memory and settles leg by leg across the assets. Whether the history sits
// in shared memory is decided per layout, from that layout's own block.
// From 17 to 64 assets: multi_dd.cu's block design
// — a block owns 16 paths and all <= 256 candidates; 16 threads keep the
// tile's row indices and write the rows of two steps' indices to shared
// memory per Philox call; per step the block copies the selected rows into a
// (A, 16) tile, then each thread updates a 4-candidate x 4-path micro-tile of
// values, peaks and drawdowns held in registers (FP32 FMAs, mcport's float32
// score). A dispatch group of blocks is one launch (gridDim.y).

#include "gbm_draws.cuh"
#include "hedged.cuh"
#include "narrow_dd.cuh"
#include "wide.cuh"

namespace {

constexpr int kTermThreads = 128;
constexpr int kDdThreads = 256;
constexpr int kTileP = 16;     // paths per candidate block
constexpr int kMaxCand = 256;  // ops/multi_dd.py MAX_CANDIDATES
constexpr int kItems = 4;      // (asset, path) items per thread: kMaxAssets·kTileP / kDdThreads

__device__ __forceinline__ Words boot_call(uint32_t c, int path, uint32_t key) {
  return philox4x32_10(c, 0u, static_cast<uint32_t>(path), kStreamBoot, key, 0u);
}

// ⌊m · T / 2^23⌋ for the 23-bit m = bits >> 9: a uniform row in [0, T).
__device__ __forceinline__ int jump_row(uint32_t bits, int t_len) {
  return static_cast<int>((static_cast<unsigned long long>(bits >> 9) * t_len) >> 23);
}

__device__ __forceinline__ int next_row(int idx, uint32_t restart_bits, uint32_t jump_bits,
                                        int t_len, float p_restart) {
  if (__uint2float_rn(restart_bits >> 9) * 0x1p-23f < p_restart) {
    return jump_row(jump_bits, t_len);
  }
  return idx + 1 == t_len ? 0 : idx + 1;
}

// A history row's entry a: from shared memory, or from device memory through
// the read-only cache.
template <bool kShared>
__device__ __forceinline__ float row_at(const float* row, int a) {
  return kShared ? row[a] : __ldg(row + a);
}

// kA: the asset capacity; kUnroll: how far the loops over assets unroll (kA
// keeps the grosses in registers, 1 lets them live in local memory); kShared:
// the history in shared memory (else read from device memory).
template <int kA, int kUnroll, bool kShared>
__global__ void __launch_bounds__(kTermThreads)
bootstrap_terminal_kernel(long long seed, long long first_block, int block_paths, int t_len,
                          int n_assets, int n_steps, float p_restart,
                          const float* __restrict__ hist, float* __restrict__ out) {
  extern __shared__ float s_hist[];  // (T, A) when kShared
  if (kShared) {
    for (int i = threadIdx.x; i < t_len * n_assets; i += kTermThreads) s_hist[i] = hist[i];
  }
  __syncthreads();
  const float* h = kShared ? s_hist : hist;

  const int p = blockIdx.x * kTermThreads + threadIdx.x;
  if (p >= block_paths) return;
  const int b = blockIdx.y;
  const uint32_t key = block_key(seed, first_block, b);

  int idx = jump_row(boot_call(0u, p, key).w0, t_len);
  float gross[kA];
#pragma unroll (kUnroll)
  for (int a = 0; a < kA; ++a) gross[a] = 1.0f;

  for (int s = 0; s < n_steps; s += 2) {
    const Words w = boot_call(1u + s / 2, p, key);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (s + k >= n_steps) continue;
      idx = k ? next_row(idx, w.w2, w.w3, t_len, p_restart)
              : next_row(idx, w.w0, w.w1, t_len, p_restart);
      const float* row = h + idx * n_assets;
#pragma unroll (kUnroll)
      for (int a = 0; a < kA; ++a) {
        if (a < n_assets) gross[a] *= 1.0f + row_at<kShared>(row, a);
      }
    }
  }

  const long long o = (static_cast<long long>(b) * block_paths + p) * n_assets;
#pragma unroll (kUnroll)
  for (int a = 0; a < kA; ++a) {
    if (a < n_assets) out[o + a] = gross[a] - 1.0f;
  }
}

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

struct DdLayout {  // offsets into dynamic shared memory, in floats, 16-byte aligned
  int hist, w, e, idx, total;
  __host__ __device__ DdLayout(int t_len, int a, int w_pad, bool shared) {
    hist = 0;
    w = shared ? round4(t_len * a) : 0;
    e = w + a * w_pad;
    idx = e + a * kTileP;
    total = idx + 2 * kTileP;
  }
};

template <bool kShared, bool kHedged>
__global__ void __launch_bounds__(kDdThreads, 2)
bootstrap_dd_kernel(long long seed, long long first_block, int block_paths, int t_len,
                    int n_assets, int n_cand, int n_steps, int n_legs, float p_restart,
                    const float* __restrict__ hist, const float* __restrict__ weights,
                    const float* __restrict__ hedge, float* __restrict__ term,
                    float* __restrict__ max_dd) {
  extern __shared__ __align__(16) float smem[];
  const int a_n = n_assets;
  const int w_pad = round4(n_cand);
  const DdLayout lay(t_len, a_n, w_pad, kShared);
  float* s_hist = smem + lay.hist;                       // (T, A) when kShared
  float* s_w = smem + lay.w;                             // (A, w_pad) weights
  float* s_e = smem + lay.e;                             // (A, kTileP) the step's rows
  int* s_idx = reinterpret_cast<int*>(smem + lay.idx);   // (2, kTileP) two steps' rows

  const int tid = threadIdx.x;
  if (kShared) {
    for (int i = tid; i < t_len * a_n; i += kDdThreads) s_hist[i] = hist[i];
  }
  const float* h = kShared ? s_hist : hist;
  for (int i = tid; i < a_n * w_pad; i += kDdThreads) {
    const int a = i / w_pad, w = i % w_pad;
    s_w[i] = w < n_cand ? weights[w * a_n + a] : 0.0f;
  }

  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kTileP;
  const uint32_t key = block_key(seed, first_block, b);
  // threads 0..15 walk the row indices of the tile's paths
  int idx = tid < kTileP ? jump_row(boot_call(0u, p0 + tid, key).w0, t_len) : 0;
  const int n_items = a_n * kTileP;
  float price[kItems];  // hedged: each item's price, from s0
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int item = tid + r * kDdThreads;
    price[r] = (kHedged && item < n_items) ? hedge[item / kTileP] : 0.0f;
  }
  const HedgeBlock legs(hedge, a_n, n_legs);  // hedged: the legs, read from device memory

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

  for (int s0 = 0; s0 < n_steps; s0 += 2) {
    const int n = min(2, n_steps - s0);
    if (tid < kTileP) {
      const Words w = boot_call(1u + s0 / 2, p0 + tid, key);
      idx = next_row(idx, w.w0, w.w1, t_len, p_restart);
      s_idx[tid] = idx;
      if (n > 1) {
        idx = next_row(idx, w.w2, w.w3, t_len, p_restart);
        s_idx[kTileP + tid] = idx;
      }
    }
    __syncthreads();  // also: the history and weights are in place

    for (int k = 0; k < n; ++k) {
#pragma unroll
      for (int r = 0; r < kItems; ++r) {
        const int item = tid + r * kDdThreads;
        if (item < n_items) {
          const int a = item / kTileP, pi = item % kTileP;
          const float x = row_at<kShared>(h + s_idx[k * kTileP + pi] * a_n, a);
          if (kHedged) {  // the settled return of the move P -> P·(1 + row)
            const float p_new = price[r] * (1.0f + x);
            s_e[item] = hedged_return(legs, a, price[r], p_new);
            price[r] = p_new;
          } else {
            s_e[item] = x;
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
            v[i][j] = v[i][j] * (1.0f + f[i][j]);
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

// ---- kernel #7 up to 16 assets: the redesigned layouts (narrow_dd.cuh) -----------------

constexpr int kBootThreads = 128;  // paths (and threads) per recursion block

// Where the layouts switch (ops/bootstrap.py bootstrap_narrow_plan mirrors
// it): a thread per path scores its own candidates up to kSoloMaxCand
// (kSoloMaxHedged hedged), the split layout past that. Measured on an H100 at
// 15 assets and 131,072 x 252 (tools/ab_narrow_kernels.py): solo is the
// faster up to 22 candidates unhedged (by 11% at 22) and split from 24, and
// solo up to 14 hedged (by 1-3% at 14; 2% behind split at 15, 5% at 16);
// split beat bootstrap_dd_kernel (the 17-64-asset kernel) at every W, by 12%
// at 256 (21% hedged).
constexpr int kSoloMaxCand = 22;
constexpr int kSoloMaxHedged = 14;

__host__ __device__ constexpr int narrow_layout(int n_cand, bool hedged) {
  return n_cand <= (hedged ? kSoloMaxHedged : kSoloMaxCand) ? kSolo : kSplit;
}

// The recursion part's shared memory, in floats: the (T, A) history (when
// shared), the hedge block (hedged), the solo part's weights (W, kNA); then
// per thread slices (stride kBootThreads): the prices (kNA, hedged) and the
// solo part's values, peaks and drawdowns (3 x W).
struct RecurLayout {
  int hist, h, w, p, st, total;
  __host__ __device__ RecurLayout(int t_len, int n, int n_cand, int mode, int n_legs,
                                  bool shared) {
    hist = 0;
    h = shared ? round4n(t_len * n) : 0;
    w = h + (n_legs ? round4n(hedge_floats(n, n_legs)) : 0);
    p = w + (mode == kOwn ? n_cand * kNA : 0);
    st = p + (n_legs ? kNA * kBootThreads : 0);
    total = st + (mode == kOwn ? 3 * n_cand * kBootThreads : 0);
  }
};

// The walk, a thread per path, for chunk paths 0 .. chunk-1 (path first_path
// + cp of each dispatch block): bootstrap_dd_kernel's per-path operations in
// their order — half a Philox call per step (boot_call, next_row), the row
// read from shared memory or through __ldg, hedged the price P·(1 + row) and
// the settled return. kOwn scores the thread's own candidates (narrow_dd.cuh
// solo_score), kReturns writes the rows (hedged: the settled returns) to
// rets (returns_slot).
template <bool kShared, bool kHedged, int kMode>
__global__ void __launch_bounds__(kBootThreads, 4)
bootstrap_recur_kernel(long long seed, long long first_block, int block_paths, int first_path,
                       int chunk, int t_len, int n_assets, int n_cand, int n_steps, int n_legs,
                       float p_restart, const float* __restrict__ hist,
                       const float* __restrict__ weights, const float* __restrict__ hedge,
                       float* __restrict__ rets, float* __restrict__ term,
                       float* __restrict__ max_dd) {
  constexpr int kS = kBootThreads;  // the per-thread slices' stride
  extern __shared__ __align__(16) float smem[];
  const int n = n_assets, tid = threadIdx.x, blk = blockIdx.y;
  const RecurLayout lay(t_len, n, n_cand, kMode, kHedged ? n_legs : 0, kShared);
  float* s_hist = smem + lay.hist;
  float* s_h = smem + lay.h;
  float* s_w = smem + lay.w;
  if (kShared) {
    for (int i = tid; i < t_len * n; i += kS) s_hist[i] = hist[i];
  }
  const float* h = kShared ? s_hist : hist;
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
  const int p = first_path + cp;
  const uint32_t key = block_key(seed, first_block, blk);
  const HedgeBlock legs(s_h, n, n_legs);
  float* s_p = smem + lay.p + tid;  // hedged: the prices, from s0
  float* s_st = smem + lay.st + tid;
  if (kHedged) {
    for (int a = 0; a < n; ++a) s_p[a * kS] = s_h[a];
  }
  if (kMode == kOwn) solo_start<kS>(n_cand, s_st);
  float* rg = kMode == kReturns ? returns_slot(rets, blk, chunk, cp, n_steps, n) : nullptr;
  const bool writes = cp < (chunk + kTile - 1) / kTile * kTile;  // whole tiles of the scratch
  int idx = jump_row(boot_call(0u, p, key).w0, t_len);
  for (int s0 = 0; s0 < n_steps; s0 += 2) {
    const Words wd = boot_call(1u + s0 / 2, p, key);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (s0 + k >= n_steps) continue;
      idx = k ? next_row(idx, wd.w2, wd.w3, t_len, p_restart)
              : next_row(idx, wd.w0, wd.w1, t_len, p_restart);
      const float* row = h + idx * n;
      float e[kNA];
#pragma unroll
      for (int i = 0; i < kNA; ++i) {
        e[i] = 0.0f;
        if (i < n) {
          const float x = row_at<kShared>(row, i);
          // hedged: the move P -> P·(1 + row), settled below
          e[i] = kHedged ? __fmul_rn(s_p[i * kS], __fadd_rn(1.0f, x)) : x;
        }
      }
      if (kHedged) settle_all<kS>(legs, n, s_p, e);
      if (kMode == kOwn) {
        solo_score<kHedged ? kSimpleNan : kSimple, kS>(n, n_cand, s_w, s_st, e);
      } else if (writes) {
#pragma unroll
        for (int i = 0; i < kNA; ++i) {
          if (i < n) rg[((s0 + k) * n + i) * kTile] = e[i];
        }
      }
    }
  }
  if (kMode == kOwn && cp < chunk) {
    solo_store<kS>(n_cand, blk, block_paths, p, s_st, term, max_dd);
  }
}

// Kernels #6 and #7 past 64 assets: wide.cuh's layout with the narrow
// kernels' selection and arithmetic. Thread p < tp walks tile path p's row
// index (shared memory: the current row, then the rows of the call's two
// steps), the same rows as the narrow kernels and the plain forms; every item
// reads its entry of the selected row from device memory (__ldg). State: the
// terminal's gross (bit-identical to the plain form: one add and one multiply
// per step), the hedged candidates' price, none for the unhedged candidates.
template <bool kCand, bool kHedged>
struct BootWide : WideModelBase {
  static constexpr int kState = (kCand && !kHedged) ? 0 : 1;
  static constexpr int kPer = 2;
  static constexpr int kValue = kHedged ? kWideHedged : kWideSimple;
  const float *hist, *hedge;  // the (T, A) history; the hedge block
  int t_len, n_legs;
  float p_restart;

  __host__ __device__ static int smem_floats(int, int) { return 3 * kWideTile; }
  __device__ void begin(const WideTile& t, float* s, int tid) const {
    if (tid < t.tp) reinterpret_cast<int*>(s)[tid] = jump_row(boot_call(0u, t.p0 + tid, t.key).w0,
                                                              t_len);
  }
  __device__ void start(const WideTile& t, int a, int p) const {
    if (kState) t.at(0, a, p) = kHedged ? __ldg(hedge + a) : 1.0f;
  }
  __device__ void draw(const WideTile&, float*, int, int, int, int) const {}
  __device__ void draw_path(const WideTile& t, float* s, int call, int n, int p) const {
    int* cur = reinterpret_cast<int*>(s);  // (16,) the current row
    int* idx = cur + kWideTile;            // (2, 16) the call's two steps' rows
    const Words w = boot_call(1u + call, t.p0 + p, t.key);
    int i = next_row(cur[p], w.w0, w.w1, t_len, p_restart);
    idx[p] = i;
    if (n > 1) {
      i = next_row(i, w.w2, w.w3, t_len, p_restart);
      idx[kWideTile + p] = i;
    }
    cur[p] = i;
  }
  __device__ float step(const WideTile& t, float* s, int k, int a, int p) const {
    const int row = reinterpret_cast<const int*>(s)[kWideTile + k * kWideTile + p];
    const float x = __ldg(hist + static_cast<long long>(row) * t.a_n + a);
    if (!kCand) {
      t.at(0, a, p) *= 1.0f + x;
      return 0.0f;
    }
    if (kHedged) {
      float& price = t.at(0, a, p);
      const float p_new = price * (1.0f + x);
      const float e = hedged_return(HedgeBlock(hedge, t.a_n, n_legs), a, price, p_new);
      price = p_new;
      return e;
    }
    return x;
  }
  __device__ float out(const WideTile& t, int a, int p) const { return t.at(0, a, p) - 1.0f; }
};

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

}  // namespace

extern "C" {

// Launches the terminal kernel on `stream` for blocks first_block+1 ..
// first_block+n_blocks. hist: (t_len, n_assets) float32 on the device, held in
// shared memory when in_shared (4·t_len·n_assets bytes, at most the block's
// opt-in limit), else read from device memory. Output out: (n_blocks,
// block_paths, n_assets) float32. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for arguments the kernel does not take.
int mcport_bootstrap_terminal(long long seed, long long first_block, int n_blocks,
                              int block_paths, int t_len, int n_assets, int n_steps,
                              float p_restart, int in_shared, const void* hist, void* out,
                              void* stream) {
  if (n_assets < 1 || n_assets > kMaxAssets || t_len < 1 || n_blocks < 1 ||
      n_blocks > 65535 || block_paths < 1 || n_steps < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((block_paths + kTermThreads - 1) / kTermThreads, n_blocks);
  const size_t smem = in_shared ? sizeof(float) * static_cast<size_t>(t_len) * n_assets : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* h = static_cast<const float*>(hist);
  float* o = static_cast<float*>(out);
  auto run = [&](auto kernel) {
    int err = set_smem(kernel, smem);
    if (err) return err;
    kernel<<<grid, kTermThreads, smem, s>>>(seed, first_block, block_paths, t_len, n_assets,
                                            n_steps, p_restart, h, o);
    return static_cast<int>(cudaGetLastError());
  };
  if (n_assets <= 16) {
    return in_shared ? run(bootstrap_terminal_kernel<16, 16, true>)
                     : run(bootstrap_terminal_kernel<16, 16, false>);
  }
  return in_shared ? run(bootstrap_terminal_kernel<kMaxAssets, 1, true>)
                   : run(bootstrap_terminal_kernel<kMaxAssets, 1, false>);
}

// Launches the candidate function on `stream` for blocks first_block+1 ..
// first_block+n_blocks. hist: (t_len, n_assets), weights: (n_cand, n_assets),
// float32 on the device; the history in shared memory when in_shared, else
// read from device memory. hedge: ops/hedged.py HedgeTensors.packed for
// n_legs legs per asset, or null with n_legs 0 for the unhedged mode.
// Outputs term and dd: (n_blocks, n_cand, block_paths) float32. Up to 16
// assets the layout is narrow_layout(n_cand, hedged) (layout -1), or the one
// named (0 solo, 1 split); the split layout takes its returns through scratch
// (scratch_floats floats on the device) in chunks of paths that it holds for
// every block and step (a multiple of kBootThreads paths; ops/bootstrap.py
// bootstrap_narrow_plan sizes it, and says for each layout whether its block
// holds the history), the others take no scratch (null, 0). From 17 assets
// bootstrap_dd_kernel runs (layout -1; the hedge read from device memory).
// Returns cudaGetLastError() after the last launch, or cudaErrorInvalidValue
// for arguments the kernel does not take (among them a layout whose block the
// shared memory cannot hold).
int mcport_bootstrap_multi_dd(long long seed, long long first_block, int n_blocks,
                              int block_paths, int t_len, int n_assets, int n_cand,
                              int n_steps, int n_legs, float p_restart, int in_shared,
                              const void* hist, const void* weights, const void* hedge,
                              void* term, void* dd, void* scratch, long long scratch_floats,
                              int layout, void* stream) {
  if (n_assets < 1 || n_assets > kMaxAssets || t_len < 1 || n_cand < 1 ||
      n_cand > kMaxCand || n_blocks < 1 || n_blocks > 65535 || block_paths < 1 ||
      n_steps < 0 || n_legs < 0 || (n_legs > 0 && hedge == nullptr) ||
      kMaxAssets * kTileP > kItems * kDdThreads || scratch_floats < 0 || layout < -1 ||
      layout > kSplit || (n_assets > kNA && layout >= 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static_assert(kMaxCand / 4 * score_groups(kMaxCand) <= kScoreThreads &&
                    4 * score_groups(kMaxCand) % kTile == 0 && kBootThreads % kTile == 0,
                "a scoring block covers 256 candidates of whole tiles");
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool shared = in_shared != 0;
  const float* hst = static_cast<const float*>(hist);
  const float* wts = static_cast<const float*>(weights);
  const float* hdg = static_cast<const float*>(hedge);
  float *out = static_cast<float*>(term), *out_dd = static_cast<float*>(dd);
  // one launch of `kernel` with `smem` bytes of dynamic shared memory
  auto start = [&](auto kernel, size_t smem) {
    if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
    return set_smem(kernel, smem);
  };
  if (layout < 0 && n_assets <= kNA) layout = narrow_layout(n_cand, n_legs > 0);
  if (layout < 0) {  // bootstrap_dd_kernel: 17-64 assets
    const dim3 grid((block_paths + kTileP - 1) / kTileP, n_blocks);
    const size_t smem = sizeof(float) * DdLayout(t_len, n_assets, round4(n_cand), shared).total;
    auto run = [&](auto kernel) {
      int err = start(kernel, smem);
      if (err) return err;
      kernel<<<grid, kDdThreads, smem, st>>>(seed, first_block, block_paths, t_len, n_assets,
                                             n_cand, n_steps, n_legs, p_restart, hst, wts, hdg,
                                             out, out_dd);
      return static_cast<int>(cudaGetLastError());
    };
    if (n_legs) {
      return shared ? run(bootstrap_dd_kernel<true, true>)
                    : run(bootstrap_dd_kernel<false, true>);
    }
    return shared ? run(bootstrap_dd_kernel<true, false>)
                  : run(bootstrap_dd_kernel<false, false>);
  }
  float* r = static_cast<float*>(scratch);
  // the walk over chunk paths from `first`, scoring its own candidates (kOwn)
  // or writing their rows to the scratch (kReturns)
  auto recur = [&](auto kernel, int mode, int first, int chunk) {
    const size_t smem =
        sizeof(float) * RecurLayout(t_len, n_assets, n_cand, mode, n_legs, shared).total;
    int err = start(kernel, smem);
    if (err) return err;
    const dim3 grid((chunk + kBootThreads - 1) / kBootThreads, n_blocks);
    kernel<<<grid, kBootThreads, smem, st>>>(seed, first_block, block_paths, first, chunk,
                                             t_len, n_assets, n_cand, n_steps, n_legs,
                                             p_restart, hst, wts, hdg, r, out, out_dd);
    return static_cast<int>(cudaGetLastError());
  };
  // the walk's instantiation for the history's place and the hedge: kernels
  // (shared, hedged), (shared), (hedged), ()
  auto walk = [&](auto sh_h, auto sh, auto h, auto none, int mode, int first, int chunk) {
    if (n_legs) return shared ? recur(sh_h, mode, first, chunk) : recur(h, mode, first, chunk);
    return shared ? recur(sh, mode, first, chunk) : recur(none, mode, first, chunk);
  };
  if (layout == kSolo) {
    return walk(bootstrap_recur_kernel<true, true, kOwn>, bootstrap_recur_kernel<true, false, kOwn>,
                bootstrap_recur_kernel<false, true, kOwn>,
                bootstrap_recur_kernel<false, false, kOwn>, kOwn, 0, block_paths);
  }
  // the split layout: the paths of a chunk are every path where the scratch
  // holds them all (in whole 16-path tiles), else what it holds in whole
  // recursion blocks
  const long long per_path = static_cast<long long>(n_blocks) * n_steps * n_assets;
  const long long all = (block_paths + kTile - 1) / kTile * kTile;
  long long chunk = block_paths;
  if (per_path > 0 && scratch_floats / per_path < all) {
    chunk = scratch_floats / per_path / kBootThreads * kBootThreads;
  }
  if (chunk < 1 || (per_path > 0 && r == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  const int paths = 4 * score_groups(n_cand);
  const size_t score_smem = sizeof(float) * score_floats(n_assets, n_cand);
  for (int first = 0; first < block_paths; first += static_cast<int>(chunk)) {
    const int m = static_cast<int>(chunk < block_paths - first ? chunk : block_paths - first);
    int err = n_steps == 0 ? 0
                           : walk(bootstrap_recur_kernel<true, true, kReturns>,
                                  bootstrap_recur_kernel<true, false, kReturns>,
                                  bootstrap_recur_kernel<false, true, kReturns>,
                                  bootstrap_recur_kernel<false, false, kReturns>, kReturns,
                                  first, m);
    if (err) return err;
    auto score = [&](auto kernel) {
      int e = start(kernel, score_smem);
      if (e) return e;
      const dim3 grid((m + paths - 1) / paths, n_blocks);
      kernel<<<grid, kScoreThreads, score_smem, st>>>(block_paths, first, m, n_assets, n_cand,
                                                      n_steps, wts, r, out, out_dd);
      return static_cast<int>(cudaGetLastError());
    };
    err = n_legs ? score(score_kernel<kSimpleNan>) : score(score_kernel<kSimple>);
    if (err) return err;
  }
  return 0;
}

// Both functions past 64 assets (wide.cuh's layout with the BootWide model;
// the history in device memory): n_cand 0 runs the terminal function (output
// out (n_blocks, block_paths, n_assets)), n_cand >= 1 the candidates' (hedged
// when n_legs > 0, the hedge block read from device memory; outputs out and
// dd (n_blocks, n_cand, block_paths)). scratch: WIDE_CTAS·tp·A floats on the
// device (unread by the unhedged candidates), tp paths per tile, n_ctas
// persistent CTAs. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments the layout does not take.
int mcport_bootstrap_wide(long long seed, long long first_block, int n_blocks, int block_paths,
                          int t_len, int n_assets, int n_cand, int n_steps, int n_legs,
                          float p_restart, const void* hist, const void* weights,
                          const void* hedge, void* out, void* dd, void* scratch, int tp,
                          int n_ctas, void* stream) {
  if (t_len < 1 || n_cand < 0 || n_cand > kMaxCand || n_legs < 0 ||
      (n_legs > 0 && hedge == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool cand = n_cand > 0;
  WideArgs g{seed, first_block, n_blocks, block_paths, n_assets, n_cand, n_steps, tp,
             static_cast<const float*>(weights), static_cast<float*>(scratch),
             cand ? static_cast<float*>(out) : nullptr, static_cast<float*>(dd),
             cand ? nullptr : static_cast<float*>(out)};
  auto run = [&](auto model) {
    model.hist = static_cast<const float*>(hist);
    model.hedge = static_cast<const float*>(hedge);
    model.t_len = t_len;
    model.n_legs = n_legs;
    model.p_restart = p_restart;
    return wide_launch(g, model, n_ctas, static_cast<cudaStream_t>(stream));
  };
  if (!cand) return run(BootWide<false, false>{});
  return n_legs ? run(BootWide<true, true>{}) : run(BootWide<true, false>{});
}

}  // extern "C"
