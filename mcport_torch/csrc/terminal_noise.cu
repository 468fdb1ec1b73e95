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
// Random bits and draws: gbm_draws.cuh, shared with path_stats.cu and
// multi_dd.cu, which read the same shock for the same (block, path, asset,
// step).
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
// Past 64 assets, terminal_noise_wide_kernel (below): the sums in a
// device-memory scratch and L read from device memory.
//
// nvcc contracts a*b+c into FMA where the torch form rounds twice, so kernel
// and plain form agree to ulps, not bits (bound: ops/gbm.py kernel_tolerance).

#include "gbm_draws.cuh"
#include "wide.cuh"

namespace {

constexpr int kThreads = 128;  // 4·(A² + kThreads·A) bytes ≤ 48 KB of shared memory
                               // at kMaxAssets

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
  const uint32_t key = block_key(seed, first_block, b);
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

// The same function past 64 assets, where L (A² floats) and the sums of a
// block (A·128) no longer fit a block's shared memory: each thread's sums go
// to its column of a device-memory scratch (asset a at a·n_threads, so a
// warp's stores and loads coalesce), and L is read from device memory through
// the read-only cache. The grid is WIDE_CTAS persistent CTAs (wide.cuh), each
// thread walking paths n_threads apart, so the scratch is A·WIDE_CTAS·128
// floats whatever the path count. The draws, the sums and L·Σz are the narrow
// kernel's, operation for operation.
template <int kTier>
__global__ void __launch_bounds__(kThreads)
terminal_noise_wide_kernel(long long seed, long long first_block, int n_blocks, int block_paths,
                           int n_assets, int n_steps, float df, float neg2_over_df,
                           const float* __restrict__ chol, float* __restrict__ scratch,
                           float* __restrict__ out) {
  const long long n_threads = static_cast<long long>(gridDim.x) * kThreads;
  const long long gt = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  float* sums = scratch + gt;  // this thread's sums: asset a at a·n_threads
  const int n_pairs = n_steps / 2;
  const int total = n_pairs + (n_steps & 1);
  const long long n_paths = static_cast<long long>(n_blocks) * block_paths;
  for (long long i = gt; i < n_paths; i += n_threads) {
    const int b = static_cast<int>(i / block_paths), p = static_cast<int>(i % block_paths);
    const uint32_t key = block_key(seed, first_block, b);
    for (int a = 0; a < n_assets; ++a) {
      float acc = 0.0f;
      if (kTier == kStudentT) {
        for (int c = 0; c < total; ++c) {
          const Words w = philox4x32_10(c, a, p, kStreamGbm, key, 0u);
          const float t1 = t_draw(bits_to_unit(w.w0), bits_to_unit(w.w1), df, neg2_over_df);
          if (c < n_pairs) {
            acc = acc + (t1 + t_draw(bits_to_unit(w.w2), bits_to_unit(w.w3), df, neg2_over_df));
          } else {
            acc = acc + t1;
          }
        }
      } else {
        constexpr bool kFast = kTier == kPolyFast;
        for (int c = 0; c < total; c += 2) {
          const Words w = philox4x32_10(c / 2, a, p, kStreamGbm, key, 0u);
          float z1, z2;
          boxmuller<kFast>(bits_to_unit(w.w0), bits_to_unit(w.w1), &z1, &z2);
          acc = (c < n_pairs) ? acc + (z1 + z2) : acc + z1;
          if (c + 1 < total) {
            boxmuller<kFast>(bits_to_unit(w.w2), bits_to_unit(w.w3), &z1, &z2);
            acc = (c + 1 < n_pairs) ? acc + (z1 + z2) : acc + z1;
          }
        }
      }
      sums[a * n_threads] = acc;
    }
    float* row = out + i * n_assets;
    for (int r = 0; r < n_assets; ++r) {
      const float* l = chol + static_cast<long long>(r) * n_assets;
      float s = 0.0f;
      for (int j = 0; j < n_assets; ++j) s += __ldg(l + j) * sums[j * n_threads];
      row[r] = s;
    }
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

// The same function past 64 assets (terminal_noise_wide_kernel): the
// arguments of mcport_terminal_noise, plus scratch (n_assets·n_ctas·128
// floats on the device) and n_ctas persistent CTAs. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for arguments
// the kernel does not take.
int mcport_terminal_noise_wide(long long seed, long long first_block, int n_blocks,
                               int block_paths, int n_assets, int n_steps, int tier, float df,
                               float neg2_over_df, const void* chol, void* scratch, int n_ctas,
                               void* out, void* stream) {
  if (n_assets < 1 || n_blocks < 1 || n_blocks > 65535 || block_paths < 1 || n_steps < 0 ||
      n_ctas < 1 || n_ctas > 65535 || scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(chol);
  float* sc = static_cast<float*>(scratch);
  float* o = static_cast<float*>(out);
  switch (tier) {
    case kPoly:
      terminal_noise_wide_kernel<kPoly><<<n_ctas, kThreads, 0, s>>>(
          seed, first_block, n_blocks, block_paths, n_assets, n_steps, df, neg2_over_df, l, sc,
          o);
      break;
    case kPolyFast:
      terminal_noise_wide_kernel<kPolyFast><<<n_ctas, kThreads, 0, s>>>(
          seed, first_block, n_blocks, block_paths, n_assets, n_steps, df, neg2_over_df, l, sc,
          o);
      break;
    case kStudentT:
      terminal_noise_wide_kernel<kStudentT><<<n_ctas, kThreads, 0, s>>>(
          seed, first_block, n_blocks, block_paths, n_assets, n_steps, df, neg2_over_df, l, sc,
          o);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
