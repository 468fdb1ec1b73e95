// Host emulation of the few CUDA features the kernel sources use, for
// checking their logic on a machine without nvcc or a card (tools/cuda_emu/
// dcc_ab.py, narrow_ab.py): each CUDA thread of a block is a std::thread,
// __syncthreads, __syncthreads_or, __syncwarp and named barriers are
// std::barriers, __shfl_sync an exchange
// through a per-warp buffer between two warp barriers, a launch runs its
// blocks one after the other. The arithmetic is the host's IEEE float32 without
// contraction (g++ -ffp-contract=off): nvcc contracts a*b+c where the
// source leaves it free, so the emulated bits equal the card's only where
// the source rounds explicitly; two trees' emulated outputs compare like for
// like. fmaf and __fmaf_rn are the C library's correctly rounded fused
// multiply-add;
// __frsqrt_rn is the float64 reciprocal square root rounded to float32;
// expm1f may return its argument (g_emu_log_sum, below).
#pragma once
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) alignas(n)
#define __shared__

struct dim3 { unsigned x = 1, y = 1, z = 1; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8, cudaDevAttrMultiProcessorCount = 16 };

struct Block {
  std::barrier<> all;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  std::mutex mu;
  std::map<int, std::unique_ptr<std::barrier<>>> named;
  std::vector<float> smem;
  std::vector<uint64_t> shfl;  // __shfl_sync's exchange: one word per thread
  std::atomic<int> vote{0};    // __syncthreads_or's
  explicit Block(int n, size_t bytes) : all(n), smem(bytes / 4 + 16), shfl(n) {
    for (int w = 0; w < n / 32; ++w) warps.emplace_back(new std::barrier<>(32));
  }
};
inline thread_local dim3 threadIdx, blockIdx, gridDim, blockDim;
inline thread_local Block* tl_block = nullptr;
inline thread_local float* g_smem = nullptr;

inline void __syncthreads() { tl_block->all.arrive_and_wait(); }
// A barrier that returns whether any thread of the block passed a nonzero p.
inline int __syncthreads_or(int p) {
  if (threadIdx.x == 0) tl_block->vote.store(0);
  tl_block->all.arrive_and_wait();
  if (p) tl_block->vote.store(1);
  tl_block->all.arrive_and_wait();
  const int any = tl_block->vote.load();
  tl_block->all.arrive_and_wait();
  return any;
}
inline void __syncwarp(unsigned = 0xffffffffu) { tl_block->warps[threadIdx.x / 32]->arrive_and_wait(); }
inline void shim_bar(int id, int count) {
  std::barrier<>* b;
  {
    std::lock_guard<std::mutex> g(tl_block->mu);
    int key = id * 100000 + static_cast<int>(threadIdx.x) / count;
    auto& p = tl_block->named[key];
    if (!p) p.reset(new std::barrier<>(count));
    b = p.get();
  }
  b->arrive_and_wait();
}
// Every lane of the warp posts its value, then reads lane src of its segment
// of `width` lanes; the whole warp takes part (the kernels shuffle with a full
// mask from converged code).
template <class T> T __shfl_sync(unsigned, T v, int src, int width = 32) {
  static_assert(sizeof(T) <= sizeof(uint64_t), "a shuffled value fits a word");
  const int t = static_cast<int>(threadIdx.x), lane = t % 32;
  uint64_t word = 0;
  std::memcpy(&word, &v, sizeof(T));
  tl_block->shfl[t] = word;
  __syncwarp();
  const int from = t - lane + (lane / width) * width + (src % width);
  std::memcpy(&v, &tl_block->shfl[from], sizeof(T));
  __syncwarp();
  return v;
}

// expm1f, the Heston terminal kernels' last operation: the C library's, or
// the path's log sum itself where a launch asks for it (g_emu_log_sum), so
// that a test can hold the path state to the plain form's bit for bit.
inline bool g_emu_log_sum = false;
inline float emu_expm1f(float x) { return g_emu_log_sum ? x : expm1f(x); }
#define expm1f emu_expm1f

inline float __frsqrt_rn(float x) { return static_cast<float>(1.0 / std::sqrt(static_cast<double>(x))); }
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
inline float __fsqrt_rn(float x) { return std::sqrt(x); }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline uint32_t __float_as_uint(float f) { uint32_t u; std::memcpy(&u, &f, 4); return u; }
inline float __uint_as_float(uint32_t u) { float f; std::memcpy(&f, &u, 4); return f; }
inline float __int_as_float(int u) { float f; std::memcpy(&f, &u, 4); return f; }
inline uint32_t __umulhi(uint32_t a, uint32_t b) { return static_cast<uint32_t>((uint64_t(a) * b) >> 32); }
inline float __uint2float_rn(uint32_t u) { return static_cast<float>(u); }
template <class T> T __ldg(const T* p) { return *p; }
using std::fmaf; using std::fmaxf; using std::fminf;
inline int min(int a, int b) { return a < b ? a : b; }

template <class K> cudaError_t cudaFuncSetAttribute(K, int, int) { return 0; }
template <class K> cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) { *n = 1; return 0; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline int g_sms = 3;
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) { *v = g_sms; return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }

template <class K, class... A>
void shim_launch(K kernel, dim3 grid, dim3 block, size_t smem, cudaStream_t, A... args) {
  for (unsigned by = 0; by < grid.y; ++by) {
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      Block b(static_cast<int>(block.x), smem);
      std::vector<std::thread> ts;
      for (unsigned t = 0; t < block.x; ++t) {
        ts.emplace_back([&, t] {
          threadIdx = dim3(t); blockIdx = dim3(bx, by); gridDim = grid; blockDim = block;
          tl_block = &b; g_smem = b.smem.data();
          kernel(args...);
        });
      }
      for (auto& th : ts) th.join();
    }
  }
}
