// A host stand-in for the CUDA runtime header, enough to compile the
// SIMT kernels of csrc/quantize_block.cu with g++ and run them on the CPU
// (tests/test_torch_quantize_emulated.py).
//
// One host thread per CUDA thread: cuda_stub::launch runs the grid's
// blocks one after another, each as blockDim.x threads, with threadIdx,
// blockIdx, blockDim and gridDim thread-local. __shfl_xor_sync exchanges
// through a per-warp array between two per-warp barriers, so every lane
// of a warp must reach it, as on the card with a full mask. A barrier
// that waits more than kStallSeconds (lanes that never arrive) breaks:
// the launch then reports cudaErrorLaunchFailure instead of hanging. The
// float intrinsics are plain IEEE operations (compile with
// -ffp-contract=off). A source's `kernel<<<grid, block, smem, stream>>>(
// args)` is rewritten to `cuda_stub::launch(kernel, cuda_stub::Cfg(grid,
// block, smem, stream), args)` before it is compiled. The device has
// kSms SMs and holds kBlocksPerSm blocks of any kernel, so a grid of one
// wave is small and a grid-stride loop wraps.
#pragma once

#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <chrono>
#include <condition_variable>
#include <memory>
#include <mutex>
#include <thread>
#include <tuple>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)

struct uint3 { unsigned x, y, z; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(8) float2 { float x, y; };
struct alignas(16) int4 { int x, y, z, w; };
struct alignas(4) char4 { signed char x, y, z, w; };

inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}
inline float2 make_float2(float x, float y) { return {x, y}; }

inline int min(int a, int b) { return a < b ? a : b; }
inline long long min(long long a, long long b) { return a < b ? a : b; }

inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline unsigned __float_as_uint(float x) {
  unsigned u;
  __builtin_memcpy(&u, &x, sizeof u);
  return u;
}
inline float __uint_as_float(unsigned u) {
  float x;
  __builtin_memcpy(&x, &u, sizeof x);
  return x;
}

typedef struct CUstream_st* cudaStream_t;
enum cudaError_t {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorLaunchFailure = 719,
};
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };

namespace cuda_stub {

constexpr int kSms = 2;
constexpr int kBlocksPerSm = 1;
constexpr int kStallSeconds = 20;

inline cudaError_t& last_error() {
  static cudaError_t err = cudaSuccess;
  return err;
}

// a reusable barrier of n threads that breaks after kStallSeconds
class Barrier {
 public:
  explicit Barrier(int n) : n_(n) {}
  void wait() {
    std::unique_lock<std::mutex> lock(mu_);
    if (broken_) return;
    const unsigned phase = phase_;
    if (++arrived_ == n_) {
      arrived_ = 0;
      ++phase_;
      cv_.notify_all();
      return;
    }
    if (!cv_.wait_for(lock, std::chrono::seconds(kStallSeconds),
                      [&] { return phase_ != phase || broken_; })) {
      broken_ = true;
      cv_.notify_all();
    }
  }
  bool broken() {
    std::lock_guard<std::mutex> lock(mu_);
    return broken_;
  }

 private:
  std::mutex mu_;
  std::condition_variable cv_;
  const int n_;
  int arrived_ = 0;
  unsigned phase_ = 0;
  bool broken_ = false;
};

struct Warp {
  Barrier bar{32};
  float lanes[32];
};

inline thread_local Warp* warp = nullptr;

struct Cfg {
  dim3 grid, block;
  Cfg(dim3 g, dim3 b, size_t = 0, cudaStream_t = nullptr)
      : grid(g), block(b) {}
};

}  // namespace cuda_stub

inline thread_local uint3 threadIdx, blockIdx;
inline thread_local dim3 blockDim, gridDim;

inline float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  cuda_stub::Warp* w = cuda_stub::warp;
  const unsigned lane = threadIdx.x & 31;
  w->lanes[lane] = v;
  w->bar.wait();
  const float got = w->lanes[lane ^ static_cast<unsigned>(lane_mask)];
  w->bar.wait();
  return got;
}

inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = cuda_stub::kSms;
  return cudaSuccess;
}
template <typename F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int,
                                                          size_t) {
  *n = cuda_stub::kBlocksPerSm;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() {
  const cudaError_t err = cuda_stub::last_error();
  cuda_stub::last_error() = cudaSuccess;
  return err;
}

namespace cuda_stub {

// the grid's blocks in turn, each as block.x host threads (a multiple of
// 32), the arguments converted to the kernel's parameter types
template <typename... P, typename... A>
void launch(void (*kernel)(P...), Cfg cfg, A... args) {
  const std::tuple<P...> params(static_cast<P>(args)...);
  const unsigned threads = cfg.block.x;
  for (unsigned b = 0; b < cfg.grid.x; ++b) {
    std::vector<std::unique_ptr<Warp>> warps;
    for (unsigned i = 0; i < threads / 32; ++i)
      warps.push_back(std::make_unique<Warp>());
    std::vector<std::thread> pool;
    for (unsigned t = 0; t < threads; ++t)
      pool.emplace_back([&, t, b] {
        threadIdx = {t, 0, 0};
        blockIdx = {b, 0, 0};
        blockDim = cfg.block;
        gridDim = cfg.grid;
        warp = warps[t / 32].get();
        std::apply(kernel, params);
      });
    for (std::thread& th : pool) th.join();
    for (const auto& w : warps)
      if (w->bar.broken()) last_error() = cudaErrorLaunchFailure;
  }
}

}  // namespace cuda_stub
