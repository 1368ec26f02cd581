// RWKV6 WKV recurrence for Hopper (sm_90a).
//
// Replaces rwkv_scan_pallas (src/repro/kernels/rwkv_scan.py, body
// _kernel): for each (batch b, head h), with the f32 state S (hd x hd)
// starting at zero,
//     y_t = r_t . (S_t + diag(u) k_t^T v_t)
//     S_{t+1} = diag(w_t) S_t + k_t^T v_t
// r, k, v, w (B, S, H, hd) float32 or bfloat16, contiguous; u (H, hd)
// float32. Writes y (B, S, H, hd) in the input type and the final state
// (B, H, hd, hd) in float32.
//
// Design. Column v of the state depends only on v_t[v]: the columns are
// independent. A block owns 32 columns of one (b, h) state, 4 threads per
// column: thread (column c, part p) keeps rows p, p + 4, p + 8, ... of
// column c in registers (hd / 4 floats) for the whole sequence. Time is
// walked inside the kernel (the TPU kernel's chunked grid axis becomes a
// loop, so its w = 1 padding of the last chunk has no counterpart). The
// block stages r_t, k_t and w_t (hd each) and its 32 values of v_t for a
// chunk of 2048 / hd steps in shared memory, then per step each thread
// forms its part of y_t[c] = sum_k r_k (S_kc + u_k k_k v_c) and updates
// S_kc <- w_k S_kc + k_k v_c in one loop over its rows; two shuffles add
// the four parts and part 0 writes y_t[c]. Grid (hd / 32, H, B): 320
// blocks of 128 threads at the serving path's shape (B 4, H 40, hd 64).
//
// Bound on the H100. Bytes: one read of r, k, v, w, one write of y and of
// the final state; at the path's shape (bf16, B 4, S 2048, H 40, hd 64)
// 5 x 41.9 MB + 2.6 MB = 212 MB, 0.063 ms at 3.35 TB/s. Operations: the
// function needs 5 float32 FLOP per state element and step (S <- w S +
// k v: a multiply and an FMA; r . S: an FMA), since the u bonus is rank
// one, (sum_k r_k u_k k_k) v_v, O(hd) per step: 5 B H S hd (hd + 1) =
// 6.8e9 FLOP, 0.10 ms at the 67 TFLOP/s float32 rate, so the operations
// bound it. This kernel spends a fourth FMA per element on the bonus
// (u_k k_k v_c added to S_kc before the r FMA), which keeps every thread's
// loop free of a block-wide reduction. A serial recurrence over 2048
// steps reaches neither bound: every step waits on the previous one's
// state, so the time is the steps times the latency of one step's chain
// of dependent FMAs and shuffles, which this design shortens to hd / 4
// FMAs and two shuffles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSplit = 4;                     // threads per state column
constexpr int kCols = 32;                     // state columns per block
constexpr int kThreads = kCols * kSplit;      // 128

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ w,
            const float* __restrict__ u, T* __restrict__ y,
            float* __restrict__ state_out, int S, int H) {
  constexpr int kChunk = 2048 / HD;           // steps staged at a time
  constexpr int kRows = HD / kSplit;          // state rows per thread
  __shared__ float rs[kChunk][HD], ks[kChunk][HD], ws[kChunk][HD];
  __shared__ float vs[kChunk][kCols];

  const int h = blockIdx.y, b = blockIdx.z;
  const int c_local = threadIdx.x / kSplit, part = threadIdx.x % kSplit;
  const int col = blockIdx.x * kCols + c_local;
  const long long row_stride = static_cast<long long>(H) * HD;  // per step
  const long long base = static_cast<long long>(b) * S * row_stride +
                         static_cast<long long>(h) * HD;

  float st[kRows], uu[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    st[i] = 0.0f;
    uu[i] = u[h * HD + i * kSplit + part];
  }

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int n = min(kChunk, S - t0);
    __syncthreads();  // the last chunk's reads are done
    for (int idx = threadIdx.x; idx < n * HD; idx += kThreads) {
      const int tt = idx / HD, d = idx % HD;
      const long long off = base + (t0 + tt) * row_stride + d;
      rs[tt][d] = to_f32(r[off]);
      ks[tt][d] = to_f32(k[off]);
      ws[tt][d] = to_f32(w[off]);
    }
    for (int idx = threadIdx.x; idx < n * kCols; idx += kThreads) {
      const int tt = idx / kCols, c = idx % kCols;
      vs[tt][c] = to_f32(v[base + (t0 + tt) * row_stride +
                           blockIdx.x * kCols + c]);
    }
    __syncthreads();

    for (int tt = 0; tt < n; ++tt) {
      const float vv = vs[tt][c_local];
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int kk = i * kSplit + part;
        const float kv = ks[tt][kk] * vv;
        acc = fmaf(rs[tt][kk], fmaf(uu[i], kv, st[i]), acc);
        st[i] = fmaf(ws[tt][kk], st[i], kv);
      }
      // the four parts of a column are four neighbouring lanes
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (part == 0)
        y[base + (t0 + tt) * row_stride + col] = from_f32<T>(acc);
    }
  }

  float* so = state_out + (static_cast<long long>(b) * H + h) * HD * HD;
#pragma unroll
  for (int i = 0; i < kRows; ++i) so[(i * kSplit + part) * HD + col] = st[i];
}

template <typename T, int HD>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const float* u, void* y, float* state,
                   int B, int S, int H, cudaStream_t stream) {
  const dim3 grid(HD / kCols, H, B);
  wkv6_kernel<T, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w), u,
      static_cast<T*>(y), state, S, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* r, const void* k, const void* v,
                        const void* w, const float* u, void* y, float* state,
                        int B, int S, int H, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(r, k, v, w, u, y, state, B, S, H, stream);
    case 64: return launch<T, 64>(r, k, v, w, u, y, state, B, S, H, stream);
    case 128: return launch<T, 128>(r, k, v, w, u, y, state, B, S, H, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// r, k, v, w and y (B, S, H, hd) contiguous, of one type (dtype 0:
// float32, 1: bfloat16); u (H, hd) float32; state (B, H, hd, hd) float32.
// Returns 0 or the cudaError_t of the launch. Nothing here synchronises or
// allocates.
int wkv6_forward(const void* r, const void* k, const void* v, const void* w,
                 const float* u, void* y, float* state, int dtype, int B,
                 int S, int H, int hd, int device, void* stream) {
  if (B < 0 || S < 0 || H < 0 || (dtype != 0 && dtype != 1) ||
      (hd != 32 && hd != 64 && hd != 128) || H > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || H == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = dtype == 0
            ? dispatch_hd<float>(hd, r, k, v, w, u, y, state, B, S, H, s)
            : dispatch_hd<__nv_bfloat16>(hd, r, k, v, w, u, y, state, B, S,
                                         H, s);
  return static_cast<int>(err);
}

}  // extern "C"
