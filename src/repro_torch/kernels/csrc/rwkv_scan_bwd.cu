// The RWKV6 WKV recurrence, backward, for Hopper (sm_90a).
//
// The gradient of wkv6_forward (rwkv_scan.cu), which replaces
// rwkv_scan_pallas (src/repro/kernels/rwkv_scan.py). The TPU package has
// no backward kernel: it differentiates its lax.scan with jax.grad. This
// computes that gradient. Per (batch, head), with the float32 state S_t
// (hd x hd, rows i over k's channels, columns j over v's) before step t,
// S_0 = 0, y_t = r_t . (S_t + diag(u) k_t^T v_t) and
// S_{t+1} = diag(w_t) S_t + k_t^T v_t, given dy and the final state's
// gradient dstate (or zero), with G the gradient of S_{t+1} and
// p_t = sum_i r_t[i] u[i] k_t[i], back in time from t = S - 1:
//   dk_t[i] = sum_j G[i,j] v_t[j] + r_t[i] u[i] (v_t . dy_t)
//   dv_t[j] = sum_i G[i,j] k_t[i] + p_t dy_t[j]
//   dw_t[i] = sum_j G[i,j] S_t[i,j]
//   dr_t[i] = sum_j S_t[i,j] dy_t[j] + u[i] k_t[i] (v_t . dy_t)
//   du[i]  += r_t[i] k_t[i] (v_t . dy_t)
//   G <- r_t^T dy_t + diag(w_t) G
// dr, dk, dv, dw are written in the inputs' type (float32 or bfloat16), du
// as float32 partials per (batch, head), which the caller sums over the
// batch. hd 16, 32, 64, 128.
//
// dw needs S_t while G runs backward. S_t is never recovered by dividing
// by w_t (w = exp(-exp(.)) can be tiny): a forward sweep keeps S at the
// start of every chunk of C = 2048 / hd steps in a float32 scratch (at
// rwkv6-3b's B 1, S 2048, H 40, hd 64: 64 chunk starts of 16 KB per head,
// 42 MB), and the reverse sweep recomputes each chunk's states from its
// start into a second scratch (C states per head, 21 MB), then walks the
// chunk backward.
//
// One block per (batch, head), as the forward. Every sum over a row or a
// column of the state stays inside a thread or a few neighbouring lanes:
// thread t owns W = min(hd, 32) consecutive columns of row t / (hd / W) (its
// part of S and of G, for dk, dw, dr), and the same W rows of column
// t / (hd / W) (its part of G again, for dv), so G's elements are each
// updated twice and no step needs shared memory or a barrier; the hd / W
// lanes of a row (or column) add their parts with shuffles. hd x hd / W
// threads: 16, 32, 128 and 512 at hd 16, 32, 64, 128. Each chunk's r, k, v,
// w and dy come into shared memory once, widened to float32 (40 KB at every
// hd), with v . dy and p_t per step. The recomputed states go to the
// scratch in a layout where neighbouring threads write neighbouring 16
// bytes, and each thread reads back only what it wrote.
//
// Bound on the H100: the float32 operations. Per state element and step
// the recurrence's gradient costs the recompute of S (2 flop), dk, dv, dw
// and dr (2 each) and G twice (4), 14 flop; the bytes (the five inputs and
// four gradients once, the scratch through L2) weigh less. What bounds
// this simple kernel is one block's chain of steps, as in the forward: a
// block of hd 64 keeps 4 warps on one SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
  return __float2bfloat16(x);
}

template <int HD>
struct Shape {
  static constexpr int kW = HD < 32 ? HD : 32;   // columns a thread owns
  static constexpr int kSeg = HD / kW;           // lanes per row
  static constexpr int kThreads = HD * kSeg;
  static constexpr int kChunk = 2048 / HD;       // steps per chunk
  static constexpr int kW4 = kW / 4;
  // the five staged inputs, then v . dy and p per step
  static constexpr int kSmemFloats = 5 * kChunk * HD + 2 * kChunk;
  static constexpr int kSmemBytes = kSmemFloats * 4;
};

int chunk_of(int hd) { return 2048 / hd; }

// n steps from t0 of one head of a (B, S, H, HD) tensor into dst (n x HD
// float32); base points at (b, 0, h, 0), steps are H * HD elements apart.
template <typename T, int HD, int NT>
__device__ __forceinline__ void stage(float* dst, const T* base, long long ld,
                                      int t0, int n) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerStep = HD / kVec;
  for (int idx = threadIdx.x; idx < n * kPerStep; idx += NT) {
    const int s = idx / kPerStep, e = (idx % kPerStep) * kVec;
    const uint4 raw = *reinterpret_cast<const uint4*>(
        base + static_cast<long long>(t0 + s) * ld + e);
    const T* x = reinterpret_cast<const T*>(&raw);
    float* d = dst + s * HD + e;
#pragma unroll
    for (int j = 0; j < kVec; j += 4)
      *reinterpret_cast<float4*>(d + j) =
          make_float4(to_f32(x[j]), to_f32(x[j + 1]), to_f32(x[j + 2]),
                      to_f32(x[j + 3]));
  }
}

template <int NSEG>
__device__ __forceinline__ float lanes_sum(float x) {
#pragma unroll
  for (int off = 1; off < NSEG; off <<= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(Shape<HD>::kThreads, 1)
wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ w,
                const float* __restrict__ u, const T* __restrict__ dy,
                const float* __restrict__ dstate, T* __restrict__ dr,
                T* __restrict__ dk, T* __restrict__ dv, T* __restrict__ dw,
                float* __restrict__ du_part, float4* __restrict__ scratch,
                int S, int H) {
  using SH = Shape<HD>;
  constexpr int W = SH::kW, NSEG = SH::kSeg, NT = SH::kThreads;
  constexpr int C = SH::kChunk, W4 = SH::kW4;
  extern __shared__ float smem[];
  float* rs = smem;
  float* ks = rs + C * HD;
  float* vs = ks + C * HD;
  float* ws = vs + C * HD;
  float* dys = ws + C * HD;
  float* vdy = dys + C * HD;
  float* ruk = vdy + C;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int row = tid / NSEG, seg = tid % NSEG;
  const int j0 = seg * W;
  const int n_chunks = (S + C - 1) / C;
  constexpr long long kState4 = static_cast<long long>(HD) * HD / 4;
  // chunk starts [n_chunks][W4][NT], then the chunk's states [C][W4][NT]
  float4* ck = scratch + static_cast<long long>(bh) * (n_chunks + C) * kState4;
  float4* buf = ck + static_cast<long long>(n_chunks) * kState4;

  const long long ld = static_cast<long long>(H) * HD;
  const long long head0 = static_cast<long long>(b) * S * ld +
                          static_cast<long long>(h) * HD;
  const float u_row = u[h * HD + row];

  // forward sweep: S at every chunk start
  float st[W];
#pragma unroll
  for (int jj = 0; jj < W; ++jj) st[jj] = 0.0f;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * C, n = min(C, S - t0);
    __syncthreads();
    stage<T, HD, NT>(ks, k + head0, ld, 0 + t0, n);
    stage<T, HD, NT>(vs, v + head0, ld, t0, n);
    stage<T, HD, NT>(ws, w + head0, ld, t0, n);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < W4; ++q)
      ck[(static_cast<long long>(c) * W4 + q) * NT + tid] =
          make_float4(st[4 * q], st[4 * q + 1], st[4 * q + 2], st[4 * q + 3]);
    for (int s = 0; s < n; ++s) {
      const float kk = ks[s * HD + row], ww = ws[s * HD + row];
#pragma unroll
      for (int jj = 0; jj < W; ++jj)
        st[jj] = fmaf(ww, st[jj], kk * vs[s * HD + j0 + jj]);
    }
  }

  // the gradient of the final state: rows (this thread's row, columns
  // j0 ..) and columns (this thread's column, rows j0 ..)
  float gr[W], gc[W];
  const float* dsb = dstate ? dstate + static_cast<long long>(bh) * HD * HD
                            : nullptr;
#pragma unroll
  for (int jj = 0; jj < W; ++jj) {
    gr[jj] = dsb ? dsb[row * HD + j0 + jj] : 0.0f;
    gc[jj] = dsb ? dsb[(j0 + jj) * HD + row] : 0.0f;
  }
  float du_acc = 0.0f;

  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * C, n = min(C, S - t0);
    __syncthreads();
    stage<T, HD, NT>(rs, r + head0, ld, t0, n);
    stage<T, HD, NT>(ks, k + head0, ld, t0, n);
    stage<T, HD, NT>(vs, v + head0, ld, t0, n);
    stage<T, HD, NT>(ws, w + head0, ld, t0, n);
    stage<T, HD, NT>(dys, dy + head0, ld, t0, n);
    __syncthreads();
    for (int s = tid; s < n; s += NT) {
      float a = 0.0f, p = 0.0f;
      for (int i = 0; i < HD; ++i) {
        a = fmaf(vs[s * HD + i], dys[s * HD + i], a);
        p = fmaf(rs[s * HD + i] * u[h * HD + i], ks[s * HD + i], p);
      }
      vdy[s] = a;
      ruk[s] = p;
    }
    __syncthreads();

    // the chunk's states S_t0 .. S_t0+n-1, from its start
#pragma unroll
    for (int q = 0; q < W4; ++q) {
      const float4 x = ck[(static_cast<long long>(c) * W4 + q) * NT + tid];
      st[4 * q] = x.x;
      st[4 * q + 1] = x.y;
      st[4 * q + 2] = x.z;
      st[4 * q + 3] = x.w;
    }
    for (int s = 0; s < n; ++s) {
#pragma unroll
      for (int q = 0; q < W4; ++q)
        buf[(static_cast<long long>(s) * W4 + q) * NT + tid] = make_float4(
            st[4 * q], st[4 * q + 1], st[4 * q + 2], st[4 * q + 3]);
      const float kk = ks[s * HD + row], ww = ws[s * HD + row];
#pragma unroll
      for (int jj = 0; jj < W; ++jj)
        st[jj] = fmaf(ww, st[jj], kk * vs[s * HD + j0 + jj]);
    }

    // back through the chunk; G holds the gradient of S_{t+1}
    for (int s = n - 1; s >= 0; --s) {
#pragma unroll
      for (int q = 0; q < W4; ++q) {
        const float4 x = buf[(static_cast<long long>(s) * W4 + q) * NT + tid];
        st[4 * q] = x.x;
        st[4 * q + 1] = x.y;
        st[4 * q + 2] = x.z;
        st[4 * q + 3] = x.w;
      }
      const float* rv = rs + s * HD;
      const float* kv = ks + s * HD;
      const float* vv = vs + s * HD;
      const float* wv = ws + s * HD;
      const float* gv = dys + s * HD;
      const float rr = rv[row], kk = kv[row], ww = wv[row], dyc = gv[row];
      float dkp = 0.0f, dwp = 0.0f, drp = 0.0f, dvp = 0.0f;
#pragma unroll
      for (int jj = 0; jj < W; ++jj) {
        const float dyj = gv[j0 + jj];
        dkp = fmaf(gr[jj], vv[j0 + jj], dkp);
        dwp = fmaf(gr[jj], st[jj], dwp);
        drp = fmaf(st[jj], dyj, drp);
        gr[jj] = fmaf(ww, gr[jj], rr * dyj);
        // column role: this thread's column `row`, rows j0 + jj
        dvp = fmaf(gc[jj], kv[j0 + jj], dvp);
        gc[jj] = fmaf(wv[j0 + jj], gc[jj], rv[j0 + jj] * dyc);
      }
      if constexpr (NSEG > 1) {
        dkp = lanes_sum<NSEG>(dkp);
        dwp = lanes_sum<NSEG>(dwp);
        drp = lanes_sum<NSEG>(drp);
        dvp = lanes_sum<NSEG>(dvp);
      }
      if (seg == 0) {
        const long long at = head0 + static_cast<long long>(t0 + s) * ld + row;
        const float vd = vdy[s];
        dk[at] = from_f32<T>(dkp + rr * u_row * vd);
        dr[at] = from_f32<T>(drp + u_row * kk * vd);
        dw[at] = from_f32<T>(dwp);
        dv[at] = from_f32<T>(dvp + ruk[s] * dyc);
        du_acc = fmaf(rr * kk, vd, du_acc);
      }
    }
  }
  if (seg == 0) du_part[static_cast<long long>(bh) * HD + row] = du_acc;
}

template <typename T, int HD>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const float* u, const void* dy,
                   const float* dstate, void* dr, void* dk, void* dv,
                   void* dw, float* du_part, float* scratch, int B, int S,
                   int H, cudaStream_t stream) {
  using SH = Shape<HD>;
  auto kernel = wkv6_bwd_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SH::kSmemBytes);
  if (err != cudaSuccess) return err;
  kernel<<<B * H, SH::kThreads, SH::kSmemBytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w), u,
      static_cast<const T*>(dy), dstate, static_cast<T*>(dr),
      static_cast<T*>(dk), static_cast<T*>(dv), static_cast<T*>(dw), du_part,
      reinterpret_cast<float4*>(scratch), S, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* r, const void* k, const void* v,
                        const void* w, const float* u, const void* dy,
                        const float* dstate, void* dr, void* dk, void* dv,
                        void* dw, float* du_part, float* scratch, int B,
                        int S, int H, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, 16>(r, k, v, w, u, dy, dstate, dr, dk, dv, dw, du_part,
                           scratch, B, S, H, stream);
    case 32:
      return launch<T, 32>(r, k, v, w, u, dy, dstate, dr, dk, dv, dw, du_part,
                           scratch, B, S, H, stream);
    case 64:
      return launch<T, 64>(r, k, v, w, u, dy, dstate, dr, dk, dv, dw, du_part,
                           scratch, B, S, H, stream);
    case 128:
      return launch<T, 128>(r, k, v, w, u, dy, dstate, dr, dk, dv, dw,
                            du_part, scratch, B, S, H, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The float32 scratch a launch of wkv6_backward needs, in elements, into
// *floats: per (batch, head) the state at each chunk start and one chunk's
// states. cudaErrorInvalidValue for an hd it does not take.
int wkv6_backward_scratch(int B, int S, int H, int hd, long long* floats) {
  if (hd != 16 && hd != 32 && hd != 64 && hd != 128) return cudaErrorInvalidValue;
  const long long C = chunk_of(hd);
  const long long n_chunks = (S + C - 1) / C;
  *floats = static_cast<long long>(B) * H * (n_chunks + C) * hd * hd;
  return 0;
}

// r, k, v, w, dy, dr, dk, dv, dw (B, S, H, hd) contiguous, of one type
// (dtype 0: float32, 1: bfloat16), 16-byte aligned; u (H, hd) float32;
// dstate (B, H, hd, hd) float32 or null (zero); du_part (B, H, hd) float32;
// scratch: wkv6_backward_scratch's floats, 16-byte aligned. Returns 0 or
// the cudaError_t of the launch. Nothing here synchronises or allocates.
int wkv6_backward(const void* r, const void* k, const void* v, const void* w,
                  const float* u, const void* dy, const float* dstate,
                  void* dr, void* dk, void* dv, void* dw, float* du_part,
                  float* scratch, int dtype, int B, int S, int H, int hd,
                  int device, void* stream) {
  if (B < 0 || S < 0 || H <= 0 || (dtype != 0 && dtype != 1) ||
      (hd != 16 && hd != 32 && hd != 64 && hd != 128))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(dispatch_hd<float>(hd, r, k, v, w, u, dy, dstate,
                                               dr, dk, dv, dw, du_part,
                                               scratch, B, S, H, s));
  return static_cast<int>(dispatch_hd<__nv_bfloat16>(
      hd, r, k, v, w, u, dy, dstate, dr, dk, dv, dw, du_part, scratch, B, S,
      H, s));
}

// The dynamic shared memory of a launch at head dim hd, or -1.
int wkv6_backward_smem_bytes(int hd) {
  switch (hd) {
    case 16:
      return Shape<16>::kSmemBytes;
    case 32:
      return Shape<32>::kSmemBytes;
    case 64:
      return Shape<64>::kSmemBytes;
    case 128:
      return Shape<128>::kSmemBytes;
    default:
      return -1;
  }
}

}  // extern "C"
