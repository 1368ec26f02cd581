// RWKV6 WKV recurrence for Hopper (sm_90a).
//
// Replaces rwkv_scan_pallas (src/repro/kernels/rwkv_scan.py, body
// _kernel): for each (batch b, head h), with the f32 state S (hd x hd)
// starting at zero,
//     y_t = r_t . (S_t + diag(u) k_t^T v_t)
//     S_{t+1} = diag(w_t) S_t + k_t^T v_t
// r, k, v, w (B, S, H, hd) float32 or bfloat16, contiguous; u (H, hd)
// float32. Writes y (B, S, H, hd) in the input type and the final state
// (B, H, hd, hd) in float32. hd 16, 32, 64 or 128.
//
// Bound on the H100. Bytes: one read of r, k, v, w, one write of y and of
// the final state; at the serving path's shape (bf16, B 4, S 2048, H 40,
// hd 64) 5 x 41.9 MB + 2.6 MB = 212 MB, 0.063 ms at 3.35 TB/s. Operations:
// the function needs 5 float32 FLOP per state element and step (S <- w S +
// k v: a multiply and an FMA; r . S: an FMA) plus the u bonus, which is
// rank one: y_c = sum_k r_k S_kc + p v_c with p = sum_k r_k u_k k_k. That
// is 5 B H S hd (hd + 1) = 6.8e9 FLOP, 0.10 ms at the 67 TFLOP/s float32
// rate: the operations bound it, and no tensor core helps a recurrence
// that applies one rank-one update per step.
//
// Design. The recurrence is applied step by step, in order; only the order
// of the sum for y differs from the reference. Per state element and step
// the kernel spends 3 FP32 instructions and about 0.4 shared loads, and it
// stages the next chunk while computing this one:
//  - A register tile. A thread owns kRows consecutive rows x kCols
//    consecutive columns of one (b, h) state for the whole sequence (16 x 2
//    at hd 64). Per step it reads its rows of r, k and w as 16-byte shared
//    loads (3 kRows / 4 of them) and its kCols values of v in one load,
//    broadcast to the lanes of its row group, and spends 3 FP32
//    instructions per element: kv = k v, S = fma(w, S, kv), and
//    acc = fma(r, S_old, acc) in two accumulators per column.
//  - The bonus as rank one: p_t is formed once per step for the block in
//    the staging pass, and row group 0 adds p_t v_c to its part of y_c.
//  - No shuffles in the step loop: each thread leaves its kCols parts of
//    y in shared memory, and the next chunk's staging pass sums the
//    hd / kRows parts of each output in row-group order and writes y.
//  - Asynchronous staging. A block owns hd / kSplit columns of one head;
//    it brings chunks of 2048 / hd steps of r, k, w (hd each) and its
//    columns of v into shared memory with 16-byte cp.async.cg, two stages,
//    the next chunk in flight while this one is computed. One pass over a
//    landed chunk widens bf16 to f32 (once per element per block; float32
//    is read where it lands) and forms p_t, four steps per warp at a time.
//    Step t + 1's operands are loaded while step t computes.
// Three barriers per chunk, none inside a chunk's steps. At the path's
// shape the grid is 160 blocks of 4 warps, 98 KB of shared memory each.
// What bounds it (on the H100, PERF.md): one 16 x 2 block alone on an SM
// takes 0.375 ms at the path's S, its chain of steps, and the 28 SMs that
// hold two of the 160 blocks take 1.41 times that. A smaller unit is
// faster alone (8 x 2 in two blocks per head: 0.275 ms) but its 320
// blocks of 90 KB fit two per SM, not three, and run in two waves.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// rows and columns of the state per thread, blocks per head
template <int HD> struct Tile;
template <> struct Tile<16> {
  static constexpr int kRows = 8, kCols = 1, kSplit = 1;
};
template <> struct Tile<32> {
  static constexpr int kRows = 16, kCols = 2, kSplit = 1;
};
template <> struct Tile<64> {
  static constexpr int kRows = 16, kCols = 2, kSplit = 1;
};
template <> struct Tile<128> {
  static constexpr int kRows = 16, kCols = 2, kSplit = 2;
};

template <typename T, int HD>
struct Cfg {
  static constexpr int R = Tile<HD>::kRows, CC = Tile<HD>::kCols;
  static constexpr int G = HD / R;              // row groups
  static constexpr int COLS = HD / Tile<HD>::kSplit;  // columns per block
  static constexpr int SETS = COLS / CC;        // column sets per block
  static constexpr int THREADS = G * SETS;
  static constexpr int LANES = 32 / G;          // column sets per warp
  static constexpr int CHUNK = 2048 / HD;       // steps staged at a time
  static constexpr int VEC = 16 / sizeof(T);    // elements per 16 bytes
  static constexpr int RW = CHUNK * HD;         // one of r, k, w per stage
  static constexpr int IN = 3 * RW + CHUNK * COLS;  // r, k, w, v per stage
  static constexpr bool WIDEN = !std::is_same<T, float>::value;
  // shared memory: two stages as they land, their f32 copy (bf16 only),
  // p for each step, each thread's parts of y for each step
  static constexpr int STAGE_BYTES = IN * sizeof(T);
  static constexpr int F32_OFF = 2 * STAGE_BYTES;
  static constexpr int P_OFF = F32_OFF + (WIDEN ? IN * 4 : 0);
  static constexpr int PART_OFF = P_OFF + CHUNK * 4;
  static constexpr int SMEM = PART_OFF + CHUNK * THREADS * CC * 4;
  static_assert(R % 4 == 0 && HD % R == 0 && 32 % G == 0, "tile");
  static_assert(THREADS % 32 == 0 && COLS % VEC == 0, "tile");
  static_assert(CC == 1 || CC == 2 || CC == 4, "columns per thread");
  static_assert(STAGE_BYTES % 16 == 0 && P_OFF % 16 == 0 &&
                PART_OFF % 16 == 0, "16-byte alignment");
};

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

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// 8 bf16 -> 8 f32 (a bf16 is the high half of its f32), 16 bytes in
__device__ __forceinline__ void widen8(const __nv_bfloat16* src, float* dst) {
  const uint4 q = *reinterpret_cast<const uint4*>(src);
  float4* d = reinterpret_cast<float4*>(dst);
  d[0] = make_float4(__uint_as_float(q.x << 16),
                     __uint_as_float(q.x & 0xffff0000u),
                     __uint_as_float(q.y << 16),
                     __uint_as_float(q.y & 0xffff0000u));
  d[1] = make_float4(__uint_as_float(q.z << 16),
                     __uint_as_float(q.z & 0xffff0000u),
                     __uint_as_float(q.w << 16),
                     __uint_as_float(q.w & 0xffff0000u));
}

// four floats from 16-byte aligned shared memory into registers
__device__ __forceinline__ void put4(float* dst, const float* src) {
  const float4 q = *reinterpret_cast<const float4*>(src);
  dst[0] = q.x;
  dst[1] = q.y;
  dst[2] = q.z;
  dst[3] = q.w;
}

// n = 1, 2 or 4 floats from registers to (n * 4)-byte aligned memory
template <int N>
__device__ __forceinline__ void store(float* dst, const float (&x)[N]) {
  if constexpr (N == 4)
    *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
  else if constexpr (N == 2)
    *reinterpret_cast<float2*>(dst) = make_float2(x[0], x[1]);
  else
    dst[0] = x[0];
}

// one thread's operands of one step
template <int R, int CC>
struct Ops {
  float r[R], k[R], w[R], v[CC], p;
};

template <typename T, int HD>
__global__ void __launch_bounds__((Cfg<T, HD>::THREADS))
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ w,
            const float* __restrict__ u, T* __restrict__ y,
            float* __restrict__ state_out, int S, int H) {
  using C = Cfg<T, HD>;
  constexpr int R = C::R, CC = C::CC, CHUNK = C::CHUNK, COLS = C::COLS;
  constexpr int VEC = C::VEC, RW = C::RW, NT = C::THREADS;
  constexpr int NU = HD < 32 ? 1 : HD / 32;     // u values per lane for p
  extern __shared__ __align__(16) unsigned char smem[];
  auto stage = [&](int c) {  // chunk c's stage as it lands
    return reinterpret_cast<T*>(smem + (c & 1) * C::STAGE_BYTES);
  };
  float* wide = reinterpret_cast<float*>(smem + C::F32_OFF);
  float* ps = reinterpret_cast<float*>(smem + C::P_OFF);
  float* part = reinterpret_cast<float*>(smem + C::PART_OFF);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / C::LANES;                       // row group
  const int set = warp * C::LANES + lane % C::LANES;   // column set
  const int col0 = blockIdx.x * COLS;                  // block's columns
  const int h = blockIdx.y, b = blockIdx.z;
  const long long rs = static_cast<long long>(H) * HD;  // per step
  const long long base = static_cast<long long>(b) * S * rs +
                         static_cast<long long>(h) * HD;
  const int n_chunks = (S + CHUNK - 1) / CHUNK;

  float uu[NU];
#pragma unroll
  for (int j = 0; j < NU; ++j) {
    const int kk = lane + 32 * j;
    uu[j] = kk < HD ? u[h * HD + kk] : 0.0f;
  }
  float st[R][CC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < CC; ++c) st[i][c] = 0.0f;

  // chunk c's r, k, w rows and the block's v columns into stage c % 2
  auto issue = [&](int c) {
    const int t0 = c * CHUNK, n = min(CHUNK, S - t0);
    T* dst = stage(c);
    constexpr int RV = HD / VEC, VV = COLS / VEC;
    for (int i = tid; i < n * RV; i += NT) {
      const int t = i / RV, j = (i % RV) * VEC;
      const long long off = base + (t0 + t) * rs + j;
      cp16(dst + t * HD + j, r + off);
      cp16(dst + RW + t * HD + j, k + off);
      cp16(dst + 2 * RW + t * HD + j, w + off);
    }
    for (int i = tid; i < n * VV; i += NT) {
      const int t = i / VV, j = (i % VV) * VEC;
      cp16(dst + 3 * RW + t * COLS + j, v + base + (t0 + t) * rs + col0 + j);
    }
  };
  // chunk c's y: each output sums the hd / kRows parts its column's row
  // groups left in shared memory (row group 0's holds the bonus)
  auto write_y = [&](int c) {
    const int t0 = c * CHUNK, n = min(CHUNK, S - t0);
    for (int i = tid; i < n * COLS; i += NT) {
      const int t = i / COLS, col = i % COLS, set = col / CC;
      const float* pt = part + (t * NT + (set / C::LANES) * 32 +
                                set % C::LANES) * CC + col % CC;
      float acc = pt[0];
#pragma unroll
      for (int gg = 1; gg < C::G; ++gg) acc += pt[gg * C::LANES * CC];
      y[base + (t0 + t) * rs + col0 + col] = from_f32<T>(acc);
    }
  };

  if (n_chunks > 0) issue(0);
  asm volatile("cp.async.commit_group;\n" ::);

  for (int c = 0; c < n_chunks; ++c) {
    const int n = min(CHUNK, S - c * CHUNK);
    __syncthreads();  // every thread is done with chunk c - 1's stage
    if (c + 1 < n_chunks) issue(c + 1);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);  // chunk c has landed
    __syncthreads();

    const T* raw = stage(c);
    if constexpr (C::WIDEN) {
      for (int i = tid * 8; i < 3 * RW; i += NT * 8) {
        if (i % RW < n * HD) widen8(raw + i, wide + i);
      }
      for (int i = tid * 8; i < n * COLS; i += NT * 8)
        widen8(raw + 3 * RW + i, wide + 3 * RW + i);
    }
    // p_t = sum_k r_k u_k k_k: a warp per step, lanes over k; four steps
    // at a time, so that their shuffles overlap
    constexpr int NW = NT / 32;
    for (int t1 = warp; t1 < n; t1 += 4 * NW) {
      float acc[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int t = min(t1 + q * NW, n - 1);
        acc[q] = 0.0f;
#pragma unroll
        for (int j = 0; j < NU; ++j) {
          const int kk = lane + 32 * j;
          if (kk < HD)
            acc[q] = fmaf(to_f32(raw[t * HD + kk]) * uu[j],
                          to_f32(raw[RW + t * HD + kk]), acc[q]);
        }
      }
#pragma unroll
      for (int m = 16; m > 0; m >>= 1)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[q] += __shfl_xor_sync(kFull, acc[q], m);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (lane == 0 && t1 + q * NW < n) ps[t1 + q * NW] = acc[q];
    }
    if (c > 0) write_y(c - 1);
    __syncthreads();

    const float* f = C::WIDEN ? wide : reinterpret_cast<const float*>(raw);
    auto load = [&](int t, Ops<R, CC>& o) {
      const float* rr = f + t * HD + g * R;
#pragma unroll
      for (int i = 0; i < R; i += 4) {
        put4(o.r + i, rr + i);
        put4(o.k + i, rr + RW + i);
        put4(o.w + i, rr + 2 * RW + i);
      }
      const float* vv = f + 3 * RW + t * COLS + set * CC;
      if constexpr (CC == 4) {
        put4(o.v, vv);
      } else if constexpr (CC == 2) {
        const float2 q = *reinterpret_cast<const float2*>(vv);
        o.v[0] = q.x;
        o.v[1] = q.y;
      } else {
        o.v[0] = vv[0];
      }
      o.p = ps[t];
    };
    auto step = [&](int t, const Ops<R, CC>& o) {
      float a[CC][2];
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) a[cc][0] = a[cc][1] = 0.0f;
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int cc = 0; cc < CC; ++cc) {
          a[cc][i & 1] = fmaf(o.r[i], st[i][cc], a[cc][i & 1]);
          st[i][cc] = fmaf(o.w[i], st[i][cc], o.k[i] * o.v[cc]);
        }
      // this row group's part of y_c; row group 0 adds the bonus p v_c
      const float pg = g == 0 ? o.p : 0.0f;
      float q[CC];
#pragma unroll
      for (int cc = 0; cc < CC; ++cc)
        q[cc] = fmaf(pg, o.v[cc], a[cc][0] + a[cc][1]);
      store(part + (t * NT + tid) * CC, q);
    };

    // two operand sets in turn: step t + 1's loads are issued before
    // step t computes
    Ops<R, CC> o0, o1;
    load(0, o0);
    for (int t = 0; t < n; t += 2) {
      load(min(t + 1, n - 1), o1);
      step(t, o0);
      if (t + 1 < n) {
        load(min(t + 2, n - 1), o0);
        step(t + 1, o1);
      }
    }
  }
  __syncthreads();
  if (n_chunks > 0) write_y(n_chunks - 1);

  float* so = state_out + (static_cast<long long>(b) * H + h) * HD * HD +
              col0 + set * CC;
#pragma unroll
  for (int i = 0; i < R; ++i) store(so + (g * R + i) * HD, st[i]);
}

template <typename T, int HD>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const float* u, void* y, float* state,
                   int B, int S, int H, cudaStream_t stream) {
  using C = Cfg<T, HD>;
  auto kernel = wkv6_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(Tile<HD>::kSplit, H, B);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(
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
    case 16: return launch<T, 16>(r, k, v, w, u, y, state, B, S, H, stream);
    case 32: return launch<T, 32>(r, k, v, w, u, y, state, B, S, H, stream);
    case 64: return launch<T, 64>(r, k, v, w, u, y, state, B, S, H, stream);
    case 128: return launch<T, 128>(r, k, v, w, u, y, state, B, S, H, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// r, k, v, w and y (B, S, H, hd) contiguous and 16-byte aligned, of one
// type (dtype 0: float32, 1: bfloat16); u (H, hd) float32; state
// (B, H, hd, hd) float32. Returns 0 or the cudaError_t of the launch.
// Nothing here synchronises or allocates.
int wkv6_forward(const void* r, const void* k, const void* v, const void* w,
                 const float* u, void* y, float* state, int dtype, int B,
                 int S, int H, int hd, int device, void* stream) {
  if (B < 0 || S < 0 || H < 0 || (dtype != 0 && dtype != 1) ||
      (hd != 16 && hd != 32 && hd != 64 && hd != 128) || H > 65535 ||
      B > 65535)
    return cudaErrorInvalidValue;
  for (const void* p : {r, k, v, w, static_cast<const void*>(y)})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return cudaErrorMisalignedAddress;
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

// The dynamic shared memory one launch asks for (dtype as above), or -1.
int wkv6_smem_bytes(int dtype, int hd) {
  if (dtype != 0 && dtype != 1) return -1;
  switch (hd * 2 + (dtype == 1)) {
    case 32: return Cfg<float, 16>::SMEM;
    case 33: return Cfg<__nv_bfloat16, 16>::SMEM;
    case 64: return Cfg<float, 32>::SMEM;
    case 65: return Cfg<__nv_bfloat16, 32>::SMEM;
    case 128: return Cfg<float, 64>::SMEM;
    case 129: return Cfg<__nv_bfloat16, 64>::SMEM;
    case 256: return Cfg<float, 128>::SMEM;
    case 257: return Cfg<__nv_bfloat16, 128>::SMEM;
    default: return -1;
  }
}

}  // extern "C"
