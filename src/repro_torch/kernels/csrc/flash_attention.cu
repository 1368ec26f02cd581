// GQA flash attention, forward, for Hopper (sm_90a).
//
// Replaces flash_attention_pallas (src/repro/kernels/flash_attention.py,
// body _kernel): out = softmax(q k^T / sqrt(hd) + mask) v for q
// (B, Sq, H, hd) and k, v (B, Sk, KV, hd), query head h reading KV head
// h / (H / KV); the masks are built from positions, as the TPU kernel
// builds them: key j < Sk, causal j <= i, window j > i - window. Inputs
// are float32 or bfloat16; every product and sum runs in float32 and the
// output is written in the input type.
//
// Design. One block per (query tile of 64 rows, head, batch); the TPU
// kernel's sequential KV grid axis becomes a loop inside the block, so the
// running max m, sum l and the float32 accumulator never leave the chip
// (registers). Per KV tile of 64 keys the block stages K and V in shared
// memory (as float32), forms the 64 x 64 scores, updates the online
// softmax, stages P in shared memory (over K's tile, which is no longer
// read) and adds P V. 256 threads as 16 x 16: thread (ty, tx) owns query
// rows 4 ty .. 4 ty + 3, score columns tx + 16 j (j < 4) and accumulator
// columns tx + 16 c (c < hd / 16). Rows of Q and K are padded by 4 floats,
// so the float4 reads along hd of 8 consecutive rows fall in distinct
// banks. KV tiles that the causal or window mask empties for every row of
// the query tile are skipped; inside a live tile masked scores are -1e30,
// as in the TPU kernel, and the first tile with a valid key clears what a
// masked one left (corr = exp(m_prev - m_new) = 0). The query tiles are
// walked longest-first so that the causal blocks with most tiles start
// first. The kernel reads q, k and v through their (batch, sequence,
// head) strides: no copy of K/V per query head, no transpose.
//
// Bound on the H100: the operations. At the serving path's shape (bf16,
// B 4, S 2048, H 40, KV 10, hd 128, causal) the valid (query, key) pairs
// need 4 B H hd S (S + 1) / 2 = 1.72e11 FLOP, 0.174 ms at the bf16
// tensor-core rate of 989 TFLOP/s, against 84 MB of bytes (0.025 ms at
// 3.35 TB/s). This kernel computes on the float32 SIMT pipes (67 TFLOP/s
// at most, 2.6 ms for those FLOP) and is far from the bound; moving the
// two products to wgmma in bf16 is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 256;    // 16 x 16
constexpr float kNegInf = -1e30f;
constexpr double kLog2e = 1.4426950408889634;

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

// Stage rows row0 .. row0 + ROWS of one head of a (B, S, heads, HD) tensor
// in shared memory as float32, row-major with a row stride of LD floats;
// rows at or past n_rows are zero. src points at (b, 0, head, 0); rows
// are row_stride elements apart. Each thread moves 16 bytes at a time.
template <typename T, int HD, int LD, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long row_stride, int row0,
                                          int n_rows) {
  constexpr int kVec = 16 / sizeof(T);          // 4 floats or 8 bf16
  constexpr int kPerRow = HD / kVec;
  for (int idx = threadIdx.x; idx < ROWS * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow, c = (idx % kPerRow) * kVec;
    float vals[kVec];
    if (row0 + r < n_rows) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          src + static_cast<long long>(row0 + r) * row_stride + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) vals[j] = to_f32(e[j]);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) vals[j] = 0.0f;
    }
    float* d = dst + r * LD + c;
#pragma unroll
    for (int j = 0; j < kVec; j += 4)
      *reinterpret_cast<float4*>(d + j) =
          make_float4(vals[j], vals[j + 1], vals[j + 2], vals[j + 3]);
  }
}

struct Strides {
  long long b, s, h;             // in elements; the hd axis is contiguous
};

template <int HD>
struct Smem {
  static constexpr int kLdQ = HD + 4;           // padded rows of Q and K
  static constexpr int kLdP = kBK + 4;          // padded rows of P
  static constexpr int kQ = kBQ * kLdQ;
  // K's tile, and P over it once the scores are formed
  static constexpr int kKP = (kBK * kLdQ > kBQ * kLdP) ? kBK * kLdQ
                                                        : kBQ * kLdP;
  static constexpr int kV = kBK * HD;
  static constexpr int kBytes = (kQ + kKP + kV) * 4;
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, Strides qs,
                 Strides ks, Strides vs, Strides os, int Sq, int Sk, int group,
                 int causal, int window, float scale_log2) {
  using SM = Smem<HD>;
  constexpr int kCols = HD / 16;                // accumulator columns
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + SM::kQ;
  float* Ps = Ks;
  float* Vs = Ks + SM::kKP;

  const int qt = gridDim.x - 1 - blockIdx.x;     // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / group;
  const int q0 = qt * kBQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile<T, HD, SM::kLdQ, kBQ>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, Sq);

  // the KV tiles some row of this query tile needs
  int k_end = Sk;
  if (causal) k_end = min(Sk, q0 + kBQ);
  const int k_begin = window ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_begin / kBK;
  const int t_end = (k_end + kBK - 1) / kBK;

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }

  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the last tile's P and V reads are done
    load_tile<T, HD, SM::kLdQ, kBK>(Ks, kb, ks.s, k0, Sk);
    load_tile<T, HD, HD, kBK>(Vs, vb, vs.s, k0, Sk);
    __syncthreads();

    // scores of rows 4 ty + i against keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(
            Qs + (ty * 4 + i) * SM::kLdQ + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(
            Ks + (tx + 16 * j) * SM::kLdQ + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          s[i][j] = fmaf(qv[i].w, kv[j].w, a);
        }
    }
    __syncthreads();  // every thread is done with K: P goes over it

    // online softmax, in base 2 (scale_log2 = log2(e) / sqrt(hd))
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        bool ok = kp < Sk;
        if (causal) ok = ok && kp <= qp;
        if (window) ok = ok && kp > qp - window;
        s[i][j] = ok ? s[i][j] * scale_log2 : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of a row are lanes tx = 0..15 of one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = exp2f(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(s[i][j] - m_new);
        Ps[(ty * 4 + i) * SM::kLdP + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    // acc += P V
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(
            Ps + (ty * 4 + i) * SM::kLdP + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          vv[c] = Vs[(j + jj) * HD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = jj == 0 ? pv[i].x : jj == 1 ? pv[i].y
                        : jj == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* o = out + b * os.b + static_cast<long long>(qp) * os.s + h * os.h;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      o[tx + 16 * c] = from_f32<T>(acc[i][c] / denom);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   Strides qs, Strides ks, Strides vs, Strides os, int B,
                   int Sq, int Sk, int H, int group, int causal, int window,
                   float scale_log2, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<HD>::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, Smem<HD>::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), qs, ks, vs, os, Sq, Sk,
      group, causal, window, scale_log2);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        void* out, Strides qs, Strides ks, Strides vs,
                        Strides os, int B, int Sq, int Sk, int H, int group,
                        int causal, int window, float scale_log2,
                        cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, out, qs, ks, vs, os, B, Sq, Sk, H, group,
                           causal, window, scale_log2, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, qs, ks, vs, os, B, Sq, Sk, H, group,
                           causal, window, scale_log2, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, qs, ks, vs, os, B, Sq, Sk, H, group,
                            causal, window, scale_log2, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, Sq, H, hd), k and v (B, Sk, KV, hd), out (B, Sq, H, hd), all of one
// type (dtype 0: float32, 1: bfloat16), hd contiguous; *_sb, *_ss, *_sh are
// the batch, sequence and head strides in elements. Returns 0 or the
// cudaError_t of the launch. Nothing here synchronises or allocates.
int fa_forward(const void* q, const void* k, const void* v, void* out,
               int dtype, int B, int Sq, int Sk, int H, int KV, int hd,
               long long q_sb, long long q_ss, long long q_sh,
               long long k_sb, long long k_ss, long long k_sh,
               long long v_sb, long long v_ss, long long v_sh,
               long long o_sb, long long o_ss, long long o_sh,
               int causal, int window, int device, void* stream) {
  if (B < 0 || Sq < 0 || Sk < 0 || H <= 0 || KV <= 0 || H % KV != 0 ||
      window < 0 || (dtype != 0 && dtype != 1) ||
      (hd != 32 && hd != 64 && hd != 128) || H > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || Sq == 0) return 0;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  const float scale_log2 =
      static_cast<float>(kLog2e / std::sqrt(static_cast<double>(hd)));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = dtype == 0
            ? dispatch_hd<float>(hd, q, k, v, out, qs, ks, vs, os, B, Sq, Sk,
                                 H, H / KV, causal, window, scale_log2, s)
            : dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, qs, ks, vs, os, B,
                                         Sq, Sk, H, H / KV, causal, window,
                                         scale_log2, s);
  return static_cast<int>(err);
}

}  // extern "C"
