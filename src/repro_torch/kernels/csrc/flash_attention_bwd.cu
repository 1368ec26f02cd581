// GQA flash attention, backward, for Hopper (sm_90a).
//
// The gradient of fa_forward (flash_attention.cu), which replaces
// flash_attention_pallas (src/repro/kernels/flash_attention.py). The TPU
// package has no backward kernel: it differentiates its jnp attention
// (blocked_attention) with jax.grad. This computes that gradient: for
// q (B, Sq, H, hd), k and v (B, Sk, KV, hd), the forward's output o and its
// gradient do (B, Sq, H, hd), with S = q k^T / sqrt(hd) under the forward's
// masks (key j < Sk, causal j <= i, window j > i - window) and
// P = softmax(S):
//   D_i = sum_d do_i o_i,  dS = P (do v^T - D),
//   dq = dS k / sqrt(hd),  dk = dS^T q / sqrt(hd),  dv = P^T do,
// dk and dv summed over the H / KV query heads of each KV head. A query
// row that no key is kept for gets no gradient. Accumulation in float32;
// dq, dk, dv are written in the inputs' type (float32 or bfloat16), for
// hd 32, 64, 128 and 256.
//
// fa_forward saves no log-sum-exp, so the work is two kernels in the
// FlashAttention-2 way, with no atomics:
//   * fa_bwd_dq_kernel, one block per (query tile, head, batch): D_i from
//     the do and o tiles; a first sweep over the key tiles the tile's
//     masks keep finds each row's max and sum (lse, base 2); both go to a
//     float32 scratch (B, H, Sq) for the second kernel; a second sweep
//     rebuilds P, forms dS and accumulates dq = dS k in registers.
//   * fa_bwd_dkdv_kernel, one block per (key tile, KV head, batch): K and V
//     stay in shared memory while the block walks the query tiles that the
//     masks let reach them, for each of the group's query heads, rebuilds
//     P and dS from the saved statistics and accumulates dv = P^T do and
//     dk = dS^T q in registers.
// Both are SIMT kernels on the float32 pipes, in the shape of the forward's
// float32 kernel (flash_fwd_kernel): 256 threads as 16 x 16, tiles staged
// in shared memory as float32 with rows padded by 4 floats (the float4
// reads along hd of 8 consecutive rows fall in distinct banks), the row
// statistics reduced over the 16 lanes of a half-warp. Tiles are 64 rows
// (queries) by 64 keys below hd 256, 32 by 32 at hd 256, where four
// float32 tiles of 64 rows would need 266 KB: 137,728 / 142,592 bytes of
// shared memory at hd 256, 152,576 / 170,496 at hd 128, one block per SM.
// The window's edge needs no tile of its own: every score is checked
// against the masks, and only tiles that no pair of a block keeps are
// skipped. The scale 1/sqrt(hd) is folded into the exponent
// (log2(e)/sqrt(hd)) and applied once to dq and dk at the store.
//
// Bound on the H100: the operations. Per kept (query, key) pair and head
// the two kernels do 8 products of 2 hd flop (S three times, dP twice, dq,
// dk, dv), four times the forward's 4 hd, here on the float32 pipes (67
// TFLOP/s) where the bf16 forward has the tensor cores (989): a simple
// kernel that is right first, which a wgmma redesign can take later
// (ROADMAP Queue B). The bytes (q, k, v, o, do read, dq, dk, dv written,
// K/V tiles re-read per query tile from L2) weigh far less.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;    // 16 x 16
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
  return __float2bfloat16(x);
}

struct Strides {
  long long b, s, h;             // in elements; the hd axis is contiguous
};

// Tiles and shared memory per head dim: query rows per tile, keys per
// tile, padded row lengths, the bytes each kernel asks for.
template <int HD>
struct Tiles {
  static constexpr int kQ = HD > 128 ? 32 : 64;
  static constexpr int kK = HD > 128 ? 32 : 64;
  static constexpr int kLd = HD + 4;
  static constexpr int kRQ = kQ / 16;          // query rows per thread
  static constexpr int kRK = kK / 16;          // keys per thread
  static constexpr int kCols = HD / 16;        // accumulator columns
  // dq: Q, dO, K (O's tile first), V, dS (kQ x (kK + 4))
  static constexpr int kDqFloats = (2 * kQ + 2 * kK) * kLd + kQ * (kK + 4);
  // dk/dv: K, V, Q, dO, P^T and dS^T (kK x (kQ + 4)), lse and D (kQ each)
  static constexpr int kDkvFloats =
      (2 * kQ + 2 * kK) * kLd + 2 * kK * (kQ + 4) + 2 * kQ;
  static constexpr int kDqBytes = kDqFloats * 4;
  static constexpr int kDkvBytes = kDkvFloats * 4;
};

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

__device__ __forceinline__ bool kept(int qp, int kp, int Sq, int Sk,
                                     int causal, int window) {
  bool ok = qp < Sq && kp < Sk;
  if (causal) ok = ok && kp <= qp;
  if (window) ok = ok && kp > qp - window;
  return ok;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// the key tiles [t_begin, t_end) that some row of query rows q0 .. q0 + nq
// keeps
template <int BK>
__device__ __forceinline__ void key_tiles(int q0, int nq, int Sk, int causal,
                                          int window, int* t_begin,
                                          int* t_end) {
  int k_end = Sk;
  if (causal) k_end = min(Sk, q0 + nq);
  const int k_begin = window ? max(0, q0 - window + 1) : 0;
  *t_begin = k_begin / BK;
  *t_end = k_end > k_begin ? (k_end + BK - 1) / BK : *t_begin;
}

// ---------------------------------------------------------------------------
// dq, with the row statistics
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ o,
                 const T* __restrict__ dout, T* __restrict__ dq,
                 float* __restrict__ lse2_out, float* __restrict__ delta_out,
                 Strides qs, Strides ks, Strides vs, Strides os, Strides ds,
                 Strides dqs, int Sq, int Sk, int H, int group, int causal,
                 int window, float scale_log2, float scale) {
  using TL = Tiles<HD>;
  constexpr int BQ = TL::kQ, BK = TL::kK, LD = TL::kLd;
  constexpr int RQ = TL::kRQ, RK = TL::kRK, NC = TL::kCols;
  constexpr int LDS = BK + 4;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* dSs = Vs + BK * LD;

  const int qt = gridDim.x - 1 - blockIdx.x;     // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / group;
  const int q0 = qt * BQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile<T, HD, LD, BQ>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, Sq);
  load_tile<T, HD, LD, BQ>(dOs, dout + b * ds.b + h * ds.h, ds.s, q0, Sq);
  // O's tile where K's goes: D_i = sum_d dO_i O_i
  load_tile<T, HD, LD, BQ>(Ks, o + b * os.b + h * os.h, os.s, q0, Sq);
  __syncthreads();
  float delta[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = ty * RQ + i;
    float acc = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      acc = fmaf(dOs[r * LD + tx + 16 * c], Ks[r * LD + tx + 16 * c], acc);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    delta[i] = acc;
  }

  int t_begin, t_end;
  key_tiles<BK>(q0, BQ, Sk, causal, window, &t_begin, &t_end);
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;

  // sweep 1: each row's max and sum over its kept keys, in base 2
  float m[RQ], l[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
  }
  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();
    load_tile<T, HD, LD, BK>(Ks, kb, ks.s, k0, Sk);
    __syncthreads();
    float s[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[RQ], kv[RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty * RQ + i) * LD + d);
#pragma unroll
      for (int j = 0; j < RK; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) s[i][j] = dot4(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qp = q0 + ty * RQ + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const bool ok = kept(qp, k0 + tx + 16 * j, Sq, Sk, causal, window);
        s[i][j] = ok ? s[i][j] * scale_log2 : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      // no kept key yet: every term is exp2(-inf) = 0 (the whole warp
      // stays on the path: both of its rows shuffle below)
      const float m_use = m_new == -INFINITY ? 0.0f : m_new;
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < RK; ++j) rs += exp2f(s[i][j] - m_use);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * exp2f(m[i] - m_use) + rs;
      m[i] = m_new;
    }
  }
  float lse2[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    lse2[i] = l[i] > 0.0f ? m[i] + log2f(l[i]) : INFINITY;
    const int qp = q0 + ty * RQ + i;
    if (tx == 0 && qp < Sq) {
      const long long at = (static_cast<long long>(b) * H + h) * Sq + qp;
      lse2_out[at] = lse2[i];
      delta_out[at] = delta[i];
    }
  }

  // sweep 2: dS = P (dO V^T - D), dq += dS K
  float acc[RQ][NC];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();
    load_tile<T, HD, LD, BK>(Ks, kb, ks.s, k0, Sk);
    load_tile<T, HD, LD, BK>(Vs, vb, vs.s, k0, Sk);
    __syncthreads();
    float s[RQ][RK], dp[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 2
    for (int d = 0; d < HD; d += 4) {
      float4 qv[RQ], gv[RQ], kv[RK], vv[RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty * RQ + i) * LD + d);
        gv[i] = *reinterpret_cast<const float4*>(dOs + (ty * RQ + i) * LD + d);
      }
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * LD + d);
        vv[j] = *reinterpret_cast<const float4*>(Vs + (tx + 16 * j) * LD + d);
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) {
          s[i][j] = dot4(qv[i], kv[j], s[i][j]);
          dp[i][j] = dot4(gv[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = ty * RQ + i;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int kc = tx + 16 * j;
        const bool ok = kept(q0 + r, k0 + kc, Sq, Sk, causal, window);
        const float p = ok ? exp2f(s[i][j] * scale_log2 - lse2[i]) : 0.0f;
        dSs[r * LDS + kc] = p * (dp[i][j] - delta[i]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float kr[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) kr[c] = Ks[j * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float g = dSs[(ty * RQ + i) * LDS + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(g, kr[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qp = q0 + ty * RQ + i;
    if (qp >= Sq) continue;
    T* out = dq + b * dqs.b + static_cast<long long>(qp) * dqs.s + h * dqs.h;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      out[tx + 16 * c] = from_f32<T>(acc[i][c] * scale);
  }
}

// ---------------------------------------------------------------------------
// dk and dv
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse2_in,
                   const float* __restrict__ delta_in, T* __restrict__ dk,
                   T* __restrict__ dv, Strides qs, Strides ks, Strides vs,
                   Strides ds, Strides dks, Strides dvs, int Sq, int Sk,
                   int H, int group, int causal, int window,
                   float scale_log2, float scale) {
  using TL = Tiles<HD>;
  constexpr int BQ = TL::kQ, BK = TL::kK, LD = TL::kLd;
  constexpr int RK = TL::kRK, CQ = TL::kRQ, NC = TL::kCols;
  constexpr int LDP = BQ + 4;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* dOs = Qs + BQ * LD;
  float* Ps = dOs + BQ * LD;
  float* dSs = Ps + BK * LDP;
  float* Ls = dSs + BK * LDP;
  float* Dl = Ls + BQ;

  const int kt = blockIdx.x;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * BK;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile<T, HD, LD, BK>(Ks, k + b * ks.b + kvh * ks.h, ks.s, k0, Sk);
  load_tile<T, HD, LD, BK>(Vs, v + b * vs.b + kvh * vs.h, vs.s, k0, Sk);

  // the query rows whose masks keep some key of this tile
  const int q_lo = causal ? k0 : 0;
  int q_hi = Sq;
  if (window) q_hi = min(Sq, k0 + BK - 1 + window);
  const int qt_begin = q_lo / BQ;
  const int qt_end = q_hi > q_lo ? (q_hi + BQ - 1) / BQ : qt_begin;

  float adk[RK][NC], adv[RK][NC];
#pragma unroll
  for (int a = 0; a < RK; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) adk[a][c] = adv[a][c] = 0.0f;

  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const T* qb = q + b * qs.b + h * qs.h;
    const T* db = dout + b * ds.b + h * ds.h;
    const float* lb = lse2_in + (static_cast<long long>(b) * H + h) * Sq;
    const float* dlb = delta_in + (static_cast<long long>(b) * H + h) * Sq;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the last tile's reads are done
      load_tile<T, HD, LD, BQ>(Qs, qb, qs.s, q0, Sq);
      load_tile<T, HD, LD, BQ>(dOs, db, ds.s, q0, Sq);
      for (int i = threadIdx.x; i < BQ; i += kThreads) {
        const bool in = q0 + i < Sq;
        Ls[i] = in ? lb[q0 + i] : INFINITY;
        Dl[i] = in ? dlb[q0 + i] : 0.0f;
      }
      __syncthreads();
      // keys ty * RK + a against queries tx + 16 c
      float s[RK][CQ], dp[RK][CQ];
#pragma unroll
      for (int a = 0; a < RK; ++a)
#pragma unroll
        for (int c = 0; c < CQ; ++c) s[a][c] = dp[a][c] = 0.0f;
#pragma unroll 2
      for (int d = 0; d < HD; d += 4) {
        float4 kv[RK], vv[RK], qv[CQ], gv[CQ];
#pragma unroll
        for (int a = 0; a < RK; ++a) {
          kv[a] = *reinterpret_cast<const float4*>(Ks + (ty * RK + a) * LD + d);
          vv[a] = *reinterpret_cast<const float4*>(Vs + (ty * RK + a) * LD + d);
        }
#pragma unroll
        for (int c = 0; c < CQ; ++c) {
          qv[c] = *reinterpret_cast<const float4*>(Qs + (tx + 16 * c) * LD + d);
          gv[c] = *reinterpret_cast<const float4*>(dOs + (tx + 16 * c) * LD + d);
        }
#pragma unroll
        for (int a = 0; a < RK; ++a)
#pragma unroll
          for (int c = 0; c < CQ; ++c) {
            s[a][c] = dot4(kv[a], qv[c], s[a][c]);
            dp[a][c] = dot4(vv[a], gv[c], dp[a][c]);
          }
      }
#pragma unroll
      for (int a = 0; a < RK; ++a) {
        const int kr = ty * RK + a;
#pragma unroll
        for (int c = 0; c < CQ; ++c) {
          const int qc = tx + 16 * c;
          const bool ok = kept(q0 + qc, k0 + kr, Sq, Sk, causal, window);
          const float p = ok ? exp2f(s[a][c] * scale_log2 - Ls[qc]) : 0.0f;
          Ps[kr * LDP + qc] = p;
          dSs[kr * LDP + qc] = p * (dp[a][c] - Dl[qc]);
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int i = 0; i < BQ; ++i) {
        float qr[NC], gr[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          qr[c] = Qs[i * LD + tx + 16 * c];
          gr[c] = dOs[i * LD + tx + 16 * c];
        }
#pragma unroll
        for (int a = 0; a < RK; ++a) {
          const float p = Ps[(ty * RK + a) * LDP + i];
          const float gs = dSs[(ty * RK + a) * LDP + i];
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            adv[a][c] = fmaf(p, gr[c], adv[a][c]);
            adk[a][c] = fmaf(gs, qr[c], adk[a][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < RK; ++a) {
    const int kp = k0 + ty * RK + a;
    if (kp >= Sk) continue;
    T* gk = dk + b * dks.b + static_cast<long long>(kp) * dks.s + kvh * dks.h;
    T* gv = dv + b * dvs.b + static_cast<long long>(kp) * dvs.s + kvh * dvs.h;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      gk[tx + 16 * c] = from_f32<T>(adk[a][c] * scale);
      gv[tx + 16 * c] = from_f32<T>(adv[a][c]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  float *lse2, *delta;
  Strides qs, ks, vs, os, ds, dqs, dks, dvs;
  int B, Sq, Sk, H, KV, causal, window;
  float scale_log2, scale;
};

template <typename T, int HD>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using TL = Tiles<HD>;
  const int group = a.H / a.KV;
  auto dq_kernel = fa_bwd_dq_kernel<T, HD>;
  auto dkv_kernel = fa_bwd_dkdv_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TL::kDqBytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dkv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             TL::kDkvBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid_q((a.Sq + TL::kQ - 1) / TL::kQ, a.H, a.B);
  dq_kernel<<<grid_q, kThreads, TL::kDqBytes, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.o),
      static_cast<const T*>(a.dout), static_cast<T*>(a.dq), a.lse2, a.delta,
      a.qs, a.ks, a.vs, a.os, a.ds, a.dqs, a.Sq, a.Sk, a.H, group, a.causal,
      a.window, a.scale_log2, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.Sk == 0) return err;
  const dim3 grid_k((a.Sk + TL::kK - 1) / TL::kK, a.KV, a.B);
  dkv_kernel<<<grid_k, kThreads, TL::kDkvBytes, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse2,
      a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.qs, a.ks,
      a.vs, a.ds, a.dks, a.dvs, a.Sq, a.Sk, a.H, group, a.causal, a.window,
      a.scale_log2, a.scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const Args& a, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(a, stream);
    case 64:
      return launch<T, 64>(a, stream);
    case 128:
      return launch<T, 128>(a, stream);
    case 256:
      return launch<T, 256>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, o, do, dq (B, Sq, H, hd); k, v, dk, dv (B, Sk, KV, hd); all of one
// type (dtype 0: float32, 1: bfloat16), hd contiguous, rows 16-byte
// aligned; *_sb, *_ss, *_sh the batch, sequence and head strides in
// elements. lse2 and delta: float32 scratch of B * H * Sq elements each
// (the rows' base-2 log-sum-exp and D_i, written by the first kernel and
// read by the second). Returns 0 or the cudaError_t of a launch. Nothing
// here synchronises or allocates.
int fa_backward(const void* q, const void* k, const void* v, const void* o,
                const void* dout, void* dq, void* dk, void* dv, float* lse2,
                float* delta, int dtype, int B, int Sq, int Sk, int H, int KV,
                int hd, long long q_sb, long long q_ss, long long q_sh,
                long long k_sb, long long k_ss, long long k_sh,
                long long v_sb, long long v_ss, long long v_sh,
                long long o_sb, long long o_ss, long long o_sh,
                long long d_sb, long long d_ss, long long d_sh,
                long long dq_sb, long long dq_ss, long long dq_sh,
                long long dk_sb, long long dk_ss, long long dk_sh,
                long long dv_sb, long long dv_ss, long long dv_sh,
                int causal, int window, int device, void* stream) {
  if (B < 0 || Sq < 0 || Sk < 0 || H <= 0 || KV <= 0 || H % KV != 0 ||
      window < 0 || (dtype != 0 && dtype != 1) ||
      (hd != 32 && hd != 64 && hd != 128 && hd != 256) || H > 65535 ||
      B > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || Sq == 0) return 0;
  Args a{q, k, v, o, dout, dq, dk, dv, lse2, delta,
         {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh}, {v_sb, v_ss, v_sh},
         {o_sb, o_ss, o_sh}, {d_sb, d_ss, d_sh}, {dq_sb, dq_ss, dq_sh},
         {dk_sb, dk_ss, dk_sh}, {dv_sb, dv_ss, dv_sh},
         B, Sq, Sk, H, KV, causal, window,
         static_cast<float>(kLog2e / std::sqrt(static_cast<double>(hd))),
         static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd)))};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(dispatch_hd<float>(hd, a, s));
  return static_cast<int>(dispatch_hd<__nv_bfloat16>(hd, a, s));
}

// The dynamic shared memory of the two kernels at head dim hd (dq's, then
// dk/dv's, into *dq_bytes and *dkv_bytes); cudaErrorInvalidValue for an
// hd fa_backward does not take.
int fa_backward_smem_bytes(int hd, int* dq_bytes, int* dkv_bytes) {
  switch (hd) {
    case 32:
      *dq_bytes = Tiles<32>::kDqBytes;
      *dkv_bytes = Tiles<32>::kDkvBytes;
      return 0;
    case 64:
      *dq_bytes = Tiles<64>::kDqBytes;
      *dkv_bytes = Tiles<64>::kDkvBytes;
      return 0;
    case 128:
      *dq_bytes = Tiles<128>::kDqBytes;
      *dkv_bytes = Tiles<128>::kDkvBytes;
      return 0;
    case 256:
      *dq_bytes = Tiles<256>::kDqBytes;
      *dkv_bytes = Tiles<256>::kDkvBytes;
      return 0;
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
