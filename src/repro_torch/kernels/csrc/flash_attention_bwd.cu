// GQA flash attention, backward, for Hopper (sm_90a).
//
// Replaces jax.grad of the reference's jnp attention, blocked_attention
// (src/repro/models/layers.py:266): the TPU package has no backward kernel
// for flash_attention_pallas and differentiates that jnp code. This is the
// gradient of fa_forward (flash_attention.cu): for q (B, Sq, H, hd), k and
// v (B, Sk, KV, hd), the forward's output o, its gradient do (B, Sq, H,
// hd) and its rows' log-sum-exp lse (B, H, Sq; base 2, +inf for a row with
// no key kept), with S = q k^T / sqrt(hd) under the forward's masks (key
// j < Sk, causal j <= i, window j > i - window):
//   P = 2^(S log2(e) - lse),  D_i = sum_d do_i o_i,  dS = P (do v^T - D),
//   dq = dS k / sqrt(hd),  dk = dS^T q / sqrt(hd),  dv = P^T do,
// dk and dv summed over the H / KV query heads of each KV head. A query
// row that no key is kept for (lse +inf) gets no gradient. Accumulation in
// float32; dq, dk, dv are written in the inputs' type, for hd 32, 64, 128
// and 256.
//
// Bound on the H100: the operations. The function needs five products of
// 2 hd flop per kept (query, key) pair and head (S, dP, dV, dQ, dK): at
// the train path's gemma3 global shape (bf16, B 1, S 2048, H 16, KV 8,
// hd 256, causal) 8.6e10 flop, 0.087 ms at 989 TFLOP/s, against 101 MB
// of bytes (q, k, v, o, do read, dq, dk, dv written: 0.030 ms at 3.35
// TB/s).
//
// Two kernels, no atomics, so a gradient is the same bits run to run (the
// FlashAttention-2 split): one over query tiles forms dq, one over key
// tiles forms dk and dv. Each recomputes S (and dP) for itself, so they do
// seven products per kept pair where the function needs five: they reach
// at most 5/7 (71%) of the bound above. That is the price of deterministic
// gradients without atomics.
//
// bfloat16 (namespace hopper): warp-specialised wgmma kernels fed by TMA,
// with the forward's building blocks (hopper.cuh). Every product is a
// wgmma m64nNk16, bf16 in, float32 accumulators in registers; no operand
// is transposed in memory:
//   * K-major B (a tile as it lies): K or V for S = Q K^T and dP = dO V^T,
//     Q or dO for S^T = K Q^T and dP^T = V dO^T;
//   * MN-major B through the descriptor's transpose bit: K for dQ += dS K,
//     dO for dV += P^T dO, Q for dK += dS^T Q;
//   * A from registers: P and dS rounded to bf16, the accumulator
//     fragment of one product as the A fragment of the next (as the
//     forward does with P).
// Three warpgroups per block: a producer (setmaxnreg 24, one thread issues
// every TMA load) and two consumers (setmaxnreg 240). Every tile in shared
// memory is 64 rows (queries or keys) of hd bf16, in boxes of one swizzle
// row; rows past Sq or Sk come in as zeros (TMA out-of-bounds fill).
//   * fa_bwd_dq_hopper, one block per (128-row query tile, head, batch),
//     longest first. Each consumer owns 64 query rows: D_i = sum do_i o_i
//     from device memory (written to the scratch the second kernel
//     reads), its Q and dO tiles in shared memory; K and V of 64 keys
//     through a ring behind full/empty mbarriers (two stages; one at hd
//     256, where Q and dO take 128 KB). Per key tile: dP = dO V^T (V is
//     released), S = Q K^T, P = 2^(S c - lse) and dS = P (dP - D) in
//     registers, dQ += dS K (K is released). A consumer skips the tiles
//     its masks empty. Registers at hd 256: dQ 128 + S 32 + dP 32.
//   * fa_bwd_dkdv_hopper, one block per (64-key tile, KV head, batch), the
//     low key tiles (the most causal work) first. K and V stay in shared
//     memory; Q and dO of each query tile that the masks let reach the key
//     tile, for each of the group's query heads, come through a two-stage
//     ring. The consumers split the outputs, not hd: the first forms
//     S^T = K Q^T, P^T, and dV += P^T dO; the second dP^T = V dO^T, dS^T =
//     P^T (dP^T - D) with P^T handed over through shared memory (64 x 64
//     float32, named barriers), and dK += dS^T Q. So each consumer holds
//     one full-hd accumulator (at hd 256: 128 registers, + 32 of S^T or
//     dP^T, + 16 of lse or D), each does two of the four products per
//     pair, and no product is done twice: splitting hd between them would
//     leave S^T and dP^T, which contract over all of hd, to be done twice
//     or summed across the two through shared memory.
//   * Masks only on the tiles that need them (the diagonal, the window's
//     edge, the ragged edges); tiles the masks empty are never loaded.
//   Shared memory: dq 197,760 B at hd 256 (one stage), 132,224 at 128;
//   dk/dv 214,144 B at hd 256, 115,840 at 128: one block per SM.
//
// float32: SIMT kernels on the float32 pipes, kept for the float32 checks
// (1e-3, which bf16 products could not meet): fa_bwd_dq_kernel (one block
// per query tile: D, then dS and dq = dS k over the key tiles, the rows'
// lse read from the forward) and fa_bwd_dkdv_kernel (one block per key
// tile: dk and dv over the query tiles and query heads), 256 threads as
// 16 x 16, tiles staged as float32 with rows padded by 4 floats; 64 x 64
// tiles below hd 256, 32 x 32 at hd 256.

#include <cmath>

#include "hopper.cuh"

namespace {

constexpr double kLog2e = 1.4426950408889634;

// ---------------------------------------------------------------------------
// float32: the SIMT kernels
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;    // 16 x 16

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

// Stage rows row0 .. row0 + ROWS of one head of a (B, S, heads, HD)
// float32 tensor in shared memory, row-major with a row stride of LD
// floats; rows at or past n_rows are zero. src points at (b, 0, head, 0);
// rows are row_stride elements apart. Each thread moves a float4 at a time.
template <int HD, int LD, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long row_stride, int row0,
                                          int n_rows) {
  constexpr int kPerRow = HD / 4;
  for (int idx = threadIdx.x; idx < ROWS * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow, c = (idx % kPerRow) * 4;
    float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row0 + r < n_rows)
      val = *reinterpret_cast<const float4*>(
          src + static_cast<long long>(row0 + r) * row_stride + c);
    *reinterpret_cast<float4*>(dst + r * LD + c) = val;
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

// dq: D_i from the do and o tiles (to the scratch for the second kernel),
// then dS = P (dO V^T - D) with P from the forward's lse, dq += dS K
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ o,
                 const float* __restrict__ dout, float* __restrict__ dq,
                 const float* __restrict__ lse, float* __restrict__ delta_out,
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

  load_tile<HD, LD, BQ>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, Sq);
  load_tile<HD, LD, BQ>(dOs, dout + b * ds.b + h * ds.h, ds.s, q0, Sq);
  // O's tile where K's goes: D_i = sum_d dO_i O_i
  load_tile<HD, LD, BQ>(Ks, o + b * os.b + h * os.h, os.s, q0, Sq);
  __syncthreads();
  float delta[RQ], lse2[RQ];
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
    const int qp = q0 + r;
    const long long at = (static_cast<long long>(b) * H + h) * Sq + qp;
    lse2[i] = qp < Sq ? lse[at] : INFINITY;
    if (tx == 0 && qp < Sq) delta_out[at] = acc;
  }

  int t_begin, t_end;
  key_tiles<BK>(q0, BQ, Sk, causal, window, &t_begin, &t_end);
  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vs.b + kvh * vs.h;
  float acc[RQ][NC];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();
    load_tile<HD, LD, BK>(Ks, kb, ks.s, k0, Sk);
    load_tile<HD, LD, BK>(Vs, vb, vs.s, k0, Sk);
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
    float* out = dq + b * dqs.b + static_cast<long long>(qp) * dqs.s + h * dqs.h;
#pragma unroll
    for (int c = 0; c < NC; ++c) out[tx + 16 * c] = acc[i][c] * scale;
  }
}

// dk and dv: K and V of one key tile stay in shared memory while the block
// walks the query tiles the masks let reach them, for each query head of
// the group
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse2_in,
                   const float* __restrict__ delta_in, float* __restrict__ dk,
                   float* __restrict__ dv, Strides qs, Strides ks, Strides vs,
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

  load_tile<HD, LD, BK>(Ks, k + b * ks.b + kvh * ks.h, ks.s, k0, Sk);
  load_tile<HD, LD, BK>(Vs, v + b * vs.b + kvh * vs.h, vs.s, k0, Sk);

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
    const float* qb = q + b * qs.b + h * qs.h;
    const float* db = dout + b * ds.b + h * ds.h;
    const float* lb = lse2_in + (static_cast<long long>(b) * H + h) * Sq;
    const float* dlb = delta_in + (static_cast<long long>(b) * H + h) * Sq;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the last tile's reads are done
      load_tile<HD, LD, BQ>(Qs, qb, qs.s, q0, Sq);
      load_tile<HD, LD, BQ>(dOs, db, ds.s, q0, Sq);
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
    float* gk = dk + b * dks.b + static_cast<long long>(kp) * dks.s + kvh * dks.h;
    float* gv = dv + b * dvs.b + static_cast<long long>(kp) * dvs.s + kvh * dvs.h;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      gk[tx + 16 * c] = adk[a][c] * scale;
      gv[tx + 16 * c] = adv[a][c];
    }
  }
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  const float* lse;
  float* delta;
  Strides qs, ks, vs, os, ds, dqs, dks, dvs;
  int B, Sq, Sk, H, KV, causal, window;
  float scale_log2, scale;
};

template <int HD>
cudaError_t launch_f32(const Args& a, cudaStream_t stream) {
  using TL = Tiles<HD>;
  const int group = a.H / a.KV;
  auto dq_kernel = fa_bwd_dq_kernel<HD>;
  auto dkv_kernel = fa_bwd_dkdv_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TL::kDqBytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dkv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             TL::kDkvBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid_q((a.Sq + TL::kQ - 1) / TL::kQ, a.H, a.B);
  dq_kernel<<<grid_q, kThreads, TL::kDqBytes, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.o),
      static_cast<const float*>(a.dout), static_cast<float*>(a.dq), a.lse,
      a.delta, a.qs, a.ks, a.vs, a.os, a.ds, a.dqs, a.Sq, a.Sk, a.H, group,
      a.causal, a.window, a.scale_log2, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.Sk == 0) return err;
  const dim3 grid_k((a.Sk + TL::kK - 1) / TL::kK, a.KV, a.B);
  dkv_kernel<<<grid_k, kThreads, TL::kDkvBytes, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
      a.qs, a.ks, a.vs, a.ds, a.dks, a.dvs, a.Sq, a.Sk, a.H, group,
      a.causal, a.window, a.scale_log2, a.scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: warp-specialised wgmma + TMA
// ---------------------------------------------------------------------------

namespace hopper {

constexpr int kTileRows = 64;    // rows of every tile: queries or keys
constexpr int kConsumers = 2;    // warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
// setmaxnreg's split of the 168 registers a thread of a 384-thread block
// is launched with (ptxas must report 168: a block launched with fewer
// never finds the registers its consumers ask for, and hangs)
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kExchangeBytes = kTileRows * kTileRows * 4;   // P^T, float32
// named barriers of the dk/dv kernel: P^T written, P^T read
constexpr int kXFull = 1, kXEmpty = 2;

template <int HD>
struct Bwd : Swizzle<HD> {
  using Swizzle<HD>::kBox;
  using Swizzle<HD>::kBoxes;
  using Swizzle<HD>::kRowBytes;
  static constexpr int kBoxBytes = kTileRows * kRowBytes;  // one box
  static constexpr int kTileBytes = kBoxes * kBoxBytes;    // one tile
  // the dq kernel's K/V ring: two stages, one at hd 256 (two Q and two dO
  // tiles take 128 KB there)
  static constexpr int kStagesA = HD > 128 ? 1 : 2;
  static constexpr int kStagesB = 2;                       // the Q/dO ring
  // the tiles, their barriers, room to align to 1024 bytes (the 128-byte
  // swizzle's period)
  static constexpr int kSmemA = 1024 + (4 + 2 * kStagesA) * kTileBytes + 128;
  static constexpr int kSmemB =
      1024 + (2 + 2 * kStagesB) * kTileBytes + kExchangeBytes + 128;
};

// D (64 x 64) = A B^T over hd: A and B 64-row tiles, both K-major
template <int HD>
__device__ __forceinline__ void issue_nt(float (&d)[32], uint32_t a,
                                         uint32_t b) {
  using W = Bwd<HD>;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off =
        kk * 16 / W::kBox * W::kBoxBytes + (kk * 16 % W::kBox) * 2;
    wgmma_ss_n64(d, smem_desc<HD>(a + off, 16, W::kSbo),
                 smem_desc<HD>(b + off, 16, W::kSbo), kk);
  }
}

// D (64 x hd) += A B: A the bf16 fragments of a 64 x 64 accumulator, B a
// 64-row tile read MN-major
template <int HD>
__device__ __forceinline__ void issue_nn(float (&d)[HD / 2],
                                         const uint32_t (&pa)[4][4],
                                         uint32_t b) {
  using W = Bwd<HD>;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_pv<HD>(d, pa[kk], b + kk * 16 * W::kRowBytes, W::kBoxBytes);
}

// a 64 x hd accumulator (rows row and row + 8 of each thread, columns
// 8 j + col and + 1), times f, as bf16 rows of `out` below n_rows
template <int HD>
__device__ __forceinline__ void store_rows(const float (&acc)[HD / 2],
                                           __nv_bfloat16* out,
                                           long long row_stride, int row,
                                           int n_rows, float f) {
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (row < n_rows)
      *reinterpret_cast<__nv_bfloat162*>(
          out + static_cast<long long>(row) * row_stride + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j] * f, acc[4 * j + 1] * f);
    if (row + 8 < n_rows)
      *reinterpret_cast<__nv_bfloat162*>(
          out + static_cast<long long>(row + 8) * row_stride + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2] * f, acc[4 * j + 3] * f);
  }
}

// dq. Block: 128 query rows of one (head, batch), the query tiles longest
// first; consumer w owns rows 64 w .. 64 w + 63.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dq_hopper(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_do,
                 const __nv_bfloat16* __restrict__ o, Strides os,
                 const __nv_bfloat16* __restrict__ dout, Strides ds,
                 const float* __restrict__ lse, float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dq, Strides dqs, int Sq, int Sk,
                 int H, int n_b, int group, int causal, int window,
                 float scale_log2, float scale) {
  using W = Bwd<HD>;
  constexpr int kStages = W::kStagesA;
  constexpr int kTile = W::kTileBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  // Q of the two consumers' rows, dO likewise, K of stage s at k_smem + s
  // kTile, V likewise; then the 8-byte barriers q_full, k_full[s],
  // v_full[s], k_empty[s], v_empty[s]
  const uint32_t q_smem = base;
  const uint32_t do_smem = q_smem + 2 * kTile;
  const uint32_t k_smem = do_smem + 2 * kTile;
  const uint32_t v_smem = k_smem + kStages * kTile;
  const uint32_t q_full = v_smem + kStages * kTile;
  const uint32_t k_full = q_full + 8;
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t k_empty = v_full + 8 * kStages;
  const uint32_t v_empty = k_empty + 8 * kStages;

  const int n_q = (Sq + 2 * kTileRows - 1) / (2 * kTileRows);
  const int hb = blockIdx.x % (H * n_b);
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.x) / (H * n_b)) * 2 *
                 kTileRows;
  const int h = hb % H, b = hb / H, kvh = h / group;
  // the key tiles some row of the block keeps
  const int k_end = causal ? min(Sk, q0 + 2 * kTileRows) : Sk;
  const int k_begin = window ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_begin / kTileRows;
  const int n_tiles = max(0, (k_end + kTileRows - 1) / kTileRows - t_begin);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, kConsumers);
      mbar_init(v_empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // producer: Q and dO once, then V before K of each key tile (dP, which
    // reads V, is issued before S)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(q_full, 4 * kTile);
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < W::kBoxes; ++c) {
          const uint32_t at = r * kTile + c * W::kBoxBytes;
          tma_load(q_smem + at, &tm_q, q_full, c * W::kBox,
                   q0 + r * kTileRows, h, b);
          tma_load(do_smem + at, &tm_do, q_full, c * W::kBox,
                   q0 + r * kTileRows, h, b);
        }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        const uint32_t ph = ((i / kStages) & 1) ^ 1;
        const int k0 = (t_begin + i) * kTileRows;
        mbar_wait(v_empty + 8 * s, ph);
        mbar_expect_tx(v_full + 8 * s, kTile);
#pragma unroll
        for (int c = 0; c < W::kBoxes; ++c)
          tma_load(v_smem + s * kTile + c * W::kBoxBytes, &tm_v,
                   v_full + 8 * s, c * W::kBox, k0, kvh, b);
        mbar_wait(k_empty + 8 * s, ph);
        mbar_expect_tx(k_full + 8 * s, kTile);
#pragma unroll
        for (int c = 0; c < W::kBoxes; ++c)
          tma_load(k_smem + s * kTile + c * W::kBoxBytes, &tm_k,
                   k_full + 8 * s, c * W::kBox, k0, kvh, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    // accumulator layout: this thread holds rows `row` and row + 8,
    // columns 8 j + col and 8 j + col + 1 of each 8-column block j
    const int col = 2 * (lane % 4);
    const int qmin = q0 + kTileRows * wg;
    const int row = qmin + 16 * warp + lane / 4;
    const long long bh = static_cast<long long>(b) * H + h;

    // D of rows row and row + 8, from o and do in device memory: the
    // quad's four lanes take 16-byte chunks lane % 4, lane % 4 + 4, ...
    float dd[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = row + 8 * r;
      if (qp >= Sq) continue;
      const __nv_bfloat16* orow =
          o + b * os.b + static_cast<long long>(qp) * os.s + h * os.h;
      const __nv_bfloat16* grow =
          dout + b * ds.b + static_cast<long long>(qp) * ds.s + h * ds.h;
#pragma unroll
      for (int m = 0; m < HD / 32; ++m) {
        const int c0 = 8 * (lane % 4) + 32 * m;
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + c0);
        const uint4 gv = *reinterpret_cast<const uint4*>(grow + c0);
        const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* gp = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = __bfloat1622float2(op[e]);
          const float2 gf = __bfloat1622float2(gp[e]);
          dd[r] = fmaf(of.x, gf.x, dd[r]);
          dd[r] = fmaf(of.y, gf.y, dd[r]);
        }
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      dd[0] += __shfl_xor_sync(0xffffffffu, dd[0], off);
      dd[1] += __shfl_xor_sync(0xffffffffu, dd[1], off);
    }
    if (col == 0) {
      if (row < Sq) delta[bh * Sq + row] = dd[0];
      if (row + 8 < Sq) delta[bh * Sq + row + 8] = dd[1];
    }
    const float l0 = row < Sq ? lse[bh * Sq + row] : INFINITY;
    const float l1 = row + 8 < Sq ? lse[bh * Sq + row + 8] : INFINITY;

    float acc[HD / 2], sc[32], dp[32];
    uint32_t pa[4][4];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;
    const uint32_t q_wg = q_smem + wg * kTile, do_wg = do_smem + wg * kTile;
    mbar_wait(q_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const uint32_t ph = (i / kStages) & 1;
      const int k0 = (t_begin + i) * kTileRows;
      const uint32_t k_st = k_smem + s * kTile, v_st = v_smem + s * kTile;
      // some (row, key) pair of this consumer's rows is kept
      const bool live = qmin < Sq && (!causal || k0 <= qmin + kTileRows - 1) &&
                        (!window || k0 + kTileRows - 1 > qmin - window);
      mbar_wait(v_full + 8 * s, ph);
      if (live) {
        wgmma_fence();
        issue_nt<HD>(dp, do_wg, v_st);           // dP = dO V^T
        wgmma_commit();
      }
      mbar_wait(k_full + 8 * s, ph);
      if (live) {
        issue_nt<HD>(sc, q_wg, k_st);            // S = Q K^T
        wgmma_commit();
        wgmma_wait<1>();
      }
      if (t == 0) mbar_arrive(v_empty + 8 * s);
      if (live) {
        wgmma_wait<0>();
        fence_regs(dp);
        fence_regs(sc);
        // the mask only where some pair of this consumer's rows fails it
        const bool edge = k0 + kTileRows > Sk ||
                          (causal && k0 + kTileRows - 1 > qmin) ||
                          (window && k0 <= qmin + kTileRows - 1 - window);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qp = row + 8 * (e >> 1);
            const float lr = (e >> 1) ? l1 : l0, dr = (e >> 1) ? dd[1] : dd[0];
            float p = ex2(fmaf(sc[4 * j + e], scale_log2, -lr));
            if (edge) {
              const int kp = k0 + 8 * j + col + (e & 1);
              bool ok = kp < Sk;
              if (causal) ok = ok && kp <= qp;
              if (window) ok = ok && kp > qp - window;
              if (!ok) p = 0.0f;
            }
            sc[4 * j + e] = p * (dp[4 * j + e] - dr);   // dS
          }
        }
        pack_p(pa, sc);
        wgmma_fence();
        issue_nn<HD>(acc, pa, k_st);             // dQ += dS K
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        fence_pa(pa);
      }
      if (t == 0) mbar_arrive(k_empty + 8 * s);
    }
    store_rows<HD>(acc, dq + b * dqs.b + h * dqs.h + col, dqs.s, row, Sq,
                   scale);
  }
}

// dk and dv. Block: 64 keys of one (KV head, batch), the low key tiles
// first. Consumer 0 forms S^T = K Q^T, P^T and dV += P^T dO; consumer 1
// dP^T = V dO^T, dS^T = P^T (dP^T - D) and dK += dS^T Q, with P^T from
// consumer 0 through shared memory. Both run the same wgmma code on
// other operands.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dkdv_hopper(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_do,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dk, Strides dks,
                   __nv_bfloat16* __restrict__ dv, Strides dvs, int Sq,
                   int Sk, int H, int KV, int n_b, int causal, int window,
                   float scale_log2, float scale) {
  using W = Bwd<HD>;
  constexpr int kStages = W::kStagesB;
  constexpr int kTile = W::kTileBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  // K, V; Q of stage s at q_smem + s kTile, dO likewise; P^T; then the
  // barriers kv_full, q_full[s], do_full[s], q_empty[s], do_empty[s]
  const uint32_t k_smem = base;
  const uint32_t v_smem = k_smem + kTile;
  const uint32_t q_smem = v_smem + kTile;
  const uint32_t do_smem = q_smem + kStages * kTile;
  const uint32_t x_smem = do_smem + kStages * kTile;
  const uint32_t kv_full = x_smem + kExchangeBytes;
  const uint32_t q_full = kv_full + 8;
  const uint32_t do_full = q_full + 8 * kStages;
  const uint32_t q_empty = do_full + 8 * kStages;
  const uint32_t do_empty = q_empty + 8 * kStages;
  float* x = reinterpret_cast<float*>(smem_raw + (x_smem - raw));

  const int group = H / KV;
  const int kvb = blockIdx.x % (KV * n_b);
  const int k0 = static_cast<int>(blockIdx.x) / (KV * n_b) * kTileRows;
  const int kvh = kvb % KV, b = kvb / KV;
  // the query tiles whose masks keep some key of this tile, per query head
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window ? min(Sq, k0 + kTileRows - 1 + window) : Sq;
  const int qt_begin = q_lo / kTileRows;
  const int n_qt =
      q_hi > q_lo ? (q_hi + kTileRows - 1) / kTileRows - qt_begin : 0;
  const int n_steps = group * n_qt;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(q_full + 8 * s, 1);
      mbar_init(do_full + 8 * s, 1);
      mbar_init(q_empty + 8 * s, kConsumers);
      mbar_init(do_empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(kv_full, 2 * kTile);
#pragma unroll
      for (int c = 0; c < W::kBoxes; ++c) {
        tma_load(k_smem + c * W::kBoxBytes, &tm_k, kv_full, c * W::kBox, k0,
                 kvh, b);
        tma_load(v_smem + c * W::kBoxBytes, &tm_v, kv_full, c * W::kBox, k0,
                 kvh, b);
      }
      for (int j = 0; j < n_steps; ++j) {
        const int s = j % kStages;
        const uint32_t ph = ((j / kStages) & 1) ^ 1;
        const int h = kvh * group + j / n_qt;
        const int q0 = (qt_begin + j % n_qt) * kTileRows;
        mbar_wait(q_empty + 8 * s, ph);
        mbar_expect_tx(q_full + 8 * s, kTile);
#pragma unroll
        for (int c = 0; c < W::kBoxes; ++c)
          tma_load(q_smem + s * kTile + c * W::kBoxBytes, &tm_q,
                   q_full + 8 * s, c * W::kBox, q0, h, b);
        mbar_wait(do_empty + 8 * s, ph);
        mbar_expect_tx(do_full + 8 * s, kTile);
#pragma unroll
        for (int c = 0; c < W::kBoxes; ++c)
          tma_load(do_smem + s * kTile + c * W::kBoxBytes, &tm_do,
                   do_full + 8 * s, c * W::kBox, q0, h, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    // accumulator layout: keys `key` and key + 8, columns (queries of
    // S^T, or hd) 8 j + col and 8 j + col + 1
    const int col = 2 * (lane % 4);
    const int key = k0 + 16 * warp + lane / 4;
    // consumer 0: K, then dO after P^T; consumer 1: V, then Q after dS^T
    const uint32_t a1 = wg == 0 ? k_smem : v_smem;
    const float* row_stat = wg == 0 ? lse : delta;
    const float beyond = wg == 0 ? INFINITY : 0.0f;   // past Sq

    float acc[HD / 2], sc[32], cv[16];
    uint32_t pa[4][4];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;
    mbar_wait(kv_full, 0);
    if (wg == 1 && n_steps > 0) bar_arrive(kXEmpty);
    for (int j = 0; j < n_steps; ++j) {
      const int s = j % kStages;
      const uint32_t ph = (j / kStages) & 1;
      const int h = kvh * group + j / n_qt;
      const int q0 = (qt_begin + j % n_qt) * kTileRows;
      const uint32_t q_st = q_smem + s * kTile, do_st = do_smem + s * kTile;
      // this thread's 16 query columns' lse (consumer 0) or D (consumer 1)
      const float* stat = row_stat + (static_cast<long long>(b) * H + h) * Sq;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qp = q0 + 8 * jj + col + e;
          cv[2 * jj + e] = qp < Sq ? stat[qp] : beyond;
        }
      mbar_wait(q_full + 8 * s, ph);
      mbar_wait(do_full + 8 * s, ph);
      wgmma_fence();
      issue_nt<HD>(sc, a1, wg == 0 ? q_st : do_st);   // S^T or dP^T
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      if (t == 0) mbar_arrive((wg == 0 ? q_empty : do_empty) + 8 * s);
      if (wg == 0) {
        const bool edge = q0 + kTileRows > Sq || k0 + kTileRows > Sk ||
                          (causal && k0 + kTileRows - 1 > q0) ||
                          (window && k0 <= q0 + kTileRows - 1 - window);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = ex2(fmaf(sc[4 * jj + e], scale_log2, -cv[2 * jj + (e & 1)]));
            if (edge) {
              const int qp = q0 + 8 * jj + col + (e & 1);
              const int kp = key + 8 * (e >> 1);
              bool ok = qp < Sq && kp < Sk;
              if (causal) ok = ok && kp <= qp;
              if (window) ok = ok && kp > qp - window;
              if (!ok) p = 0.0f;
            }
            sc[4 * jj + e] = p;                            // P^T
          }
        }
        bar_sync(kXEmpty);
#pragma unroll
        for (int i = 0; i < 32; ++i) x[i * 128 + t] = sc[i];
        bar_arrive(kXFull);
      } else {
        bar_sync(kXFull);
#pragma unroll
        for (int i = 0; i < 32; ++i)                       // dS^T
          sc[i] = x[i * 128 + t] * (sc[i] - cv[2 * (i / 4) + (i & 1)]);
        if (j + 1 < n_steps) bar_arrive(kXEmpty);
      }
      pack_p(pa, sc);
      wgmma_fence();
      issue_nn<HD>(acc, pa, wg == 0 ? do_st : q_st);   // dV or dK
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_pa(pa);
      if (t == 0) mbar_arrive((wg == 0 ? do_empty : q_empty) + 8 * s);
    }
    if (wg == 0)
      store_rows<HD>(acc, dv + b * dvs.b + kvh * dvs.h + col, dvs.s, key, Sk,
                     1.0f);
    else
      store_rows<HD>(acc, dk + b * dks.b + kvh * dks.h + col, dks.s, key, Sk,
                     scale);
  }
}

template <int HD>
int launch(const Args& a, cudaStream_t stream) {
  using W = Bwd<HD>;
  EncodeTiled encode;
  cudaError_t err = encoder(&encode);
  if (err != cudaSuccess) return err;
  // every map in 64-row boxes; a map needs extents >= 1 (with Sk == 0 no
  // K/V tile is loaded)
  CUtensorMap tq, tk, tv, tdo;
  int rc = make_map<HD>(&tq, encode, a.q, a.Sq, a.H, a.B, a.qs, kTileRows);
  if (rc == 0)
    rc = make_map<HD>(&tdo, encode, a.dout, a.Sq, a.H, a.B, a.ds, kTileRows);
  if (rc == 0)
    rc = make_map<HD>(&tk, encode, a.k, max(a.Sk, 1), a.KV, a.B, a.ks,
                      kTileRows);
  if (rc == 0)
    rc = make_map<HD>(&tv, encode, a.v, max(a.Sk, 1), a.KV, a.B, a.vs,
                      kTileRows);
  if (rc != 0) return rc;
  auto dq_kernel = fa_bwd_dq_hopper<HD>;
  auto dkv_kernel = fa_bwd_dkdv_hopper<HD>;
  err = cudaFuncSetAttribute(dq_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             W::kSmemA);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dkv_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               W::kSmemB);
  if (err != cudaSuccess) return err;
  const int n_q = (a.Sq + 2 * kTileRows - 1) / (2 * kTileRows);
  dq_kernel<<<n_q * a.H * a.B, kThreads, W::kSmemA, stream>>>(
      tq, tk, tv, tdo, static_cast<const __nv_bfloat16*>(a.o), a.os,
      static_cast<const __nv_bfloat16*>(a.dout), a.ds, a.lse, a.delta,
      static_cast<__nv_bfloat16*>(a.dq), a.dqs, a.Sq, a.Sk, a.H, a.B,
      a.H / a.KV, a.causal, a.window, a.scale_log2, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.Sk == 0) return err;
  const int n_k = (a.Sk + kTileRows - 1) / kTileRows;
  dkv_kernel<<<n_k * a.KV * a.B, kThreads, W::kSmemB, stream>>>(
      tq, tk, tv, tdo, a.lse, a.delta, static_cast<__nv_bfloat16*>(a.dk),
      a.dks, static_cast<__nv_bfloat16*>(a.dv), a.dvs, a.Sq, a.Sk, a.H, a.KV,
      a.B, a.causal, a.window, a.scale_log2, a.scale);
  return cudaGetLastError();
}

}  // namespace hopper

int dispatch_hd(int dtype, int hd, const Args& a, cudaStream_t stream) {
  switch (dtype * 1000 + hd) {
    case 32:
      return launch_f32<32>(a, stream);
    case 64:
      return launch_f32<64>(a, stream);
    case 128:
      return launch_f32<128>(a, stream);
    case 256:
      return launch_f32<256>(a, stream);
    case 1032:
      return hopper::launch<32>(a, stream);
    case 1064:
      return hopper::launch<64>(a, stream);
    case 1128:
      return hopper::launch<128>(a, stream);
    case 1256:
      return hopper::launch<256>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, o, do, dq (B, Sq, H, hd); k, v, dk, dv (B, Sk, KV, hd); all of one
// type (dtype 0: float32, the SIMT kernels; 1: bfloat16, the wgmma
// kernels), hd contiguous, rows 16-byte aligned (bf16: strides multiples
// of 8 elements, as TMA needs); *_sb, *_ss, *_sh the batch, sequence and
// head strides in elements. lse: the forward's float32 (B, H, Sq), each
// row's log-sum-exp in base 2 (+inf for a row with no key kept). delta:
// float32 scratch of B * H * Sq elements (D_i, written by the first kernel
// and read by the second). Returns 0, the cudaError_t of a launch, or
// 10000 + the CUresult of a failed tensor-map encoding. Nothing here
// synchronises or allocates.
int fa_backward(const void* q, const void* k, const void* v, const void* o,
                const void* dout, void* dq, void* dk, void* dv,
                const float* lse, float* delta, int dtype, int B, int Sq,
                int Sk, int H, int KV, int hd,
                long long q_sb, long long q_ss, long long q_sh,
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
      B > 65535 ||
      static_cast<long long>((Sq + 63) / 64) * H * B > 0x7fffffff ||
      static_cast<long long>((Sk + 63) / 64) * KV * B > 0x7fffffff)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || Sq == 0) return 0;
  const Args a{q, k, v, o, dout, dq, dk, dv, lse, delta,
               {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh}, {v_sb, v_ss, v_sh},
               {o_sb, o_ss, o_sh}, {d_sb, d_ss, d_sh}, {dq_sb, dq_ss, dq_sh},
               {dk_sb, dk_ss, dk_sh}, {dv_sb, dv_ss, dv_sh},
               B, Sq, Sk, H, KV, causal, window,
               static_cast<float>(kLog2e / std::sqrt(static_cast<double>(hd))),
               static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd)))};
  return dispatch_hd(dtype, hd, a, static_cast<cudaStream_t>(stream));
}

// The dynamic shared memory of the two kernels (dtype 0: float32, 1:
// bfloat16) at head dim hd: dq's into *dq_bytes, dk/dv's into *dkv_bytes.
// cudaErrorInvalidValue for a dtype or hd fa_backward does not take.
int fa_backward_smem_bytes(int dtype, int hd, int* dq_bytes,
                           int* dkv_bytes) {
  switch (dtype * 1000 + hd) {
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
    case 1032:
      *dq_bytes = hopper::Bwd<32>::kSmemA;
      *dkv_bytes = hopper::Bwd<32>::kSmemB;
      return 0;
    case 1064:
      *dq_bytes = hopper::Bwd<64>::kSmemA;
      *dkv_bytes = hopper::Bwd<64>::kSmemB;
      return 0;
    case 1128:
      *dq_bytes = hopper::Bwd<128>::kSmemA;
      *dkv_bytes = hopper::Bwd<128>::kSmemB;
      return 0;
    case 1256:
      *dq_bytes = hopper::Bwd<256>::kSmemA;
      *dkv_bytes = hopper::Bwd<256>::kSmemB;
      return 0;
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
