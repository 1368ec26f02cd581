// The RWKV6 WKV recurrence, backward, for Hopper (sm_90a): chunk-parallel,
// in three phases.
//
// The gradient of wkv6_forward (rwkv_scan.cu), which replaces
// rwkv_scan_pallas (src/repro/kernels/rwkv_scan.py). The TPU package has
// no backward kernel: it differentiates its lax.scan with jax.grad. This
// computes that gradient. Per (batch, head), with the float32 state S_t
// (hd x hd, rows i over k's channels, columns j over v's) before step t,
// S_0 = 0, y_t = r_t . (S_t + diag(u) k_t^T v_t) and
// S_{t+1} = diag(w_t) S_t + k_t^T v_t, given dy and the final state's
// gradient dstate (or zero), with G_{t+1} the gradient of S_{t+1} and
// p_t = sum_i r_t[i] u[i] k_t[i]:
//   dk_t[i] = sum_j G_{t+1}[i,j] v_t[j] + r_t[i] u[i] (v_t . dy_t)
//   dv_t[j] = sum_i G_{t+1}[i,j] k_t[i] + p_t dy_t[j]
//   dw_t[i] = sum_j G_{t+1}[i,j] S_t[i,j]
//   dr_t[i] = sum_j S_t[i,j] dy_t[j] + u[i] k_t[i] (v_t . dy_t)
//   du[i]  += r_t[i] k_t[i] (v_t . dy_t)
//   G_t = r_t^T dy_t + diag(w_t) G_{t+1},  G_S = dstate
// dr, dk, dv, dw are written in the inputs' type (float32 or bfloat16), du
// as float32 partials per (batch, head, chunk), which the caller sums.
// hd 16, 32, 64, 128.
//
// Both recurrences are linear, and w_t scales the rows i of both. So the
// sequence is cut into chunks of L steps (Steps<HD>::L, 32 at hd 64), and
// with P(a, b)[i] = prod_{a <= tau < b} w_tau[i] (1 when a = b; every
// decay below is such a product, at most 1, and nothing divides by one),
// three kernels run on the caller's stream, in one call:
//   1. summaries, one block per (batch, head, chunk), from zero:
//      A_c = sum_s diag(P(s+1, L)) k_s^T v_s (the chunk's own state),
//      B_c = sum_s diag(P(0, s)) r_s^T dy_s (its own gradient at its
//      start) and D_c = P(0, L): the decays folded into the staged k and
//      r by a running product per row, then two L-deep products;
//   2. carry, one thread per (batch, head, i, two columns j), serial over
//      the chunks: S_{c+1} = D_c[i] S_c + A_c from S_0 = 0, and E_{c-1} =
//      B_c + D_c[i] E_c from E_last = dstate, E_c the gradient of the
//      state at the end of chunk c; written over A and B in place; the two
//      chains share one loop, so that 16 chunks' loads are in flight;
//   3. the chunk's gradients, one block per (batch, head, chunk), from
//      S_c and E_c. The G walk runs G back from E_c, hd^2 / kRows threads
//      owning kRows rows of one column each, and gives dv. The row walk,
//      one thread per row i, gives dr, dk, dw and du without holding any
//      state of the chunk: with Q[s] = (S_t dy_s)[i] (from S_c DY^T, in
//      registers), g = sum_j E_c[i,j] S_t[i,j], V DY^T and E_c V^T formed
//      first as HD-deep products, one stage of jobs for all the block's
//      threads, at step t (a running product q = P(t+1, s)):
//        dw_t = sum_{s>t} P(t+1,s) r_s Q[s] + P(t+1,n) g
//        dk_t = sum_{s>t} P(t+1,s) r_s (v_t . dy_s) + P(t+1,n) (E_c v_t)
//        dr_t = Q[t] + u k_t (v_t . dy_t)
//      then Q[s] <- w_t Q[s] + k_t (v_t . dy_s) for s > t and
//      g <- w_t g + k_t (E_c v_t). The two walks run on separate warps.
// A chunk's missing steps (S no multiple of L) are staged as w = 1 and
// k = v = r = dy = 0: they leave both recurrences as they are.
//
// At rwkv6-3b's train shape (B 1, S 2048, H 40, hd 64, L 32) phases 1 and
// 3 launch 2,560 blocks each: 256 threads with 40 KB of shared memory,
// and 192 threads (64 for the row walk, 128 for the G walk) with 62 KB,
// two resident an SM at up to 168 registers a thread (the caps of three
// and four blocks spilled and ran no faster); phase 2 81,920 threads.
// The scratch holds A and B per (batch, head, chunk), 84 MB, and D.
//
// Bound on the H100: the float32 operations of the function itself, 12
// flop per state element and step (S rebuilt, G, dk, dv, dw, dr). The
// phases spend about 11 instructions of arithmetic per state element and
// step in all (the two products of phase 1, the G walk's 3, phase 3's
// three products and its row walk), beside their shared memory reads;
// phase 3 is bound by issuing them, phases 1 and 2 by the scratch's
// traffic (A and B written, read and written again, S_c and E_c read:
// about 340 MB at the train shape). dy is staged with each row's float4
// groups XOR-swizzled by the row, so that the product that reads it one
// row a lane meets no bank conflict.

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

// Steps per chunk at each head dim. tests/test_torch_wkv6_chunked.py
// mirrors the three phases with these (KERNEL_CHUNK there).
template <int HD>
struct Steps;
template <>
struct Steps<16> { static constexpr int L = 32; };
template <>
struct Steps<32> { static constexpr int L = 32; };
template <>
struct Steps<64> { static constexpr int L = 32; };
template <>
struct Steps<128> { static constexpr int L = 16; };

template <int HD>
struct Cfg {
  static constexpr int L = Steps<HD>::L;
  static constexpr int kTile = L * HD;  // floats of one staged input
  // XOR mask of a row's float4 groups (see sw)
  static constexpr int kSwz = (HD / 4 < 8 ? HD / 4 : 8) - 1;
  // phase 1: the five staged inputs
  static constexpr int kT1 = HD * HD / 16 < 256 ? HD * HD / 16 : 256;
  static constexpr int kSmem1 = 5 * kTile * 4;
  // phase 3: row walk (HD threads), then the G walk (kRows rows of one
  // column a thread); r, k, w, dy, v, Q, E v, V DY^T, p, E . S rows
  static constexpr int kRows = HD <= 32 ? 16 : HD == 64 ? 32 : 64;
  static constexpr int kSeg = HD / kRows;  // lanes per column
  static constexpr int kT3 = HD + HD * kSeg;
  static constexpr int kMinBlocks3 = HD <= 32 ? 4 : HD == 64 ? 2 : 1;
  static constexpr int kSmem3 = (7 * kTile + L * L + L + HD) * 4;
  // phase 2: two state elements a thread
  static constexpr int kT2 = 256;
};

int chunk_of(int hd) {
  switch (hd) {
    case 16: return Steps<16>::L;
    case 32: return Steps<32>::L;
    case 64: return Steps<64>::L;
    case 128: return Steps<128>::L;
    default: return -1;
  }
}

// Element (s, i) of a swizzled [L][HD] array (dy in phase 3, which its
// product V DY^T reads one row a lane): row s's float4 groups XOR-ed with
// s, so that four-wide reads of one column group of several rows fall in
// different banks. Every other staged array is plain row-major.
template <int HD>
__device__ __forceinline__ int sw(int s, int i) {
  return s * HD + ((((i >> 2) ^ (s & Cfg<HD>::kSwz)) << 2) | (i & 3));
}

template <int HD, bool SWZ>
__device__ __forceinline__ int at_(int s, int i) {
  return SWZ ? sw<HD>(s, i) : s * HD + i;
}

// the inputs' order in stage_chunk
enum { kR, kK, kV, kW, kDY };

// d x + a on two consecutive state elements of the carry
__device__ __forceinline__ float2 fma2(float d, float2 x, float2 a) {
  return make_float2(fmaf(d, x.x, a.x), fmaf(d, x.y, a.y));
}

// The chunk's steps 0 .. L-1 of r, k, v, w and dy (src[0 .. 4], one head
// of (B, S, H, HD) tensors: the chunk's first step at at0, steps ld
// elements apart) into dst[0 .. 4], widened to float32, array a swizzled
// where bit a of SWZ is set; steps n .. L-1 get w = 1 and 0 elsewhere.
// A thread issues the loads of two of its vectors of all five inputs
// before it stores any, so that they share one trip to memory.
template <typename T, int HD, int L, int NT, int SWZ>
__device__ __forceinline__ void stage_chunk(float* const (&dst)[5],
                                            const T* const (&src)[5],
                                            long long at0, long long ld,
                                            int n) {
  constexpr int kVec = 16 / sizeof(T), kPer = HD / kVec;
  constexpr int kIters = (L * kPer + NT - 1) / NT;
  for (int it0 = 0; it0 < kIters; it0 += 2) {
    uint4 raw[2][5];
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int idx = threadIdx.x + (it0 + it) * NT;
      const int s = idx / kPer, e = (idx % kPer) * kVec;
      if (idx < L * kPer && s < n) {
#pragma unroll
        for (int a = 0; a < 5; ++a)
          raw[it][a] = *reinterpret_cast<const uint4*>(
              src[a] + at0 + static_cast<long long>(s) * ld + e);
      }
    }
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int idx = threadIdx.x + (it0 + it) * NT;
      if (idx >= L * kPer) continue;
      const int s = idx / kPer, e = (idx % kPer) * kVec;
#pragma unroll
      for (int a = 0; a < 5; ++a) {
        float x[kVec];
        const T* p = reinterpret_cast<const T*>(&raw[it][a]);
#pragma unroll
        for (int m = 0; m < kVec; ++m)
          x[m] = s < n ? to_f32(p[m]) : (a == kW ? 1.0f : 0.0f);
#pragma unroll
        for (int m = 0; m < kVec; m += 4) {
          const int at = ((SWZ >> a) & 1) ? sw<HD>(s, e + m) : s * HD + e + m;
          *reinterpret_cast<float4*>(dst[a] + at) =
              make_float4(x[m], x[m + 1], x[m + 2], x[m + 3]);
        }
      }
    }
  }
}

__device__ __forceinline__ float f4(const float4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

// out[s * HD + col] = sum_j X[s][j] y[j] over j < HD for s < L: X a
// staged [L][HD] array (swizzled with SWZ) that every lane reads at the
// same s (a broadcast), y one row of a float32 matrix in device memory,
// read 32 floats at a time into registers (one trip to memory for eight
// four-wide loads), once for every 16 steps s.
template <int HD, int L, bool SWZ>
__device__ __forceinline__ void column_products(const float* x,
                                                const float* y, float* out,
                                                int col) {
  constexpr int NS = L < 16 ? L : 16;
  constexpr int JB = HD < 32 ? HD : 32;
  for (int s0 = 0; s0 < L; s0 += NS) {
    float acc[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) acc[s] = 0.0f;
    for (int j0 = 0; j0 < HD; j0 += JB) {
      float4 yb[JB / 4];
#pragma unroll
      for (int q = 0; q < JB / 4; ++q)
        yb[q] = *reinterpret_cast<const float4*>(y + j0 + 4 * q);
#pragma unroll
      for (int s = 0; s < NS; ++s)
#pragma unroll
        for (int q = 0; q < JB / 4; ++q) {
          const float4 x4 = *reinterpret_cast<const float4*>(
              x + at_<HD, SWZ>(s0 + s, j0 + 4 * q));
          acc[s] = fmaf(x4.x, yb[q].x, acc[s]);
          acc[s] = fmaf(x4.y, yb[q].y, acc[s]);
          acc[s] = fmaf(x4.z, yb[q].z, acc[s]);
          acc[s] = fmaf(x4.w, yb[q].w, acc[s]);
        }
    }
#pragma unroll
    for (int s = 0; s < NS; ++s) out[(s0 + s) * HD + col] = acc[s];
  }
}

template <int NSEG>
__device__ __forceinline__ float lanes_sum(float x) {
#pragma unroll
  for (int off = 1; off < NSEG; off <<= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Phase 1: block (batch, head, chunk) writes A_c, B_c (HD x HD) and D_c.
template <typename T, int HD>
__global__ void __launch_bounds__(Cfg<HD>::kT1, 4)
wkv6_bwd_summary(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ w,
                 const T* __restrict__ dy, float* __restrict__ sa,
                 float* __restrict__ sb, float* __restrict__ dec, int S,
                 int H, int n_chunks) {
  using C = Cfg<HD>;
  constexpr int L = C::L, NT = C::kT1, TILE = C::kTile;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + TILE;
  float* ws = vs + TILE;
  float* rs = ws + TILE;
  float* ds = rs + TILE;

  const int blk = blockIdx.x;
  const int bh = blk / n_chunks, c = blk % n_chunks;
  const int b = bh / H, h = bh % H;
  const int t0 = c * L, n = min(L, S - t0);
  const long long ld = static_cast<long long>(H) * HD;
  const long long at0 = (static_cast<long long>(b) * S + t0) * ld +
                        static_cast<long long>(h) * HD;
  stage_chunk<T, HD, L, NT, 0>({rs, ks, vs, ws, ds}, {r, k, v, w, dy}, at0,
                              ld, n);
  __syncthreads();

  // k_s <- P(s+1, L) k_s, r_s <- P(0, s) r_s; D = P(0, L)
  for (int i = threadIdx.x; i < HD; i += NT) {
    float q = 1.0f;
    for (int s = L - 1; s >= 0; --s) {
      const int at = s * HD + i;
      ks[at] *= q;
      q *= ws[at];
    }
    dec[static_cast<long long>(blk) * HD + i] = q;
    q = 1.0f;
    for (int s = 0; s < L; ++s) {
      const int at = s * HD + i;
      rs[at] *= q;
      q *= ws[at];
    }
  }
  __syncthreads();

  // A = K^T V, B = R^T DY over the chunk's steps: 4 x 4 outputs of one of
  // them a thread
  constexpr int kTiles = HD * HD / 16;
  for (int tile = threadIdx.x; tile < 2 * kTiles; tile += NT) {
    const bool is_b = tile >= kTiles;
    const int tt = is_b ? tile - kTiles : tile;
    const int i0 = (tt / (HD / 4)) * 4, j0 = (tt % (HD / 4)) * 4;
    const float* x = is_b ? rs : ks;
    const float* y = is_b ? ds : vs;
    float acc[4][4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int f = 0; f < 4; ++f) acc[e][f] = 0.0f;
#pragma unroll 4
    for (int s = 0; s < L; ++s) {
      const float4 xx = *reinterpret_cast<const float4*>(x + s * HD + i0);
      const float4 yy = *reinterpret_cast<const float4*>(y + s * HD + j0);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int f = 0; f < 4; ++f)
          acc[e][f] = fmaf(f4(xx, e), f4(yy, f), acc[e][f]);
    }
    float* out = (is_b ? sb : sa) + static_cast<long long>(blk) * HD * HD;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      *reinterpret_cast<float4*>(out + (i0 + e) * HD + j0) =
          make_float4(acc[e][0], acc[e][1], acc[e][2], acc[e][3]);
  }
}

// Phase 2: thread (batch, head, i, j .. j + 1) carries the state forward
// and its gradient backward over the chunks, in place: sa[c] <- S_c (the
// state at chunk c's start), sb[c] <- E_c (the gradient of the state at
// its end). The two chains share one loop, so that 2 U chunks' loads are
// in flight together.
template <int HD>
__global__ void __launch_bounds__(Cfg<HD>::kT2)
wkv6_bwd_carry(float2* __restrict__ sa, float2* __restrict__ sb,
               const float* __restrict__ dec,
               const float2* __restrict__ dstate, int n_chunks,
               long long total) {
  constexpr int U = 8;
  constexpr long long kState2 = static_cast<long long>(HD) * HD / 2;
  const long long x = static_cast<long long>(blockIdx.x) * Cfg<HD>::kT2 +
                      threadIdx.x;
  if (x >= total) return;
  const long long bh = x / kState2;
  const int e2 = static_cast<int>(x % kState2), i = 2 * e2 / HD;
  float2* a = sa + bh * n_chunks * kState2 + e2;
  float2* g = sb + bh * n_chunks * kState2 + e2;
  const float* d = dec + bh * n_chunks * HD + i;

  float2 st = make_float2(0.0f, 0.0f);
  float2 gr = dstate ? dstate[bh * kState2 + e2] : make_float2(0.0f, 0.0f);
  for (int c0 = 0; c0 < n_chunks; c0 += U) {
    float2 av[U], bv[U];
    float da[U], db[U];
#pragma unroll
    for (int m = 0; m < U; ++m)
      if (c0 + m < n_chunks) {
        const int cb = n_chunks - 1 - c0 - m;
        av[m] = a[(c0 + m) * kState2];
        da[m] = d[(c0 + m) * HD];
        bv[m] = g[cb * kState2];
        db[m] = d[cb * HD];
      }
#pragma unroll
    for (int m = 0; m < U; ++m)
      if (c0 + m < n_chunks) {
        const int cb = n_chunks - 1 - c0 - m;
        a[(c0 + m) * kState2] = st;
        st = fma2(da[m], st, av[m]);
        g[cb * kState2] = gr;
        gr = fma2(db[m], gr, bv[m]);
      }
  }
}

// Phase 3: block (batch, head, chunk) writes the chunk's dr, dk, dv, dw
// and its part of du, from S_c and E_c.
template <typename T, int HD>
__global__ void __launch_bounds__(Cfg<HD>::kT3, Cfg<HD>::kMinBlocks3)
wkv6_bwd_chunk(const T* __restrict__ r, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ w,
               const float* __restrict__ u, const T* __restrict__ dy,
               const float* __restrict__ sa, const float* __restrict__ sb,
               T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
               T* __restrict__ dw, float* __restrict__ du_part, int S,
               int H, int n_chunks) {
  using C = Cfg<HD>;
  constexpr int L = C::L, NT = C::kT3, TILE = C::kTile;
  constexpr int W = C::kRows, NSEG = C::kSeg;
  extern __shared__ float4 smem4[];
  float* rs = reinterpret_cast<float*>(smem4);
  float* ks = rs + TILE;
  float* ws = ks + TILE;
  float* ds = ws + TILE;
  float* vs = ds + TILE;
  float* qs = vs + TILE;  // (S_c dy_s)[i]: the row walk's Q at its start
  float* gv = qs + TILE;  // (E v_s)[i]
  float* vd = gv + TILE;  // [L][L]: v_t . dy_s
  float* pp = vd + L * L;  // p_t
  float* es = pp + L;      // sum_j E[i,j] S_c[i,j]

  const int blk = blockIdx.x;
  const int bh = blk / n_chunks, c = blk % n_chunks;
  const int b = bh / H, h = bh % H;
  const int t0 = c * L, n = min(L, S - t0);
  const long long ld = static_cast<long long>(H) * HD;
  const long long at0 = (static_cast<long long>(b) * S + t0) * ld +
                        static_cast<long long>(h) * HD;
  const float* sc = sa + static_cast<long long>(blk) * HD * HD;
  const float* ec = sb + static_cast<long long>(blk) * HD * HD;
  const int tid = threadIdx.x;

  stage_chunk<T, HD, L, NT, 1 << kDY>({rs, ks, vs, ws, ds}, {r, k, v, w, dy},
                                      at0, ld, n);
  __syncthreads();

  // the chunk's products, one stage of jobs: E v_s and S_c dy_s (a column
  // i each), v_t . dy_s (L x kTG jobs of L / kTG steps t each, dy_s read
  // per lane from its swizzled rows), sum_j E[i,j] S_c[i,j] and p_t
  constexpr int kTG = L >= 32 ? 2 : 1, kTS = L / kTG;
  for (int job = tid; job < 3 * HD + L * kTG + L; job += NT) {
    if (job < HD) {
      column_products<HD, L, false>(vs, ec + job * HD, gv, job);
    } else if (job < 2 * HD) {
      column_products<HD, L, true>(ds, sc + (job - HD) * HD, qs, job - HD);
    } else if (job < 2 * HD + L * kTG) {
      const int s = (job - 2 * HD) % L, tg = (job - 2 * HD) / L;
      float acc[kTS];
#pragma unroll
      for (int m = 0; m < kTS; ++m) acc[m] = 0.0f;
      for (int j = 0; j < HD; j += 4) {
        const float4 d4 =
            *reinterpret_cast<const float4*>(ds + sw<HD>(s, j));
#pragma unroll
        for (int m = 0; m < kTS; ++m) {
          const float4 v4 = *reinterpret_cast<const float4*>(
              vs + (tg * kTS + m) * HD + j);
          acc[m] = fmaf(v4.x, d4.x, acc[m]);
          acc[m] = fmaf(v4.y, d4.y, acc[m]);
          acc[m] = fmaf(v4.z, d4.z, acc[m]);
          acc[m] = fmaf(v4.w, d4.w, acc[m]);
        }
      }
#pragma unroll
      for (int m = 0; m < kTS; ++m) vd[(tg * kTS + m) * L + s] = acc[m];
    } else if (job < 3 * HD + L * kTG) {
      const int i = job - 2 * HD - L * kTG;
      float acc = 0.0f;
#pragma unroll 4
      for (int j = 0; j < HD; j += 4) {
        const float4 e4 = *reinterpret_cast<const float4*>(ec + i * HD + j);
        const float4 s4 = *reinterpret_cast<const float4*>(sc + i * HD + j);
        acc = fmaf(e4.x, s4.x, acc);
        acc = fmaf(e4.y, s4.y, acc);
        acc = fmaf(e4.z, s4.z, acc);
        acc = fmaf(e4.w, s4.w, acc);
      }
      es[i] = acc;
    } else {
      // lane t starts at column t: the lanes' reads fall in distinct banks
      const int t = job - 3 * HD - L * kTG;
      float acc = 0.0f;
      for (int m = 0; m < HD; ++m) {
        const int i = (m + t) & (HD - 1);
        acc = fmaf(rs[t * HD + i] * u[h * HD + i], ks[t * HD + i], acc);
      }
      pp[t] = acc;
    }
  }
  __syncthreads();

  if (tid < HD) {
    // the row walk: row i, forward over the chunk's L steps, Q in
    // registers (the loops unrolled: a missing step, w = 1 and r = k = 0,
    // changes nothing, and writes no output)
    const int i = tid;
    const float ui = u[h * HD + i];
    float qv[L];
#pragma unroll
    for (int s = 0; s < L; ++s) qv[s] = qs[s * HD + i];
    float g = es[i], du = 0.0f;
#pragma unroll
    for (int t = 0; t < L; ++t) {
      const float kt = ks[t * HD + i], wt = ws[t * HD + i];
      const float rt = rs[t * HD + i];
      const float* vdt = vd + t * L;
      float q = 1.0f, aw = 0.0f, ak = 0.0f;
#pragma unroll
      for (int s = t + 1; s < L; ++s) {
        const float x = vdt[s];
        const float qr = q * rs[s * HD + i];
        aw = fmaf(qr, qv[s], aw);
        ak = fmaf(qr, x, ak);
        q *= ws[s * HD + i];
        qv[s] = fmaf(wt, qv[s], kt * x);
      }
      const float ev = gv[t * HD + i], vdd = vdt[t];
      if (t < n) {
        const long long o = at0 + static_cast<long long>(t) * ld + i;
        dw[o] = from_f32<T>(fmaf(q, g, aw));
        dk[o] = from_f32<T>(fmaf(q, ev, ak) + rt * ui * vdd);
        dr[o] = from_f32<T>(qv[t] + ui * kt * vdd);
      }
      du = fmaf(rt * kt, vdd, du);
      g = fmaf(wt, g, kt * ev);
    }
    du_part[static_cast<long long>(blk) * HD + i] = du;
  } else {
    // the G walk: column j, rows 4 (seg + NSEG q) + e, back over the chunk
    const int gi = tid - HD;
    const int j = gi / NSEG, seg = gi % NSEG;
    float gr[W];
#pragma unroll
    for (int q = 0; q < W / 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        gr[4 * q + e] = ec[(4 * (seg + NSEG * q) + e) * HD + j];
    for (int t = n - 1; t >= 0; --t) {
      const float dyj = ds[sw<HD>(t, j)];
      float acc0 = 0.0f, acc1 = 0.0f;
#pragma unroll
      for (int q = 0; q < W / 4; ++q) {
        const int i0 = t * HD + 4 * (seg + NSEG * q);
        const float4 kk = *reinterpret_cast<const float4*>(ks + i0);
        const float4 ww = *reinterpret_cast<const float4*>(ws + i0);
        const float4 rr = *reinterpret_cast<const float4*>(rs + i0);
        float* gq = gr + 4 * q;
        acc0 = fmaf(gq[0], kk.x, acc0);
        acc1 = fmaf(gq[1], kk.y, acc1);
        acc0 = fmaf(gq[2], kk.z, acc0);
        acc1 = fmaf(gq[3], kk.w, acc1);
        gq[0] = fmaf(ww.x, gq[0], rr.x * dyj);
        gq[1] = fmaf(ww.y, gq[1], rr.y * dyj);
        gq[2] = fmaf(ww.z, gq[2], rr.z * dyj);
        gq[3] = fmaf(ww.w, gq[3], rr.w * dyj);
      }
      const float acc = lanes_sum<NSEG>(acc0 + acc1);
      if (seg == 0)
        dv[at0 + static_cast<long long>(t) * ld + j] =
            from_f32<T>(fmaf(pp[t], dyj, acc));
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const float* u, const void* dy,
                   const float* dstate, void* dr, void* dk, void* dv,
                   void* dw, float* du_part, float* scratch, int B, int S,
                   int H, cudaStream_t stream) {
  using C = Cfg<HD>;
  const int n_chunks = (S + C::L - 1) / C::L;
  const long long blocks = static_cast<long long>(B) * H * n_chunks;
  const long long states = blocks * HD * HD;
  float* sa = scratch;
  float* sb = sa + states;
  float* dec = sb + states;
  auto k1 = wkv6_bwd_summary<T, HD>;
  auto k2 = wkv6_bwd_carry<HD>;
  auto k3 = wkv6_bwd_chunk<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      k1, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      k3, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem3);
  if (err != cudaSuccess) return err;
  const T* rr = static_cast<const T*>(r);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  const T* ww = static_cast<const T*>(w);
  const T* dd = static_cast<const T*>(dy);
  k1<<<static_cast<unsigned>(blocks), C::kT1, C::kSmem1, stream>>>(
      rr, kk, vv, ww, dd, sa, sb, dec, S, H, n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = static_cast<long long>(B) * H * HD * HD / 2;
  k2<<<static_cast<unsigned>((total + C::kT2 - 1) / C::kT2), C::kT2, 0,
       stream>>>(reinterpret_cast<float2*>(sa), reinterpret_cast<float2*>(sb),
                 dec, reinterpret_cast<const float2*>(dstate), n_chunks,
                 total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k3<<<static_cast<unsigned>(blocks), C::kT3, C::kSmem3, stream>>>(
      rr, kk, vv, ww, u, dd, sa, sb, static_cast<T*>(dr),
      static_cast<T*>(dk), static_cast<T*>(dv), static_cast<T*>(dw), du_part,
      S, H, n_chunks);
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

template <int HD>
int phase_smem(int phase) {
  return phase == 1 ? Cfg<HD>::kSmem1 : phase == 3 ? Cfg<HD>::kSmem3 : 0;
}

}  // namespace

extern "C" {

// The steps per chunk at head dim hd, or -1 for an hd it does not take.
int wkv6_backward_chunk(int hd) { return chunk_of(hd); }

// The float32 scratch a launch of wkv6_backward needs, in elements, into
// *floats: per (batch, head, chunk) two hd x hd states and hd decays.
// cudaErrorInvalidValue for an hd it does not take.
int wkv6_backward_scratch(int B, int S, int H, int hd, long long* floats) {
  const int L = chunk_of(hd);
  if (L < 0) return cudaErrorInvalidValue;
  const long long n_chunks = (static_cast<long long>(S) + L - 1) / L;
  const long long blocks = static_cast<long long>(B) * H * n_chunks;
  *floats = blocks * (2LL * hd * hd + hd);
  return 0;
}

// r, k, v, w, dy, dr, dk, dv, dw (B, S, H, hd) contiguous, of one type
// (dtype 0: float32, 1: bfloat16), 16-byte aligned; u (H, hd) float32;
// dstate (B, H, hd, hd) float32 or null (zero); du_part (B, H,
// ceil(S / wkv6_backward_chunk(hd)), hd) float32; scratch:
// wkv6_backward_scratch's floats, 16-byte aligned. Launches the three
// phases on the stream; returns 0 or the cudaError_t of a launch. Nothing
// here synchronises or allocates.
int wkv6_backward(const void* r, const void* k, const void* v, const void* w,
                  const float* u, const void* dy, const float* dstate,
                  void* dr, void* dk, void* dv, void* dw, float* du_part,
                  float* scratch, int dtype, int B, int S, int H, int hd,
                  int device, void* stream) {
  if (B < 0 || S < 0 || H <= 0 || (dtype != 0 && dtype != 1) ||
      chunk_of(hd) < 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || S == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(dispatch_hd<float>(hd, r, k, v, w, u, dy, dstate,
                                               dr, dk, dv, dw, du_part,
                                               scratch, B, S, H, s));
  return static_cast<int>(dispatch_hd<__nv_bfloat16>(
      hd, r, k, v, w, u, dy, dstate, dr, dk, dv, dw, du_part, scratch, B, S,
      H, s));
}

// The dynamic shared memory of phase 1 or 3 (0 for phase 2) at head dim
// hd, or -1.
int wkv6_backward_phase_smem_bytes(int hd, int phase) {
  switch (hd) {
    case 16: return phase_smem<16>(phase);
    case 32: return phase_smem<32>(phase);
    case 64: return phase_smem<64>(phase);
    case 128: return phase_smem<128>(phase);
    default: return -1;
  }
}

// The largest dynamic shared memory of the three phases at head dim hd,
// or -1.
int wkv6_backward_smem_bytes(int hd) {
  const int a = wkv6_backward_phase_smem_bytes(hd, 1);
  const int b = wkv6_backward_phase_smem_bytes(hd, 3);
  return a > b ? a : b;
}

}  // extern "C"
