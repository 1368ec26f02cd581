// GQA flash attention, forward, for Hopper (sm_90a).
//
// Replaces flash_attention_pallas (src/repro/kernels/flash_attention.py,
// body _kernel): out = softmax(q k^T / sqrt(hd) + mask) v for q
// (B, Sq, H, hd) and k, v (B, Sk, KV, hd), query head h reading KV head
// h / (H / KV); the masks are built from positions, as the TPU kernel
// builds them: key j < Sk, causal j <= i, window j > i - window. Masked
// scores are a large finite negative, as in the TPU kernel, so a tile in
// which a row has no valid key adds exp(0) terms that the first tile with a
// valid key clears (corr = exp(m_prev - m_new) = 0). The softmax is online
// and in float32; the output is written in the input type. hd is 32, 64,
// 128 or 256. Both paths read q, k and v through their (batch, sequence,
// head) strides: no copy of K/V per query head, no transpose, no padding.
//
// Bound on the H100: the operations. At the serving path's shape (bf16,
// B 4, S 2048, H 40, KV 10, hd 128, causal) the valid (query, key) pairs
// need 4 B H hd S (S + 1) / 2 = 1.72e11 FLOP, 0.174 ms at the bf16
// tensor-core rate of 989 TFLOP/s, against 84 MB of bytes (0.025 ms at
// 3.35 TB/s). Only the tensor cores, kept fed and kept busy while the
// softmax runs, come near that; the softmax itself (one ex2 per score on
// 16 lanes per SM) would take half the products' time if it ran alone.
// At gemma3-12b's (B 4, S 2048, H 16, KV 8, hd 256) the causal global
// layers need 1.375e11 FLOP (0.139 ms) and the local layers' window of
// 1024 1.031e11 (0.104 ms), against about 201 MB (0.060 ms): the
// operations again, and with twice the products per score the softmax
// weighs half as much.
//
// bfloat16: a persistent, warp-specialised wgmma kernel fed by TMA
// (namespace hopper).
//   * Work: one item per (128-row query tile, head, batch), the query tiles
//     longest first, so the causal items with most KV tiles start first.
//     One block per SM walks items j, j + gridDim.x, ...; the K/V ring and
//     the barriers' phases run on across items, and Q has its own
//     full/empty pair, so the next item's Q and first K/V tiles load while
//     this item finishes.
//   * Warps: three warpgroups. The producer gives up registers (setmaxnreg
//     24) and one of its threads issues every TMA load. The two consumers
//     take them (setmaxnreg 240) and own 64 query rows each.
//   * TMA: one tensor map each for q, k and v, rank 4 over (hd, S, heads,
//     B) with the tensors' own strides, built on the host with
//     cuTensorMapEncodeTiled (reached through cudaGetDriverEntryPoint, so
//     no -lcuda). A box is 128 rows of 64 bf16 (one 128-byte swizzle row;
//     hd 128 takes two boxes per tile) or, at hd 32, of 32 bf16 with the
//     64-byte swizzle. Rows past Sq or Sk come in as zeros (out-of-bounds
//     fill), so the ragged edges need no padding copy. K and V come in a
//     ring of two stages of K/V tiles (Tile<HD>::kKeys keys: 128, or 64 at
//     hd 256), with full and empty barriers for K and for V apart: K of a
//     stage is released once S has read it, V once P V has. At hd 128 that
//     is 32 KB of Q and 2 x 64 KB of K/V; at hd 256, 64 KB of Q and 2 x 64
//     KB of 64-key K/V (128-key tiles would need 256 KB): one block per SM.
//   * S = Q K^T: per tile, hd / 16 wgmma m64n{kKeys}k16 (bf16 in, float32
//     accumulator in registers), A = Q and B = K both K-major from shared
//     memory as they lie.
//   * O += P V: P is rounded to bf16 in registers (as SDPA does), and the
//     m64n{kKeys} accumulator fragment is the A-register fragment of the
//     next wgmma (m64n{hd}k16, kKeys / 16 per tile; at hd 256 two m64n128
//     halves, so a consumer holds 128 + 32 + 16 registers of O, S and P);
//     B = V from shared memory, MN-major through the descriptor's
//     transpose bit, so V is never transposed.
//   * Overlap: a consumer issues tile i's S together with tile i - 1's
//     P V, then runs tile i's softmax while P V runs. The two consumers
//     take turns to issue (named barriers: ping-pong), so one's softmax
//     overlaps the other's products.
//   * Softmax in registers: the mask only on the tiles that need it (the
//     diagonal, the window's edge, the ragged last tile), against limits
//     relative to the thread's first column; tiles that every row of an
//     item masks are never loaded; row max over the accumulator layout and
//     a quad shuffle; p = 2^(s c - m c) in one FFMA and one ex2; the row
//     sum kept per thread and reduced once per item.
//   * Epilogue: O / l from registers, bf16 stores of rows below Sq; when
//     asked (lse not null: the train path), each row's log-sum-exp in
//     base 2, m scale_log2 + log2(l), for the backward.
//
// The Hopper helpers (mbarriers, TMA, wgmma) are in hopper.cuh, which the
// backward (flash_attention_bwd.cu) includes too.
//
// float32: the SIMT kernel (flash_fwd_kernel), kept for the float32
// checks (2e-4 / 2e-5), which TF32 tensor cores could not meet (at hd 256
// its 198,656 B of shared memory allow one block per SM). One block
// per (query tile of 64 rows, head, batch); per KV tile of 64 keys the
// block stages K and V in shared memory, forms the 64 x 64 scores, updates
// the online softmax, stages P in shared memory (over K's tile) and adds
// P V, all on the float32 pipes (67 TFLOP/s at most), with m, l and the
// accumulator in registers. 256 threads as 16 x 16: thread (ty, tx) owns
// query rows 4 ty .. 4 ty + 3, score columns tx + 16 j (j < 4) and
// accumulator columns tx + 16 c (c < hd / 16). Rows of Q and K are padded
// by 4 floats, so the float4 reads along hd of 8 consecutive rows fall in
// distinct banks. KV tiles that the masks empty for every row of the
// query tile are skipped.

#include <cmath>

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32: the SIMT kernel
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 256;    // 16 x 16
constexpr float kNegInf = -1e30f;
constexpr double kLog2e = 1.4426950408889634;

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

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

// Blocks per SM that the shared memory allows: two below hd 256, one at
// hd 256 (Smem<256>::kBytes is 198,656 B), which also lets a thread keep
// its 4 x 16 accumulator in up to 255 registers
template <int HD>
constexpr int kMinBlocks = HD > 128 ? 1 : 2;

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, kMinBlocks<HD>)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, Strides qs,
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
    // the row's log-sum-exp in base 2 (m is scaled here); +inf for a row
    // that no key is kept for
    if (lse != nullptr && tx == 0)
      lse[(static_cast<long long>(b) * gridDim.y + h) * Sq + qp] =
          m[i] == kNegInf ? INFINITY : m[i] + log2f(l[i]);
    const float denom = fmaxf(l[i], 1e-30f);
    T* o = out + b * os.b + static_cast<long long>(qp) * os.s + h * os.h;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      o[tx + 16 * c] = from_f32<T>(acc[i][c] / denom);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, Strides qs, Strides ks, Strides vs,
                   Strides os, int B, int Sq, int Sk, int H, int group,
                   int causal, int window, float scale_log2,
                   cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<HD>::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, Smem<HD>::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, qs, ks, vs, os,
      Sq, Sk, group, causal, window, scale_log2);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        void* out, float* lse, Strides qs, Strides ks,
                        Strides vs, Strides os, int B, int Sq, int Sk, int H,
                        int group, int causal, int window, float scale_log2,
                        cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, out, lse, qs, ks, vs, os, B, Sq, Sk, H,
                           group, causal, window, scale_log2, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, lse, qs, ks, vs, os, B, Sq, Sk, H,
                           group, causal, window, scale_log2, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, lse, qs, ks, vs, os, B, Sq, Sk, H,
                            group, causal, window, scale_log2, stream);
    case 256:
      return launch<T, 256>(q, k, v, out, lse, qs, ks, vs, os, B, Sq, Sk, H,
                            group, causal, window, scale_log2, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bfloat16: warp-specialised wgmma + TMA
// ---------------------------------------------------------------------------

namespace hopper {

constexpr int kRows = 128;       // query rows per work item
constexpr int kConsumers = 2;    // warpgroups of 64 query rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kStages = 2;       // K/V ring
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
// a masked score: finite, like the TPU kernel's -1e30, and a power of two
// (-2^100), so that scaling it is exact
constexpr float kMasked = -1.2676506002282294e30f;

// the tiles' swizzle (kBox, kBoxes, kRowBytes, kSbo) and their sizes
template <int HD>
struct Tile : Swizzle<HD> {
  using Swizzle<HD>::kBox;
  using Swizzle<HD>::kBoxes;
  using Swizzle<HD>::kRowBytes;
  // keys per K/V tile: 128, or 64 at hd 256, where a 64 KB Q tile and two
  // stages of 128-key K and V tiles (256 KB) would not fit in 227 KB
  static constexpr int kKeys = HD > 128 ? 64 : kRows;
  static constexpr int kQBoxBytes = kRows * kRowBytes;
  static constexpr int kKVBoxBytes = kKeys * kRowBytes;
  static constexpr int kQBytes = kBoxes * kQBoxBytes;    // one Q tile
  static constexpr int kKVBytes = kBoxes * kKVBoxBytes;  // one K or V tile
  static constexpr int kScores = kKeys / 2;  // S accumulator floats a thread
  static constexpr int kSteps = kKeys / 16;  // k16 steps of P V per tile
};

// Q, the K stages, the V stages, their barriers, and room to align the
// tiles to 1024 bytes (the 128-byte swizzle's period): 197,760 B at hd 256
template <int HD>
constexpr int kSmemBytes = 1024 + Tile<HD>::kQBytes +
                           2 * kStages * Tile<HD>::kKVBytes + 128;

// S = Q K^T for one warpgroup's 64 rows and a K tile of kKeys keys, both
// K-major; the k-th 16 of hd sit in box 16 k / kBox of each
template <int HD>
__device__ __forceinline__ void issue_s(float (&sc)[Tile<HD>::kScores],
                                        uint32_t q_wg, uint32_t k_st) {
  using T = Tile<HD>;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t box = kk * 16 / T::kBox, col = (kk * 16 % T::kBox) * 2;
    const uint64_t da = smem_desc<HD>(q_wg + box * T::kQBoxBytes + col, 16,
                                      T::kSbo);
    const uint64_t db = smem_desc<HD>(k_st + box * T::kKVBoxBytes + col, 16,
                                      T::kSbo);
    if constexpr (T::kKeys == 128) {
      wgmma_ss_n128(sc, da, db, kk);
    } else {
      wgmma_ss_n64(sc, da, db, kk);
    }
  }
}

// O += P V, V MN-major: the kk-th 16 keys are 16 rows of the tile, the
// boxes along hd T::kKVBoxBytes apart
template <int HD>
__device__ __forceinline__ void issue_pv(
    float (&o)[HD / 2], const uint32_t (&pa)[Tile<HD>::kSteps][4],
    uint32_t v_st) {
  using T = Tile<HD>;
#pragma unroll
  for (int kk = 0; kk < T::kSteps; ++kk)
    wgmma_pv<HD>(o, pa[kk], v_st + kk * 16 * T::kRowBytes, T::kKVBoxBytes);
}

// The running softmax state of a thread's two rows.
struct Rows {
  float m0, m1;        // running max of the unscaled scores
  float l0, l1;        // this thread's share of the running sums
  float c0, c1;        // the last tile's rescaling of the earlier terms
};

// One tile's scores (N keys) become P (float32, in sc): p = 2^(s
// scale_log2 - m scale_log2) with scale_log2 = log2(e) / sqrt(hd), one FFMA
// and one ex2 per score; m is kept unscaled. The mask is applied only where
// some (row, key) pair of the warpgroup fails it, against limits relative
// to this thread's first column, so the N / 2 column offsets stay
// immediates. row / col: the accumulator layout's first row and column of
// this thread.
template <int N>
__device__ __forceinline__ void softmax_tile(float (&sc)[N / 2], Rows& r,
                                             bool masked, int k0, int row,
                                             int col, int Sk, int causal,
                                             int window, float scale_log2) {
  if (masked) {
    const int first = k0 + col;                // key of this thread's column 0
    const int n_keys = Sk - first;             // columns c < n_keys exist
    const int last0 = row - first;             // causal: c <= last
    const int last1 = last0 + 8;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + (e & 1);
        const int last = (e >> 1) ? last1 : last0;
        bool ok = c < n_keys;
        if (causal) ok = ok && c <= last;
        if (window) ok = ok && c > last - window;
        if (!ok) sc[4 * j + e] = kMasked;
      }
    }
  }
  float mx0 = kMasked, mx1 = kMasked;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  // a row's N scores lie on the 4 lanes of a quad
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float n0 = fmaxf(r.m0, mx0), n1 = fmaxf(r.m1, mx1);
  // kMasked scales exactly (a power of two), so a row that has seen only
  // masked scores gets 2^0 = 1 terms, which its first valid score clears
  const float s0 = n0 * scale_log2, s1 = n1 * scale_log2;
  r.c0 = ex2(fmaf(r.m0, scale_log2, -s0));
  r.c1 = ex2(fmaf(r.m1, scale_log2, -s1));
  r.m0 = n0;
  r.m1 = n1;
  float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    sc[4 * j] = ex2(fmaf(sc[4 * j], scale_log2, -s0));
    sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], scale_log2, -s0));
    sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], scale_log2, -s1));
    sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], scale_log2, -s1));
    sum0 += sc[4 * j] + sc[4 * j + 1];
    sum1 += sc[4 * j + 2] + sc[4 * j + 3];
  }
  r.l0 = r.l0 * r.c0 + sum0;
  r.l1 = r.l1 * r.c1 + sum1;
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], const Rows& r) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    o[4 * j] *= r.c0;
    o[4 * j + 1] *= r.c0;
    o[4 * j + 2] *= r.c1;
    o[4 * j + 3] *= r.c1;
  }
}

// One unit of work: a 128-row query tile of one (head, batch), and the
// KV tiles (of KEYS keys) some row of it needs.
struct Work {
  int q0, h, b, t_begin, n_tiles;
};

// Work item w: the query tiles longest first (w / (H B) counts the tile
// index down), then the heads, then the batch.
template <int KEYS>
__device__ __forceinline__ Work work_of(int w, int n_q, int H, int n_b,
                                        int Sk, int causal, int window) {
  Work u;
  const int hb = w % (H * n_b);
  u.q0 = (n_q - 1 - w / (H * n_b)) * kRows;
  u.h = hb % H;
  u.b = hb / H;
  const int k_end = causal ? min(Sk, u.q0 + kRows) : Sk;
  const int k_begin = window ? max(0, u.q0 - window + 1) : 0;
  u.t_begin = k_begin / KEYS;
  u.n_tiles = max(0, (k_end + KEYS - 1) / KEYS - u.t_begin);
  return u;
}

// Persistent: block j takes work items j, j + gridDim.x, ... The K/V ring
// runs on across items (g counts the KV tiles of this block so far), and Q
// has its own full/empty barrier pair, so the producer loads the next
// item's Q and first K/V tiles while the consumers finish this one.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
fa_hopper_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                 Strides os, int Sq, int Sk, int H, int n_b, int group,
                 int causal, int window, float scale_log2) {
  using T = Tile<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  // Q; K of stage s at k_smem + s T::kKVBytes, V likewise; then the 8-byte
  // barriers q_full, q_empty, k_full[s], v_full[s], k_empty[s], v_empty[s]
  const uint32_t q_smem = base;
  const uint32_t k_smem = q_smem + T::kQBytes;
  const uint32_t v_smem = k_smem + kStages * T::kKVBytes;
  const uint32_t q_full = v_smem + kStages * T::kKVBytes;
  const uint32_t q_empty = q_full + 8;
  const uint32_t k_full = q_empty + 8;
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t k_empty = v_full + 8 * kStages;
  const uint32_t v_empty = k_empty + 8 * kStages;
  const int n_q = (Sq + kRows - 1) / kRows;
  const int n_work = n_q * H * n_b;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumers);
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
    // producer: one thread issues every load, K of tile i + 1 before V of
    // tile i, so that S of the next tile can start while P V runs
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers * 128) {
      int g = 0, item = 0;
      for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++item) {
        const Work u =
            work_of<T::kKeys>(w, n_q, H, n_b, Sk, causal, window);
        const int kvh = u.h / group;
        mbar_wait(q_empty, (item & 1) ^ 1);
        mbar_expect_tx(q_full, T::kQBytes);
#pragma unroll
        for (int c = 0; c < T::kBoxes; ++c)
          tma_load(q_smem + c * T::kQBoxBytes, &tm_q, q_full, c * T::kBox,
                   u.q0, u.h, u.b);
        for (int i = 0; i <= u.n_tiles; ++i) {
          if (i < u.n_tiles) {                   // K of tile i
            const int s = (g + i) % kStages;
            mbar_wait(k_empty + 8 * s, (((g + i) / kStages) & 1) ^ 1);
            mbar_expect_tx(k_full + 8 * s, T::kKVBytes);
#pragma unroll
            for (int c = 0; c < T::kBoxes; ++c)
              tma_load(k_smem + s * T::kKVBytes + c * T::kKVBoxBytes, &tm_k,
                       k_full + 8 * s, c * T::kBox,
                       (u.t_begin + i) * T::kKeys, kvh, u.b);
          }
          if (i > 0) {                           // V of tile i - 1
            const int s = (g + i - 1) % kStages;
            mbar_wait(v_empty + 8 * s, (((g + i - 1) / kStages) & 1) ^ 1);
            mbar_expect_tx(v_full + 8 * s, T::kKVBytes);
#pragma unroll
            for (int c = 0; c < T::kBoxes; ++c)
              tma_load(v_smem + s * T::kKVBytes + c * T::kKVBoxBytes, &tm_v,
                       v_full + 8 * s, c * T::kBox,
                       (u.t_begin + i - 1) * T::kKeys, kvh, u.b);
          }
        }
        g += u.n_tiles;
      }
    }
  } else {
    // consumer: 64 query rows of each work item. Tile i's S = Q K^T is
    // issued together with tile i - 1's O += P V; the softmax of tile i
    // runs while P V does.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    // accumulator layout: this thread holds rows `row` and row + 8, columns
    // 8 j + col and 8 j + col + 1 of each 8-column block j
    const int col = 2 * (lane % 4);
    const uint32_t q_wg = q_smem + 64 * wg * T::kRowBytes;
    // Ping-pong: the two consumers take turns to issue their wgmmas
    // (named barriers 1 and 2), so that one's softmax overlaps the other's
    // products; n_tiles + 1 turns per item, consumer 0 first, and the
    // last turn of the block hands over to no one
    int turns = 0;
    for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
      const int n =
          work_of<T::kKeys>(w, n_q, H, n_b, Sk, causal, window).n_tiles;
      turns += n ? n + 1 : 0;
    }
    if (wg == 1 && turns > 0) bar_arrive(1);
    auto turn_begin = [&]() { bar_sync(1 + wg); };
    auto turn_end = [&]() {
      if (--turns > 0 || wg == 0) bar_arrive(2 - wg);
    };
    float o[HD / 2], sc[T::kScores];
    uint32_t pa[T::kSteps][4];
#pragma unroll
    for (int i = 0; i < T::kScores; ++i) sc[i] = 0.0f;
    int g = 0, item = 0;
    for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++item) {
      const Work u = work_of<T::kKeys>(w, n_q, H, n_b, Sk, causal, window);
      const int n = u.n_tiles;
      const int qmin = u.q0 + 64 * wg;           // this warpgroup's rows
      const int row = qmin + 16 * warp + lane / 4;
      // the tiles where some pair of this warpgroup is masked
      auto masked = [&](int k0) {
        return k0 + T::kKeys > Sk || (causal && k0 + T::kKeys - 1 > qmin) ||
               (window && k0 <= qmin + 63 - window);
      };
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
      Rows r{kMasked, kMasked, 0.0f, 0.0f, 1.0f, 1.0f};

      mbar_wait(q_full, item & 1);
      if (n == 0) {
        if (t == 0) mbar_arrive(q_empty);
      } else {
        // tile 0: S only
        const int s0 = g % kStages;
        mbar_wait(k_full + 8 * s0, (g / kStages) & 1);
        turn_begin();
        wgmma_fence();
        issue_s<HD>(sc, q_wg, k_smem + s0 * T::kKVBytes);
        wgmma_commit();
        turn_end();
        wgmma_wait<0>();
        fence_regs(sc);
        if (t == 0) {
          mbar_arrive(k_empty + 8 * s0);
          if (n == 1) mbar_arrive(q_empty);
        }
        softmax_tile<T::kKeys>(sc, r, masked(u.t_begin * T::kKeys),
                               u.t_begin * T::kKeys, row, col, Sk, causal,
                               window, scale_log2);
        pack_p(pa, sc);
        for (int i = 1; i < n; ++i) {
          const int gi = g + i;
          const int s = gi % kStages, sp = (gi - 1) % kStages;
          const int k0 = (u.t_begin + i) * T::kKeys;
          mbar_wait(k_full + 8 * s, (gi / kStages) & 1);
          mbar_wait(v_full + 8 * sp, ((gi - 1) / kStages) & 1);
          turn_begin();
          wgmma_fence();
          issue_s<HD>(sc, q_wg, k_smem + s * T::kKVBytes);
          wgmma_commit();
          issue_pv<HD>(o, pa, v_smem + sp * T::kKVBytes);
          wgmma_commit();
          turn_end();
          wgmma_wait<1>();                       // S of tile i
          fence_regs(sc);
          if (t == 0) {
            mbar_arrive(k_empty + 8 * s);
            if (i == n - 1) mbar_arrive(q_empty);
          }
          softmax_tile<T::kKeys>(sc, r, masked(k0), k0, row, col, Sk, causal,
                                 window, scale_log2);
          wgmma_wait<0>();                       // P V of tile i - 1
          fence_regs(o);
          fence_pa(pa);
          if (t == 0) mbar_arrive(v_empty + 8 * sp);
          rescale(o, r);
          pack_p(pa, sc);
        }
        const int gl = g + n - 1, sl = gl % kStages;
        mbar_wait(v_full + 8 * sl, (gl / kStages) & 1);
        turn_begin();
        wgmma_fence();
        issue_pv<HD>(o, pa, v_smem + sl * T::kKVBytes);
        wgmma_commit();
        turn_end();
        wgmma_wait<0>();
        fence_regs(o);
        fence_pa(pa);
        if (t == 0) mbar_arrive(v_empty + 8 * sl);
      }
      g += n;

#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        r.l0 += __shfl_xor_sync(0xffffffffu, r.l0, off);
        r.l1 += __shfl_xor_sync(0xffffffffu, r.l1, off);
      }
      // the rows' log-sum-exp in base 2, in the backward's convention:
      // m scale_log2 + log2(l), +inf for a row that no key is kept for
      if (lse != nullptr && col == 0) {
        float* lb = lse + (static_cast<long long>(u.b) * H + u.h) * Sq;
        if (row < Sq)
          lb[row] = r.m0 == kMasked ? INFINITY
                                    : fmaf(r.m0, scale_log2, log2f(r.l0));
        if (row + 8 < Sq)
          lb[row + 8] = r.m1 == kMasked ? INFINITY
                                        : fmaf(r.m1, scale_log2, log2f(r.l1));
      }
      const float i0 = 1.0f / fmaxf(r.l0, 1e-30f);
      const float i1 = 1.0f / fmaxf(r.l1, 1e-30f);
      __nv_bfloat16* ob = out + u.b * os.b + u.h * os.h + col;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        if (row < Sq)
          *reinterpret_cast<__nv_bfloat162*>(
              ob + static_cast<long long>(row) * os.s + 8 * j) =
              __floats2bfloat162_rn(o[4 * j] * i0, o[4 * j + 1] * i0);
        if (row + 8 < Sq)
          *reinterpret_cast<__nv_bfloat162*>(
              ob + static_cast<long long>(row + 8) * os.s + 8 * j) =
              __floats2bfloat162_rn(o[4 * j + 2] * i1, o[4 * j + 3] * i1);
      }
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, Strides qs, Strides ks, Strides vs, Strides os, int B,
           int Sq, int Sk, int H, int KV, int causal, int window,
           float scale_log2, cudaStream_t stream) {
  EncodeTiled encode;
  cudaError_t err = encoder(&encode);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  // a map needs extents >= 1; with Sk == 0 no tile is loaded
  constexpr int kKeys = Tile<HD>::kKeys;
  int rc = make_map<HD>(&tq, encode, q, Sq, H, B, qs, kRows);
  if (rc == 0)
    rc = make_map<HD>(&tk, encode, k, max(Sk, 1), KV, B, ks, kKeys);
  if (rc == 0)
    rc = make_map<HD>(&tv, encode, v, max(Sk, 1), KV, B, vs, kKeys);
  if (rc != 0) return rc;
  // persistent: one block per SM, or fewer when there is less work
  int device = 0, n_sm = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return err;
  const int n_work = (Sq + kRows - 1) / kRows * H * B;
  const int grid = min(n_work, n_sm);
  auto kernel = fa_hopper_kernel<HD>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes<HD>);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, kSmemBytes<HD>, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), lse, os, Sq, Sk, H, B,
      H / KV, causal, window, scale_log2);
  return cudaGetLastError();
}

int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                void* out, float* lse, Strides qs, Strides ks, Strides vs,
                Strides os, int B, int Sq, int Sk, int H, int KV, int causal,
                int window, float scale_log2, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<32>(q, k, v, out, lse, qs, ks, vs, os, B, Sq, Sk, H, KV,
                        causal, window, scale_log2, stream);
    case 64:
      return launch<64>(q, k, v, out, lse, qs, ks, vs, os, B, Sq, Sk, H, KV,
                        causal, window, scale_log2, stream);
    case 128:
      return launch<128>(q, k, v, out, lse, qs, ks, vs, os, B, Sq, Sk, H, KV,
                         causal, window, scale_log2, stream);
    case 256:
      return launch<256>(q, k, v, out, lse, qs, ks, vs, os, B, Sq, Sk, H, KV,
                         causal, window, scale_log2, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace hopper

// blocks of `kernel` per SM at `threads` threads and `smem` bytes of
// dynamic shared memory (the attribute set first, as a launch sets it)
template <typename Kernel>
int occupancy(Kernel kernel, int threads, int smem, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                        threads, smem);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// q (B, Sq, H, hd), k and v (B, Sk, KV, hd), out (B, Sq, H, hd), all of one
// type (dtype 0: float32, the SIMT kernel; 1: bfloat16, the wgmma kernel),
// hd contiguous; lse null, or float32 (B, H, Sq) for each row's
// log-sum-exp in base 2 (log2 of the sum over the kept keys of
// 2^(s log2(e) / sqrt(hd)), +inf for a row with no key kept), which the
// backward takes; *_sb, *_ss, *_sh are the batch, sequence and head strides
// in elements (bf16: multiples of 8, addresses 16-byte aligned, as TMA
// needs). Returns 0, the cudaError_t of the launch, or 10000 + the CUresult
// of a failed tensor-map encoding. Nothing here synchronises or allocates.
int fa_forward(const void* q, const void* k, const void* v, void* out,
               float* lse, int dtype, int B, int Sq, int Sk, int H, int KV,
               int hd,
               long long q_sb, long long q_ss, long long q_sh,
               long long k_sb, long long k_ss, long long k_sh,
               long long v_sb, long long v_ss, long long v_sh,
               long long o_sb, long long o_ss, long long o_sh,
               int causal, int window, int device, void* stream) {
  if (B < 0 || Sq < 0 || Sk < 0 || H <= 0 || KV <= 0 || H % KV != 0 ||
      window < 0 || (dtype != 0 && dtype != 1) ||
      (hd != 32 && hd != 64 && hd != 128 && hd != 256) || H > 65535 || B > 65535 ||
      static_cast<long long>((Sq + 127) / 128) * H * B > 0x7fffffff)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || Sq == 0) return 0;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  const float scale_log2 =
      static_cast<float>(kLog2e / std::sqrt(static_cast<double>(hd)));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(dispatch_hd<float>(hd, q, k, v, out, lse, qs, ks,
                                               vs, os, B, Sq, Sk, H, H / KV,
                                               causal, window, scale_log2, s));
  return hopper::dispatch_hd(hd, q, k, v, out, lse, qs, ks, vs, os, B, Sq, Sk,
                             H, KV, causal, window, scale_log2, s);
}

// The dynamic shared memory a bfloat16 launch of fa_forward asks for, or
// -1 for a head dim it does not take.
int fa_smem_bytes(int hd) {
  switch (hd) {
    case 32:
      return hopper::kSmemBytes<32>;
    case 64:
      return hopper::kSmemBytes<64>;
    case 128:
      return hopper::kSmemBytes<128>;
    case 256:
      return hopper::kSmemBytes<256>;
    default:
      return -1;
  }
}

// Blocks of a launch of fa_forward (dtype 0: float32, 1: bfloat16) at head
// dim hd that fit on one SM together, by cudaOccupancyMaxActiveBlocksPer-
// Multiprocessor with the launch's dynamic shared memory, into *blocks.
// Returns 0 or the cudaError_t (cudaErrorInvalidValue for an hd or dtype
// fa_forward does not take).
int fa_blocks_per_sm(int dtype, int hd, int* blocks) {
  switch (dtype * 1000 + hd) {
    case 32:
      return occupancy(flash_fwd_kernel<float, 32>, kThreads,
                       Smem<32>::kBytes, blocks);
    case 64:
      return occupancy(flash_fwd_kernel<float, 64>, kThreads,
                       Smem<64>::kBytes, blocks);
    case 128:
      return occupancy(flash_fwd_kernel<float, 128>, kThreads,
                       Smem<128>::kBytes, blocks);
    case 256:
      return occupancy(flash_fwd_kernel<float, 256>, kThreads,
                       Smem<256>::kBytes, blocks);
    case 1032:
      return occupancy(hopper::fa_hopper_kernel<32>, hopper::kThreads,
                       hopper::kSmemBytes<32>, blocks);
    case 1064:
      return occupancy(hopper::fa_hopper_kernel<64>, hopper::kThreads,
                       hopper::kSmemBytes<64>, blocks);
    case 1128:
      return occupancy(hopper::fa_hopper_kernel<128>, hopper::kThreads,
                       hopper::kSmemBytes<128>, blocks);
    case 1256:
      return occupancy(hopper::fa_hopper_kernel<256>, hopper::kThreads,
                       hopper::kSmemBytes<256>, blocks);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
