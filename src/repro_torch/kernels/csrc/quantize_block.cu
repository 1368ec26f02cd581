// Block-wise stochastic quantizer kernels for Hopper (sm_90a).
//
// Three kernels, the CUDA counterparts of the Pallas kernels in
// src/repro/kernels/quantize_block.py:
//
//   qb_quantize       replaces quantize_grouped_pallas (_dequant_kernel and
//                     _dequant_kernel_rng): fused quantize -> dequantize.
//   qb_encode         replaces quantize_encode_grouped_pallas (_encode_kernel
//                     and _encode_kernel_rng): int8 codes + one f32 scale
//                     per group; the dequantized array is never written.
//   qb_decode_reduce  replaces decode_reduce_grouped_pallas
//                     (_decode_reduce_kernel): sum_c w_c * dequant(codes_c,
//                     scales_c) with c walked in order inside the thread;
//                     for a bf16 leaf each dequantized element is first
//                     rounded to bf16, as decode rounds it to the leaf's
//                     dtype (the reference keeps such leaves off its
//                     kernel and reduces the decoded stack).
//
// Layout (all three): an (R, D) row-major view whose quantization groups of
// g elements run along the last axis (D % g == 0). qb_quantize and
// qb_encode take g a multiple of 128 (quant_kernel) or a power of two
// below 128 (small_quant_kernel: the shard-safe groups of LM-width
// leaves); qb_decode_reduce takes multiples of 128. Because D % g == 0 the
// groups are contiguous g-element chunks of the flat stream, group G starts
// at flat element G * g, and its scale sits at scales[G]. The kernels work
// on that flat numbering and never need R or D separately.
//
// Bit-exactness against the plain PyTorch versions (and the JAX oracles):
//   * FMA contraction: y = x / safe * levels followed by y - floor(y) must
//     not be contracted into fma(x / safe, levels, -lo): the fused form
//     keeps the unrounded product and changes the fraction, which flips
//     codes. The same holds for acc + w * deq in the reduce. Every float
//     operation below is an explicit round-to-nearest intrinsic
//     (__fdiv_rn, __fmul_rn, __fadd_rn, __fsub_rn), and the library is
//     also built with -fmad=false. Never build with --use_fast_math.
//   * The division is IEEE div.rn.f32 (__fdiv_rn), not the approximate
//     reciprocal.
//   * The dequantize multiplies by the float32 reciprocal 1/levels, in the
//     order (q * safe) * inv_levels; it does not divide by levels.
//   * The in-kernel dither is the murmur3 finalizer of the global element
//     index, in uint32_t arithmetic that wraps at 32 bits exactly as the
//     reference's uint32 jnp arithmetic does. It is therefore bit-identical
//     to the streamed "hash" dither (core/compression.py:hash_dither).
//   * Codes are int8 in [-levels, levels]; the float -> int8 conversion of
//     an integral float in that range is exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                 // 8 warps per block
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kReduceElems = 16;              // elements per thread (reduce)
constexpr int kHeld = 2;                      // chunks kept in registers

// x rounded to the nearest bfloat16 (ties to even), as a float: what
// torch's float32 -> bfloat16 conversion gives. An infinity stays one and a
// NaN stays a NaN (adding at most 0x8000 to a NaN's bits cannot clear its
// exponent, and its payload keeps a bit in the upper half).
__device__ __forceinline__ float round_to_bf16(float x) {
  uint32_t u = __float_as_uint(x);
  u += 0x7FFFu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xFFFF0000u);
}

__device__ __forceinline__ uint32_t murmur_u32(uint32_t idx, uint32_t seed) {
  // uint32_t: every multiply and add wraps mod 2^32, like the reference
  uint32_t h = idx * 2654435761u + seed;
  h = (h ^ (h >> 16)) * 0x7FEB352Du;
  h = (h ^ (h >> 15)) * 0x846CA68Bu;
  return h ^ (h >> 16);
}

__device__ __forceinline__ float hash_uniform(uint32_t idx, uint32_t seed) {
  // top 24 bits -> [0, 1): the conversion and the power-of-two scale are
  // both exact
  return __fmul_rn(static_cast<float>(murmur_u32(idx, seed) >> 8),
                   5.9604644775390625e-08f);
}

// max that propagates NaN, like jnp.max (fmaxf would drop it)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  return m;
}

// the stochastic rounding of one element: q = floor(y) + [u < y - floor(y)]
// with y = (x / safe) * levels, each operation rounded on its own
__device__ __forceinline__ float quant_code(float x, float u, float safe,
                                            float levels) {
  // IEEE division (div.rn.f32), then a separately rounded multiply: a
  // contracted fma(x / safe, levels, -lo) would change the fraction below
  const float y = __fmul_rn(__fdiv_rn(x, safe), levels);
  const float lo = floorf(y);
  return __fadd_rn(lo, (u < __fsub_rn(y, lo)) ? 1.0f : 0.0f);
}

// max-abs of the four lanes of t folded into m, in order
__device__ __forceinline__ float max4(float m, float4 t) {
  m = nan_max(nan_max(m, fabsf(t.x)), fabsf(t.y));
  return nan_max(nan_max(m, fabsf(t.z)), fabsf(t.w));
}

// Round the four elements t at flat offset off and store them: the
// dequantized floats, or their int8 codes.
template <bool ENCODE, bool SEEDED>
__device__ __forceinline__ void round_store(
    float4 t, long long off, const float* __restrict__ u,
    float* __restrict__ out, int8_t* __restrict__ codes, uint32_t seed,
    float safe, bool live, float levels, float inv_levels) {
  const float v[4] = {t.x, t.y, t.z, t.w};
  float d[4];
  if (SEEDED) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      d[j] = hash_uniform(static_cast<uint32_t>(off + j), seed);
  } else {
    const float4 r = *reinterpret_cast<const float4*>(u + off);
    d[0] = r.x; d[1] = r.y; d[2] = r.z; d[3] = r.w;
  }
  float q[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) q[j] = quant_code(v[j], d[j], safe, levels);
  if (ENCODE) {
    // q is an integer in [-levels, levels]: the int8 cast is exact
    char4 c;
    c.x = static_cast<signed char>(q[0]);
    c.y = static_cast<signed char>(q[1]);
    c.z = static_cast<signed char>(q[2]);
    c.w = static_cast<signed char>(q[3]);
    *reinterpret_cast<char4*>(codes + off) = c;
  } else {
    float4 o;
    // (q * safe) * inv_levels: a multiply by the float32 reciprocal, in
    // that order, never a division by levels; zero where the scale is 0
    o.x = live ? __fmul_rn(__fmul_rn(q[0], safe), inv_levels) : 0.0f;
    o.y = live ? __fmul_rn(__fmul_rn(q[1], safe), inv_levels) : 0.0f;
    o.z = live ? __fmul_rn(__fmul_rn(q[2], safe), inv_levels) : 0.0f;
    o.w = live ? __fmul_rn(__fmul_rn(q[3], safe), inv_levels) : 0.0f;
    *reinterpret_cast<float4*>(out + off) = o;
  }
}

// Quantize -> dequantize (ENCODE = false) or encode (ENCODE = true).
//
// Design: one warp per group of g elements, g any multiple of 128. The
// warp walks the group in 128-element chunks: lane l owns the float4 at
// offset 4 * l of each chunk, so every load and store of the warp covers
// 512 contiguous bytes. Pass 1 reads the chunks for the group's max-abs,
// a warp shuffle reduction; pass 2 rounds each element and stores either
// the dequantized floats or the int8 codes, and lane 0 stores the group's
// scale. The first kHeld chunks stay in registers between the passes, and
// their loads are all issued before the first max: at g <= 256 (the main
// path) x is read once with two loads in flight per lane. Chunks past
// them are read again in pass 2, from L1 (the warp read them a moment
// ago). The dither is either streamed (u, read like x) or made here from
// the element index (SEEDED).
//
// Bound on the H100 (3.35 TB/s), at the main path's n = 91,750,400 and
// g = 256: quantize->dequantize reads x (and u) and writes 4 n bytes:
// 12 n = 1.10 GB, 0.329 ms streamed; 8 n = 734 MB, 0.219 ms seeded.
// Encode writes n code bytes and 4 n / g scale bytes instead: 9 n + 4 n/g
// = 827 MB, 0.247 ms streamed; 5 n + 4 n/g = 460 MB, 0.137 ms seeded.
// Memory bound: about 11 float operations per element (plus about 12
// integer operations for the hash) against 4-12 bytes moved.
template <bool ENCODE, bool SEEDED>
__global__ void __launch_bounds__(kThreads)
quant_kernel(const float* __restrict__ x, const float* __restrict__ u,
             float* __restrict__ out, int8_t* __restrict__ codes,
             float* __restrict__ scales, long long n_groups, int group,
             uint32_t seed, float levels, float inv_levels) {
  const int lane = threadIdx.x & 31;
  const long long grp =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (grp >= n_groups) return;  // the whole warp leaves together
  const long long base = grp * group + lane * 4;
  const int n_held = min(group / 128, kHeld);

  float4 held[kHeld];
#pragma unroll
  for (int c = 0; c < kHeld; ++c)
    if (c < n_held)
      held[c] = *reinterpret_cast<const float4*>(x + base + c * 128);
  float m = 0.0f;
#pragma unroll
  for (int c = 0; c < kHeld; ++c)
    if (c < n_held) m = max4(m, held[c]);
  for (int k = kHeld * 128; k < group; k += 128)
    m = max4(m, *reinterpret_cast<const float4*>(x + base + k));
  const float scale = warp_max(m);
  const bool live = scale > 0.0f;
  const float safe = live ? scale : 1.0f;

#pragma unroll
  for (int c = 0; c < kHeld; ++c)
    if (c < n_held)
      round_store<ENCODE, SEEDED>(held[c], base + c * 128, u, out, codes,
                                  seed, safe, live, levels, inv_levels);
  for (int k = kHeld * 128; k < group; k += 128)
    round_store<ENCODE, SEEDED>(
        *reinterpret_cast<const float4*>(x + base + k), base + k, u, out,
        codes, seed, safe, live, levels, inv_levels);
  if (ENCODE && lane == 0) scales[grp] = scale;
}

// Decode + weighted client reduce.
//
// Design: one thread per 16 consecutive output elements (they share one
// group, since g is a multiple of 128), 256 threads per block, so a block
// owns a 4096-element output tile. The thread walks c = 0 .. C-1 in order,
// reading one 16-byte vector of codes and one scale per client and keeping
// the 16 partial sums in registers: o = w_0 * deq_0, then o = o + w_c *
// deq_c, the reference's order. No atomics, no shared memory: the result
// is deterministic and the decoded C-client stack never exists in memory.
//
// round_bf16 (a bf16 leaf): each dequantized element is rounded to bf16
// before its weight multiplies it, so the sum is decode's bf16 stack
// reduced in float32; the flag is uniform over the grid.
//
// Bound on the H100 (3.35 TB/s): C (n + 4 n / g) bytes read, 4 n written;
// at n = 91,750,400, g = 256, C = 16 that is 20.25 n = 1.86 GB, 0.555 ms.
// Memory bound: 6 float operations per element and client.
__global__ void __launch_bounds__(kThreads)
decode_reduce_kernel(const int8_t* __restrict__ codes,
                     const float* __restrict__ scales,
                     const float* __restrict__ w, float* __restrict__ out,
                     int n_clients, long long n, int group, float inv_levels,
                     int round_bf16) {
  const long long e =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) *
      kReduceElems;
  if (e >= n) return;
  const long long n_groups = n / group;
  const long long grp = e / group;
  float acc[kReduceElems];
  for (int c = 0; c < n_clients; ++c) {
    const int4 raw = *reinterpret_cast<const int4*>(codes + c * n + e);
    const int8_t* q = reinterpret_cast<const int8_t*>(&raw);
    const float s = scales[c * n_groups + grp];
    const bool live = s > 0.0f;
    const float safe = live ? s : 1.0f;
    const float wc = w[c];
#pragma unroll
    for (int j = 0; j < kReduceElems; ++j) {
      float deq =
          live ? __fmul_rn(__fmul_rn(static_cast<float>(q[j]), safe),
                           inv_levels)
               : 0.0f;
      if (round_bf16) deq = round_to_bf16(deq);
      const float contrib = __fmul_rn(wc, deq);
      // o = w_0 deq_0, then o = o + w_c deq_c: a separate multiply and add
      // (no fma), and c == 0 assigns rather than adds to 0 (keeps -0.0)
      acc[j] = (c == 0) ? contrib : __fadd_rn(acc[j], contrib);
    }
  }
  float4* o = reinterpret_cast<float4*>(out + e);
#pragma unroll
  for (int j = 0; j < kReduceElems / 4; ++j)
    o[j] = make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2],
                       acc[4 * j + 3]);
}

// Quantize -> dequantize or encode with a power-of-two group g = 2^LOG2G
// below 128.
//
// Design: a warp walks tiles of kSmallChunks chunks of 128 elements of the
// flat stream; a chunk holds 128 / g whole groups, so no group crosses a
// chunk or a tile. Lane l owns the float4 at offset 4 l of each chunk
// (quant_kernel's coalesced layout) and issues the loads of all its
// chunks, and of their streamed dither, before the first max. For g >= 8 a
// group spans g / 4 adjacent lanes, aligned to g / 4, and LOG2G - 2 xor
// shuffles give every lane of the segment the group's max-abs; for g <= 4
// the groups lie inside the lane. Codes go out as one char4 a float4 (128
// contiguous bytes a warp and chunk); the lane holding a group's first
// element stores its scale, so a warp's scale stores are contiguous too.
//
// The group is a template constant, so every / g and % g is a shift or a
// mask and the shuffles unroll. A tile forms its 64-bit base once
// (addresses stay 64-bit: a leaf may hold more than 2^31 elements); inside
// it indices are 32-bit, and the hash index static_cast<uint32_t>(base) +
// local wraps as the element index's low 32 bits do. A grid of about one
// wave (launch_small_g) walks the tiles in a grid-stride loop. Whole tiles
// run with no bounds checks. The last, partial tile, if any, falls to the
// warp whose walk reaches it and takes a guarded path (scalar loads and
// stores; lanes past the end join the shuffles with zeros, stored
// nowhere), which keeps the ragged n of groups 1 and 2 and flat streams
// whose length is not a multiple of 4. The rounding (quant_code) and the
// dither (hash_uniform) are quant_kernel's, so both kernels give the plain
// versions' bits.
//
// Bound on the H100 (3.35 TB/s): as quant_kernel, 5 n + 4 n / g bytes
// encoded with the in-kernel dither: at gemma3-12b's embedding (n =
// 1,006,632,960, g = 8) 5.54 GB, 1.65 ms; at qwen3-moe's expert leaves (n
// = 805,306,368, g = 16) 4.23 GB, 1.26 ms. The work per element (an IEEE
// division with its branch to the slow path, the hash, the rounding: 41
// instructions in the tile loop's SASS) takes about three quarters of that
// time to issue, so the loop keeps its integer work to 32-bit adds, shifts
// and masks. Tiles of 2, 4 and 8 chunks time within 2% of each other on
// the H100; 8 is the fastest, and the one whose 28 instances ptxas builds
// with no spill (tests/torch_small_quant_tiles.py).
constexpr int kSmallChunks = 8;
constexpr int kSmallTile = kSmallChunks * 128;  // elements a warp tile

// The scale of each of a lane's four elements v: the max-abs of its group
// of 2^LOG2G elements, over the lane's segment of g / 4 lanes for g >= 8.
// Every lane of the warp calls it (full-warp shuffles).
template <int LOG2G>
__device__ __forceinline__ void group_scales(const float (&v)[4],
                                             float (&sc)[4]) {
  if (LOG2G >= 2) {
    float m = max4(0.0f, make_float4(v[0], v[1], v[2], v[3]));
#pragma unroll
    for (int o = (1 << LOG2G) / 8; o > 0; o >>= 1)
      m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, o));
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[j] = m;
  } else if (LOG2G == 1) {
    sc[0] = sc[1] = nan_max(nan_max(0.0f, fabsf(v[0])), fabsf(v[1]));
    sc[2] = sc[3] = nan_max(nan_max(0.0f, fabsf(v[2])), fabsf(v[3]));
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[j] = nan_max(0.0f, fabsf(v[j]));
  }
}

// One element's code (ENCODE) or its dequantized value: quant_code, then
// (q * safe) * inv_levels and zero where the scale is 0, as round_store
template <bool ENCODE>
__device__ __forceinline__ float round_one(float x, float d, float sc,
                                           float levels, float inv_levels) {
  const bool live = sc > 0.0f;
  const float safe = live ? sc : 1.0f;
  const float q = quant_code(x, d, safe, levels);
  if (ENCODE) return q;
  return live ? __fmul_rn(__fmul_rn(q, safe), inv_levels) : 0.0f;
}

// The scales of a lane's four elements at offset local of a tile whose
// first scale is st: a float4 (g = 1) or a float2 (g = 2) a lane, else
// one a group, from the lane holding the group's first element
template <int LOG2G>
__device__ __forceinline__ void store_scales(float* st, int local, int lane,
                                             const float (&sc)[4]) {
  constexpr int kSegMask = (1 << LOG2G) / 4 - 1;  // lanes of a group - 1
  if (LOG2G == 0)
    *reinterpret_cast<float4*>(st + local) =
        make_float4(sc[0], sc[1], sc[2], sc[3]);
  else if (LOG2G == 1)
    *reinterpret_cast<float2*>(st + (local >> 1)) = make_float2(sc[0], sc[2]);
  else if ((lane & kSegMask) == 0)
    st[local >> LOG2G] = sc[0];
}

template <bool ENCODE, bool SEEDED, int LOG2G>
__global__ void __launch_bounds__(kThreads)
small_quant_kernel(const float* __restrict__ x, const float* __restrict__ u,
                   float* __restrict__ out, int8_t* __restrict__ codes,
                   float* __restrict__ scales, long long n, uint32_t seed,
                   float levels, float inv_levels) {
  constexpr int kG = 1 << LOG2G;
  const int lane = threadIdx.x & 31;
  const long long whole = n / kSmallTile;  // tiles with no bounds checks
  const long long warps =
      static_cast<long long>(gridDim.x) * kWarpsPerBlock;
  long long tile =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  for (; tile < whole; tile += warps) {
    const long long base = tile * kSmallTile;
    const uint32_t base32 = static_cast<uint32_t>(base);
    float4 t[kSmallChunks], r[kSmallChunks];
#pragma unroll
    for (int c = 0; c < kSmallChunks; ++c)
      t[c] = *reinterpret_cast<const float4*>(x + base + c * 128 + 4 * lane);
    if (!SEEDED) {
#pragma unroll
      for (int c = 0; c < kSmallChunks; ++c)
        r[c] = *reinterpret_cast<const float4*>(u + base + c * 128 + 4 * lane);
    }
#pragma unroll
    for (int c = 0; c < kSmallChunks; ++c) {
      const int local = c * 128 + 4 * lane;
      const float v[4] = {t[c].x, t[c].y, t[c].z, t[c].w};
      float sc[4], d[4], q[4];
      group_scales<LOG2G>(v, sc);
      if (SEEDED) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          d[j] = hash_uniform(base32 + static_cast<uint32_t>(local + j),
                              seed);
      } else {
        d[0] = r[c].x; d[1] = r[c].y; d[2] = r[c].z; d[3] = r[c].w;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        q[j] = round_one<ENCODE>(v[j], d[j], sc[j], levels, inv_levels);
      if (ENCODE) {
        // q is an integer in [-levels, levels]: the int8 cast is exact
        char4 cq;
        cq.x = static_cast<signed char>(q[0]);
        cq.y = static_cast<signed char>(q[1]);
        cq.z = static_cast<signed char>(q[2]);
        cq.w = static_cast<signed char>(q[3]);
        *reinterpret_cast<char4*>(codes + base + local) = cq;
        store_scales<LOG2G>(scales + (base >> LOG2G), local, lane, sc);
      } else {
        *reinterpret_cast<float4*>(out + base + local) =
            make_float4(q[0], q[1], q[2], q[3]);
      }
    }
  }
  // the last, partial tile, on the warp whose walk reaches it
  const int rest = static_cast<int>(n - whole * kSmallTile);
  if (tile != whole || rest == 0) return;
  const long long base = whole * kSmallTile;
  const uint32_t base32 = static_cast<uint32_t>(base);
  for (int c = 0; c * 128 < rest; ++c) {
    const int local = c * 128 + 4 * lane;
    float v[4], sc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = local + j < rest ? x[base + local + j] : 0.0f;
    group_scales<LOG2G>(v, sc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = local + j;
      if (e >= rest) break;
      const float d = SEEDED ? hash_uniform(base32 + static_cast<uint32_t>(e),
                                            seed)
                             : u[base + e];
      const float q = round_one<ENCODE>(v[j], d, sc[j], levels, inv_levels);
      if (ENCODE) {
        codes[base + e] = static_cast<signed char>(q);
        if ((e & (kG - 1)) == 0)
          scales[(base >> LOG2G) + (e >> LOG2G)] = sc[j];
      } else {
        out[base + e] = q;
      }
    }
  }
}

// small_quant_kernel at group 2^LOG2G on a grid of about one wave: the
// device's SMs times the blocks an SM holds at once (read on the first
// launch of the instance and kept), or fewer where the tiles are fewer
template <bool ENCODE, bool SEEDED, int LOG2G>
cudaError_t launch_small_g(const float* x, const float* u, float* out,
                           int8_t* codes, float* scales, long long n,
                           uint32_t seed, float levels, float inv_levels,
                           cudaStream_t stream) {
  static const long long wave = [] {
    int device = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, small_quant_kernel<ENCODE, SEEDED, LOG2G>, kThreads, 0);
    return static_cast<long long>(sms > 0 ? sms : 1) *
           (per_sm > 0 ? per_sm : 1);
  }();
  const long long tiles = (n + kSmallTile - 1) / kSmallTile;
  const long long need = (tiles + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const long long blocks = need < wave ? need : wave;
  small_quant_kernel<ENCODE, SEEDED, LOG2G>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          x, u, out, codes, scales, n, seed, levels, inv_levels);
  return cudaGetLastError();
}

// the group (a power of two below 128) as the template constant LOG2G
template <bool ENCODE, bool SEEDED>
cudaError_t launch_small(const float* x, const float* u, float* out,
                         int8_t* codes, float* scales, long long n, int group,
                         uint32_t seed, float levels, float inv_levels,
                         cudaStream_t stream) {
  using Launch = cudaError_t (*)(const float*, const float*, float*, int8_t*,
                                 float*, long long, uint32_t, float, float,
                                 cudaStream_t);
  const Launch by_log2g[] = {
      launch_small_g<ENCODE, SEEDED, 0>, launch_small_g<ENCODE, SEEDED, 1>,
      launch_small_g<ENCODE, SEEDED, 2>, launch_small_g<ENCODE, SEEDED, 3>,
      launch_small_g<ENCODE, SEEDED, 4>, launch_small_g<ENCODE, SEEDED, 5>,
      launch_small_g<ENCODE, SEEDED, 6>};
  int log2g = 0;
  while ((1 << log2g) < group) ++log2g;
  return by_log2g[log2g](x, u, out, codes, scales, n, seed, levels,
                         inv_levels, stream);
}

template <bool ENCODE, bool SEEDED>
cudaError_t launch_quant(const float* x, const float* u, float* out,
                         int8_t* codes, float* scales, long long n_groups,
                         int group, uint32_t seed, float levels,
                         float inv_levels, cudaStream_t stream) {
  const long long blocks = (n_groups + kWarpsPerBlock - 1) / kWarpsPerBlock;
  quant_kernel<ENCODE, SEEDED>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          x, u, out, codes, scales, n_groups, group, seed, levels,
          inv_levels);
  return cudaGetLastError();
}

// quant_kernel for g a multiple of 128, small_quant_kernel below 128
template <bool ENCODE, bool SEEDED>
cudaError_t launch_grouped(const float* x, const float* u, float* out,
                           int8_t* codes, float* scales, long long rows,
                           long long cols, int group, uint32_t seed,
                           float levels, float inv_levels,
                           cudaStream_t stream) {
  if (group >= 128)
    return launch_quant<ENCODE, SEEDED>(x, u, out, codes, scales,
                                        rows * (cols / group), group, seed,
                                        levels, inv_levels, stream);
  return launch_small<ENCODE, SEEDED>(x, u, out, codes, scales, rows * cols,
                                      group, seed, levels, inv_levels,
                                      stream);
}

bool large_group(int group) { return group >= 128 && group % 128 == 0; }

bool small_group(int group) {
  return group >= 1 && group < 128 && (group & (group - 1)) == 0;
}

// small_ok: the quantize and encode entry points also take small groups
bool bad_shape(long long rows, long long cols, int group, int bits,
               bool small_ok) {
  return rows < 0 || cols <= 0 ||
         !(large_group(group) || (small_ok && small_group(group))) ||
         cols % group != 0 || bits < 2 || bits > 8;
}

float levels_of(int bits) { return static_cast<float>((1 << (bits - 1)) - 1); }

// the float32 rounding of the double 1 / levels, as the reference forms it
float inv_levels_of(int bits) {
  return static_cast<float>(1.0 / static_cast<double>((1 << (bits - 1)) - 1));
}

}  // namespace

extern "C" {

// Each entry point returns 0 on success, or the cudaError_t of the launch
// (cudaGetLastError right after it). Pointers are device pointers; stream
// is the caller's cudaStream_t. Nothing here synchronises or allocates.

int qb_quantize(const float* x, const float* u, float* out, long long rows,
                long long cols, int group, int bits, unsigned int seed,
                int seeded, int device, void* stream) {
  if (bad_shape(rows, cols, group, bits, true)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (rows == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float lv = levels_of(bits), inv = inv_levels_of(bits);
  err = seeded ? launch_grouped<false, true>(x, nullptr, out, nullptr,
                                             nullptr, rows, cols, group,
                                             seed, lv, inv, s)
               : launch_grouped<false, false>(x, u, out, nullptr, nullptr,
                                              rows, cols, group, 0u, lv, inv,
                                              s);
  return static_cast<int>(err);
}

int qb_encode(const float* x, const float* u, int8_t* codes, float* scales,
              long long rows, long long cols, int group, int bits,
              unsigned int seed, int seeded, int device, void* stream) {
  if (bad_shape(rows, cols, group, bits, true)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (rows == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float lv = levels_of(bits), inv = inv_levels_of(bits);
  err = seeded ? launch_grouped<true, true>(x, nullptr, nullptr, codes,
                                            scales, rows, cols, group, seed,
                                            lv, inv, s)
               : launch_grouped<true, false>(x, u, nullptr, codes, scales,
                                             rows, cols, group, 0u, lv, inv,
                                             s);
  return static_cast<int>(err);
}

int qb_decode_reduce(const int8_t* codes, const float* scales, const float* w,
                     float* out, int n_clients, long long rows,
                     long long cols, int group, int bits, int round_bf16,
                     int device, void* stream) {
  if (bad_shape(rows, cols, group, bits, false) || n_clients < 1)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const long long n = rows * cols;
  if (n == 0) return 0;
  const long long per_block = static_cast<long long>(kThreads) * kReduceElems;
  const dim3 grid(static_cast<unsigned>((n + per_block - 1) / per_block));
  decode_reduce_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      codes, scales, w, out, n_clients, n, group, inv_levels_of(bits),
      round_bf16);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
