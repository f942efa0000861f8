// Decode attention for Hopper (sm_90a): one new token per slot against the
// slot's KV cache, read where it lies.
//
// Computes what src/repro/models/layers.py::attention_core computes for
// Sq = 1 with a causal mask (the reference runs it as XLA einsums; it has
// no Pallas kernel): for slot b, kv head h and each of its G query heads,
//
//   s[p]   = (q . k[b, p, h]) / sqrt(D)       bf16 x bf16 products, f32 sum
//            for p < n = min(q_position + 1, kv_valid_len, C)
//   prob   = softmax(s) in f32, rounded to v's type
//   out    = sum_p prob[p] * v[b, p, h]      f32 sum, rounded once
//
// The reference masks p >= n with a score of -2e9; exp(-2e9 - max) is 0
// in f32, so walking only p < n changes nothing.  When n is 0 (every
// score masked) the reference's softmax is uniform over all C positions,
// and so is this kernel's.  Lengths are clamped to [0, C]: an idle slot of
// the decode bucket carries an offset past the end and reads C positions.
//
// Bound on this card: each K and V element of the n valid positions feeds
// 2 * G flops, far below the ~295 flops/byte where an H100 stops being
// memory bound, so the floor is the valid K and V bytes (plus q and out)
// over HBM bandwidth (3.35 TB/s).  The port's first path cast the whole
// cache to f32 every layer (three passes over C positions, valid or not).
//
// Quantized pages (S = 8 or 4, kv_quant.py): k / v hold int8 codes
// [B, C, Hkv, D], or packed int4 [B, C, Hkv, D / 2] (lane 2i in the low
// nibble of byte i, 2i + 1 in the high one), with one f32 scale per
// (slot, position, head) in k_scale / v_scale [B, C, Hkv].  Each element is
// dequantized where it is read, exactly as dequantize_page(..., out_dtype)
// does (T(f32(q) * s)), and then enters the same arithmetic in the same
// order as the fp kernel: the output equals the fp kernel's on
// dequantize_page's tensor bit for bit, while the reads are the codes and
// scales (a half or a quarter of the bf16 bytes), never a dequantized
// copy of the cache.
//
// Design: one CTA (4 warps) per (slot, kv head, split); the `splits` CTAs
// of a (slot, kv head) divide its n positions evenly and form one thread
// block cluster.  A position's D elements are read by D / V lanes as
// 16-byte vectors (V = 8 bf16 or 4 f32), a warp covers 32 V / D positions
// a step and each thread keeps kUnroll vectors in flight; K and V are read
// in place through their strides (a slot-prefix view of the cache runs
// without a copy).  V does not depend on the scores, so at entry the CTA
// starts async copies (cp.async, one commit group) of the V rows of its
// first `stage` positions (their codes and scales on a quantized store)
// into shared memory, then walks K and exchanges the softmax's max and sum
// while they are in flight; the P.V walk reads V from shared memory once
// the group has landed.  `stage` is a whole number of the P.V walk's steps
// (kWarps * 32 V / D * kUnroll positions) whose rows fit kStageBytes, so
// a CTA stays small enough for the grid to stay resident (8 CTAs an SM at
// G <= 2); a split of more positions stages its later chunks in turn,
// each after the last is consumed, and every thread visits its positions
// in the same order as one walk over [lo, hi).  The CTA keeps its scores
// in shared memory; each rank pushes its max, then its sum, then each
// share of its P.V partial [G, D] into the shared memory of every peer
// (of the share's owner) and one cluster.sync() later reads them from its
// own, in rank order: every CTA rounds its probabilities exactly as one
// softmax over all n positions would, and the owner of a share of the
// outputs sums it over the ranks in order.  Three cluster barriers, no
// read of a peer's shared memory, so no barrier before exit; one launch,
// no atomics: the result does not change from run to run, and is the
// first design's bit for bit (its sums ran in the same order).
//
// Plain C interface, loaded with ctypes.  Each entry returns the launch's
// CUDA error (0 when it was taken).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;          // K / V vectors in flight per thread
constexpr int kMinBlocks = 4;       // launch bound: at most 128 registers,
                                    // 64 for G <= 2 (8 CTAs an SM)
constexpr int kMaxSplits = 8;       // the portable cluster size
constexpr int kStageBytes = 24 * 1024;  // V rows staged at a time, at most
constexpr float kBigNeg = -2.0e9f;  // the reference's masked score

__device__ __forceinline__ void store(float v, float* o) { *o = v; }
__device__ __forceinline__ void store(float v, bf16* o) {
  *o = __float2bfloat16_rn(v);
}
// v rounded to T and widened back (the probabilities are cast to v's type)
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const bf16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Bytes a lane reads of one position: V elements of T, or their codes.
template <typename T, int S>
__host__ __device__ constexpr int lane_bytes() {
  return S == 0 ? 16 : S == 8 ? 16 / static_cast<int>(sizeof(T))
                              : 8 / static_cast<int>(sizeof(T));
}

// The unit of the V staging copies: what a lane reads, at least 4 bytes
// (the smallest cp.async).
template <typename T, int S>
__host__ __device__ constexpr int unit_bytes() {
  return lane_bytes<T, S>() < 4 ? 4 : lane_bytes<T, S>();
}

// Bytes of one position's V row: D elements of T, or their codes.
inline int row_bytes(int D, int elem_bytes, int bits) {
  return bits == 16 ? D * elem_bytes : D * bits / 8;
}

// One async copy of BYTES (4, 8 or 16) from global to shared memory.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(d), "l"(src), "n"(BYTES) : "memory");
}

// A lane's BYTES of one position, in the low bytes of a uint4.
template <int BYTES>
__device__ __forceinline__ uint4 load_lane(const void* p) {
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if constexpr (BYTES == 16) {
    r = *static_cast<const uint4*>(p);
  } else if constexpr (BYTES == 8) {
    const uint2 v = *static_cast<const uint2*>(p);
    r.x = v.x;
    r.y = v.y;
  } else if constexpr (BYTES == 4) {
    r.x = *static_cast<const uint32_t*>(p);
  } else {
    r.x = *static_cast<const uint16_t*>(p);
  }
  return r;
}

// 32-bit word i of a uint4 (i known at compile time once unrolled): no
// address of the vector is taken, so it stays in registers.
__device__ __forceinline__ uint32_t word(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}

// The V values of a lane as f32: elements of T, or codes (S = 8: one int8
// a lane, S = 4: lane 2i in the low nibble of byte i) dequantized as
// dequantize_page does, T(f32(q) * scale), and widened back.
template <typename T, int V, int S>
__device__ __forceinline__ void unpack(const uint4& raw, float scale,
                                       float (&f)[V]) {
  const T* tag = nullptr;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if constexpr (S == 0) {
      if constexpr (std::is_same<T, float>::value)
        f[j] = __uint_as_float(word(raw, j));
      else
        f[j] = __bfloat162float(__ushort_as_bfloat16(
            static_cast<unsigned short>(word(raw, j / 2) >> (16 * (j & 1)))));
    } else {
      int q;
      if constexpr (S == 8) {
        q = static_cast<int8_t>(word(raw, j / 4) >> (8 * (j % 4)));
      } else {   // sign-extend the nibble from the top of a byte
        const unsigned u = (word(raw, j / 8) >> (8 * ((j / 2) % 4))) & 0xffu;
        q = static_cast<int8_t>((j & 1) ? u : u << 4) >> 4;
      }
      f[j] = round_to(__fmul_rn(static_cast<float>(q), scale), tag);
    }
  }
}

// Element b of an int32 or int64 array whose elements lie `stride` apart.
__device__ __forceinline__ long long load_index(const void* p,
                                                long long stride, int bytes,
                                                int b) {
  return bytes == 8 ? static_cast<const long long*>(p)[b * stride]
                    : static_cast<const int*>(p)[b * stride];
}

// Strides in elements.  q [B, H, D]: heads D apart, slots q_sb apart; out
// [B, H, D] contiguous; k / v [B, C, Hkv, D] (or their codes): slots,
// positions and heads *_sb, *_sp, *_sh apart; the scales of quantized
// pages [B, C, Hkv] ks_* / vs_* apart.  vlen_bytes 0: no valid-length bound.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
  void* out;
  const void* qpos;
  const void* vlen;
  long long qpos_stride, vlen_stride;
  int qpos_bytes, vlen_bytes;
  int C, Hkv, D, splits, cap;  // cap: positions one split holds at most
  int stage;                   // V rows staged at a time
  long long q_sb, k_sb, k_sp, k_sh, v_sb, v_sp, v_sh;
  long long ks_sb, ks_sp, ks_sh, vs_sb, vs_sp, vs_sh;
  float scale;                 // sqrt(D), as the reference divides by it
};

// The G per-thread values summed (MAX = false) or maxed over the CTA: each
// warp by a shuffle tree, then the warps in order; thread g < G returns
// value g.
template <int G, bool MAX>
__device__ __forceinline__ float block_reduce(float (&x)[G],
                                              float* scratch) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float y = __shfl_xor_sync(0xffffffffu, x[g], o);
      x[g] = MAX ? fmaxf(x[g], y) : x[g] + y;
    }
  if (lane == 0)
#pragma unroll
    for (int g = 0; g < G; ++g) scratch[warp * G + g] = x[g];
  __syncthreads();
  float r = 0.f;
  if (threadIdx.x < G) {
    r = scratch[threadIdx.x];
    for (int w = 1; w < kWarps; ++w) {
      const float y = scratch[w * G + threadIdx.x];
      r = MAX ? fmaxf(r, y) : r + y;
    }
  }
  return r;
}

// Thread g < G stores v into slot [rank][g] of `box` in every CTA of the
// cluster (its own included): after the next cluster.sync() each CTA
// reads every rank's value from its own shared memory.
template <int G>
__device__ __forceinline__ void push(cg::cluster_group& cluster, float* box,
                                     float v, int rank, int splits) {
  if (threadIdx.x < G)
    for (int r = 0; r < splits; ++r)
      cluster.map_shared_rank(box, r)[rank * G + threadIdx.x] = v;
}

inline size_t smem_floats(int G, int D, int cap) {
  return static_cast<size_t>(G) * cap            // scores, then probabilities
         + static_cast<size_t>(G) * D + kMaxSplits  // the ranks' P.V shares
         + static_cast<size_t>(kWarps) * G * D   // the warps' P.V partials
         + static_cast<size_t>(kWarps) * G       // reduce scratch
         + 2 * static_cast<size_t>(kMaxSplits) * G;  // every rank's max, sum
}

// Positions of one step of the P.V walk: a whole number of them is staged.
inline int walk_step(int D, int elem_bytes) {
  const int lanes = D / (16 / elem_bytes);
  return kWarps * (lanes >= 1 && lanes <= 32 ? 32 / lanes : 1) * kUnroll;
}

// V rows staged at a time: a split's positions rounded up to whole steps
// of the walk, at most the whole steps whose rows (and scales) fit
// kStageBytes, at least one step.
inline int stage_positions(int D, int C, int splits, int elem_bytes,
                           int bits) {
  const int it = walk_step(D, elem_bytes);
  const int cap = (C + splits - 1) / splits;
  const int per = row_bytes(D, elem_bytes, bits) + (bits == 16 ? 0 : 4);
  const int most = kStageBytes / per / it * it;
  const int all = (cap + it - 1) / it * it;
  return all < most ? all : (most > it ? most : it);
}

// Bytes of one launch: the floats, then (16-byte aligned) the staged V
// rows and, for codes, their f32 scales.
inline size_t smem_total(int G, int D, int C, int splits, int elem_bytes,
                         int bits) {
  const size_t floats =
      sizeof(float) * smem_floats(G, D, (C + splits - 1) / splits);
  const size_t rows = stage_positions(D, C, splits, elem_bytes, bits);
  return (floats + 15) / 16 * 16
         + rows * (row_bytes(D, elem_bytes, bits) + (bits == 16 ? 0 : 4));
}

// Start the async copies (one commit group) of the V rows [p0, p1) of
// slot b, kv head h into vst (rows of `row` bytes) and, for codes, their
// scales into vsc.  Reads its strides from the kernel's parameters, so
// nothing of it stays live across the K walk.
template <typename T, int S>
__device__ __forceinline__ void stage_v(const Args& a, int b, int h,
                                        unsigned char* vst, float* vsc,
                                        int p0, int p1) {
  using E = typename std::conditional<S == 0, T, int8_t>::type;
  constexpr int kUnit = unit_bytes<T, S>();
  const int row = a.D / (S == 4 ? 2 : 1) * static_cast<int>(sizeof(E));
  const int units = row / kUnit;
  const unsigned char* vrow = reinterpret_cast<const unsigned char*>(
      static_cast<const E*>(a.v) + b * a.v_sb + h * a.v_sh);
  const long long v_pb = a.v_sp * static_cast<long long>(sizeof(E));
  for (int i = threadIdx.x; i < (p1 - p0) * units; i += kThreads) {
    const int p = p0 + i / units, c = (i % units) * kUnit;
    cp_async<kUnit>(vst + (p - p0) * row + c, vrow + p * v_pb + c);
  }
  if constexpr (S != 0) {
    const float* vsb = a.v_scale + b * a.vs_sb + h * a.vs_sh;
    for (int i = threadIdx.x; i < p1 - p0; i += kThreads)
      cp_async<4>(vsc + i, vsb + (p0 + i) * a.vs_sp);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Grid (splits, B * Hkv); cluster (splits, 1, 1).  S: the store (0: k / v
// of type T, 8 / 4: int8 / packed int4 codes with f32 scales).
template <typename T, int G, int S>
__global__ void __launch_bounds__(kThreads,
                                  G <= 2 ? 2 * kMinBlocks : kMinBlocks)
decode_attention_kernel(const Args a) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kLaneBytes = lane_bytes<T, S>();
  using E = typename std::conditional<S == 0, T, int8_t>::type;
  constexpr int kPerByte = S == 4 ? 2 : 1;   // lanes a stored element holds
  const int LP = a.D / V;          // lanes of one position
  const int P = 32 / LP;           // positions of one warp step
  const int step = kWarps * P;     // positions of one CTA step
  const int row = a.D / kPerByte * static_cast<int>(sizeof(E));  // V bytes
  extern __shared__ __align__(16) float smem[];
  float* sc = smem;                              // [G][cap]
  float* inbox = sc + G * a.cap;                 // [splits][share]
  float* wred = inbox + G * a.D + kMaxSplits;    // [kWarps][G][D]
  float* scratch = wred + kWarps * G * a.D;      // [kWarps][G]
  float* smax = scratch + kWarps * G;            // [kMaxSplits][G]
  float* ssum = smax + kMaxSplits * G;           // [kMaxSplits][G]
  unsigned char* vst = reinterpret_cast<unsigned char*>(smem)   // [stage][row]
                       + (sizeof(float) * (ssum + kMaxSplits * G - smem) + 15)
                             / 16 * 16;
  float* vsc = reinterpret_cast<float*>(vst + a.stage * row);  // [stage]

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  // this CTA has started: a peer may store into its shared memory once it
  // has waited for this arrival (before its first push)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int b = blockIdx.y / a.Hkv;
  const int h = blockIdx.y % a.Hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int lp = lane % LP, pw = lane / LP;
  const int d0 = lp * V;

  // the positions the reference does not mask, clamped to [0, C]
  long long n = load_index(a.qpos, a.qpos_stride, a.qpos_bytes, b) + 1;
  if (a.vlen_bytes)
    n = min(n, load_index(a.vlen, a.vlen_stride, a.vlen_bytes, b));
  n = max(0LL, min(n, static_cast<long long>(a.C)));
  const bool none = n == 0;          // all masked: uniform over C
  const int cnt = none ? a.C : static_cast<int>(n);
  const int per = (cnt + a.splits - 1) / a.splits;
  const int lo = min(cnt, rank * per);
  const int hi = min(cnt, lo + per);

  const E* kb = static_cast<const E*>(a.k) + b * a.k_sb + h * a.k_sh
                + d0 / kPerByte;
  const float* ksb = a.k_scale + b * a.ks_sb + h * a.ks_sh;   // S != 0

  // 0. start the copies of the first chunk of V rows
  stage_v<T, S>(a, b, h, vst, vsc, lo, min(hi, lo + a.stage));

  // 1. scores of positions [lo, hi)
  {
    float qf[G][V];
    const T* qb = static_cast<const T*>(a.q) + b * a.q_sb
                  + static_cast<long long>(h) * G * a.D + d0;
#pragma unroll
    for (int g = 0; g < G; ++g)
      unpack<T, V, 0>(*reinterpret_cast<const uint4*>(qb + g * a.D), 0.f,
                      qf[g]);
    // base is uniform over the warp: every lane takes part in the shuffles
    for (int base = lo + warp * P; base < hi; base += step * kUnroll) {
      uint4 raw[kUnroll];
      float ps[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int p = base + u * step + pw;
        raw[u] = make_uint4(0u, 0u, 0u, 0u);
        ps[u] = 0.f;
        if (p < hi && !none) {
          raw[u] = load_lane<kLaneBytes>(kb + p * a.k_sp);
          if constexpr (S != 0) ps[u] = ksb[p * a.ks_sp];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int p = base + u * step + pw;
        float kf[V];
        unpack<T, V, S>(raw[u], ps[u], kf);
        float s[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          s[g] = 0.f;
#pragma unroll
          for (int j = 0; j < V; ++j) s[g] = fmaf(qf[g][j], kf[j], s[g]);
        }
        for (int o = LP / 2; o > 0; o >>= 1)
#pragma unroll
          for (int g = 0; g < G; ++g)
            s[g] += __shfl_xor_sync(0xffffffffu, s[g], o);
        if (lp == 0 && p < hi)
#pragma unroll
          for (int g = 0; g < G; ++g)
            sc[g * a.cap + p - lo] = none ? kBigNeg : s[g] / a.scale;
      }
    }
  }
  __syncthreads();

  // 2. the max over every split's scores
  float x[G];
#pragma unroll
  for (int g = 0; g < G; ++g) x[g] = -INFINITY;
  for (int i = tid; i < hi - lo; i += kThreads)
#pragma unroll
    for (int g = 0; g < G; ++g) x[g] = fmaxf(x[g], sc[g * a.cap + i]);
  const float my_max = block_reduce<G, true>(x, scratch);
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // peers run
  push<G>(cluster, smax, my_max, rank, a.splits);
  cluster.sync();                    // every rank's max is here
  float gmax[G];
#pragma unroll
  for (int g = 0; g < G; ++g) gmax[g] = -INFINITY;
  for (int r = 0; r < a.splits; ++r)
#pragma unroll
    for (int g = 0; g < G; ++g) gmax[g] = fmaxf(gmax[g], smax[r * G + g]);

  // 3. exp(s - max), and the sum over every split in rank order
#pragma unroll
  for (int g = 0; g < G; ++g) x[g] = 0.f;
  for (int i = tid; i < hi - lo; i += kThreads)
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float e = expf(sc[g * a.cap + i] - gmax[g]);
      sc[g * a.cap + i] = e;
      x[g] += e;
    }
  __syncthreads();                   // scratch is free again
  push<G>(cluster, ssum, block_reduce<G, false>(x, scratch), rank,
          a.splits);
  cluster.sync();                    // every rank's sum is here
  float total[G];
#pragma unroll
  for (int g = 0; g < G; ++g) total[g] = 0.f;
  for (int r = 0; r < a.splits; ++r)
#pragma unroll
    for (int g = 0; g < G; ++g) total[g] += ssum[r * G + g];
  const T* tag = nullptr;
  for (int i = tid; i < hi - lo; i += kThreads)
#pragma unroll
    for (int g = 0; g < G; ++g)
      sc[g * a.cap + i] = round_to(sc[g * a.cap + i] / total[g], tag);
  __syncthreads();

  // 4. P.V over positions [lo, hi), f32, from the staged V rows: chunks of
  // `stage` positions (whole steps of this walk), each staged once the
  // last is consumed; the first was started at entry
  float acc[G][V];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < V; ++j) acc[g][j] = 0.f;
  for (int c0 = lo; c0 < hi; c0 += a.stage) {
    const int c1 = min(hi, c0 + a.stage);
    if (c0 != lo) {
      __syncthreads();               // the last chunk is consumed
      stage_v<T, S>(a, b, h, vst, vsc, c0, c1);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();                 // every thread's copies have landed
    // shared memory answers at once: each position is read and summed in
    // turn, in the order of the walk over [lo, hi)
    for (int base = c0 + warp * P; base < c1; base += step * kUnroll) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int p = base + u * step + pw;
        if (p < c1) {
          float vf[V];
          unpack<T, V, S>(load_lane<kLaneBytes>(vst + (p - c0) * row
                                                + lp * kLaneBytes),
                          S != 0 ? vsc[p - c0] : 0.f, vf);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float pg = sc[g * a.cap + p - lo];
#pragma unroll
            for (int j = 0; j < V; ++j)
              acc[g][j] = fmaf(pg, vf[j], acc[g][j]);
          }
        }
      }
    }
  }
  // the warp's positions (lanes lp, lp + LP, ...) in a fixed tree
  for (int o = LP; o < 32; o <<= 1)
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int j = 0; j < V; ++j)
        acc[g][j] += __shfl_xor_sync(0xffffffffu, acc[g][j], o);
  if (pw == 0)
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int j = 0; j < V; ++j)
        wred[(warp * G + g) * a.D + d0 + j] = acc[g][j];
  __syncthreads();
  // the CTA's partial, element i into slot [rank] of its owner's inbox
  // (rank i / share owns outputs [owner * share, + share))
  const int GD = G * a.D;
  const int share = (GD + a.splits - 1) / a.splits;
  for (int i = tid; i < GD; i += kThreads) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += wred[w * GD + i];
    const int owner = i / share;
    cluster.map_shared_rank(inbox, owner)[rank * share + i - owner * share]
        = s;
  }
  cluster.sync();                    // every rank's share is here

  // 5. rank r sums its share of the G x D outputs over the ranks in order,
  // from its own shared memory: no CTA reads a peer's after the last sync
  const int end = min(GD, (rank + 1) * share);
  T* ob = static_cast<T*>(a.out)
          + (static_cast<long long>(b) * a.Hkv + h) * GD;
  for (int i = rank * share + tid; i < end; i += kThreads) {
    float s = 0.f;
    for (int r = 0; r < a.splits; ++r) s += inbox[r * share + i - rank * share];
    store(s, ob + i);
  }
}

template <typename T, int G, int S>
int launch(const Args& a, int B, cudaStream_t stream) {
  auto kernel = decode_attention_kernel<T, G, S>;
  constexpr int kMaxSmem = 227 * 1024;
  // once per instantiation, at its first launch (never inside a graph
  // capture: callers warm up first)
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const size_t smem = smem_total(G, a.D, a.C, a.splits, sizeof(T), S ? S : 16);
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.splits, B * a.Hkv, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = a.splits;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, kernel, a);
  const cudaError_t last = cudaGetLastError();  // clear it either way
  return static_cast<int>(rc != cudaSuccess ? rc : last);
}

// What a launch takes: D a whole number of 16-byte vectors on a power of
// two of lanes (at most a warp), G in {1, 2, 4, 8}, splits in {1, 2, 4,
// 8} holding every position, 16-byte aligned q and out, and k / v rows
// (or code rows) aligned to what a lane reads; scales for quantized pages.
template <typename T, int S>
bool launchable(const Args& a, int B, int G) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kLaneBytes = unit_bytes<T, S>();  // and the staging copies
  constexpr int kElem = S == 0 ? sizeof(T) : 1;   // bytes of a stored element
  const int LP = a.D / V;
  const auto aligned = [](const void* p, int bytes) {
    return reinterpret_cast<uintptr_t>(p) % bytes == 0;
  };
  const auto vec = [](long long s, int elem, int bytes) {
    return (s * elem) % bytes == 0;
  };
  const bool pages =
      aligned(a.k, kLaneBytes) && aligned(a.v, kLaneBytes)
      && vec(a.k_sb, kElem, kLaneBytes) && vec(a.k_sp, kElem, kLaneBytes)
      && vec(a.k_sh, kElem, kLaneBytes) && vec(a.v_sb, kElem, kLaneBytes)
      && vec(a.v_sp, kElem, kLaneBytes) && vec(a.v_sh, kElem, kLaneBytes)
      && (S == 0 || (a.k_scale != nullptr && a.v_scale != nullptr
                     && aligned(a.k_scale, 4) && aligned(a.v_scale, 4)));
  return B >= 1 && a.C >= 1 && a.Hkv >= 1 && a.D % V == 0 && LP >= 1
         && LP <= 32 && (LP & (LP - 1)) == 0
         && row_bytes(a.D, sizeof(T), S ? S : 16) % kLaneBytes == 0
         && (G == 1 || G == 2 || G == 4 || G == 8)
         && (a.splits == 1 || a.splits == 2 || a.splits == 4
             || a.splits == kMaxSplits)
         && static_cast<long long>(a.cap) * a.splits >= a.C
         && B * a.Hkv <= 65535 && (a.qpos_bytes == 4 || a.qpos_bytes == 8)
         && (a.vlen_bytes == 0 || a.vlen_bytes == 4 || a.vlen_bytes == 8)
         && aligned(a.q, 16) && aligned(a.out, 16)
         && vec(a.q_sb, sizeof(T), 16) && pages;
}

template <typename T, int S>
int run(const Args& a, int B, int G, void* stream) {
  if (!launchable<T, S>(a, B, G))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (G) {
    case 1: return launch<T, 1, S>(a, B, s);
    case 2: return launch<T, 2, S>(a, B, s);
    case 4: return launch<T, 4, S>(a, B, s);
    default: return launch<T, 8, S>(a, B, s);
  }
}

template <typename T>
int entry(const void* q, const void* k, const void* v, const void* k_scale,
          const void* v_scale, void* out, const void* qpos,
          long long qpos_stride, int qpos_bytes, const void* vlen,
          long long vlen_stride, int vlen_bytes, int B, int C, int Hkv, int G,
          int D, long long q_sb, long long k_sb, long long k_sp,
          long long k_sh, long long v_sb, long long v_sp, long long v_sh,
          long long ks_sb, long long ks_sp, long long ks_sh, long long vs_sb,
          long long vs_sp, long long vs_sh, int bits, int splits,
          float scale, void* stream) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.out = out;
  a.qpos = qpos;
  a.vlen = vlen;
  a.qpos_stride = qpos_stride;
  a.vlen_stride = vlen_stride;
  a.qpos_bytes = qpos_bytes;
  a.vlen_bytes = vlen_bytes;
  a.C = C;
  a.Hkv = Hkv;
  a.D = D;
  a.splits = splits;
  a.cap = splits > 0 ? (C + splits - 1) / splits : 0;
  a.stage = splits > 0 ? stage_positions(D, C, splits, sizeof(T), bits) : 0;
  a.q_sb = q_sb;
  a.k_sb = k_sb;
  a.k_sp = k_sp;
  a.k_sh = k_sh;
  a.v_sb = v_sb;
  a.v_sp = v_sp;
  a.v_sh = v_sh;
  a.ks_sb = ks_sb;
  a.ks_sp = ks_sp;
  a.ks_sh = ks_sh;
  a.vs_sb = vs_sb;
  a.vs_sp = vs_sp;
  a.vs_sh = vs_sh;
  a.scale = scale;
  switch (bits) {
    case 16: return run<T, 0>(a, B, G, stream);
    case 8: return run<T, 8>(a, B, G, stream);
    case 4: return run<T, 4>(a, B, G, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// (q, k, v, out, qpos, qpos_stride, qpos_bytes, vlen, vlen_stride,
// vlen_bytes, B, C, Hkv, G, D, q_sb, k_sb, k_sp, k_sh, v_sb, v_sp, v_sh,
// splits, scale, stream): q [B, H = Hkv * G, D] (heads contiguous, slots
// q_sb apart), k / v [B, C, Hkv, D] by their strides, out a contiguous
// [B, H, D]; qpos / vlen int32 or int64 per slot (vlen_bytes 0: none),
// strides in elements; scale = sqrt(D).
#define FP_ENTRY(NAME, T)                                                    \
  extern "C" int NAME(                                                       \
      const void* q, const void* k, const void* v, void* out,                \
      const void* qpos, long long qpos_stride, int qpos_bytes,               \
      const void* vlen, long long vlen_stride, int vlen_bytes, int B, int C, \
      int Hkv, int G, int D, long long q_sb, long long k_sb, long long k_sp, \
      long long k_sh, long long v_sb, long long v_sp, long long v_sh,        \
      int splits, float scale, void* stream) {                               \
    return entry<T>(q, k, v, nullptr, nullptr, out, qpos, qpos_stride,       \
                    qpos_bytes, vlen, vlen_stride, vlen_bytes, B, C, Hkv, G, \
                    D, q_sb, k_sb, k_sp, k_sh, v_sb, v_sp, v_sh, 0, 0, 0, 0, \
                    0, 0, 16, splits, scale, stream);                        \
  }

FP_ENTRY(decode_attention_bf16, bf16)
FP_ENTRY(decode_attention_f32, float)

// Quantized pages: (q, k, v, k_scale, v_scale, out, qpos, qpos_stride,
// qpos_bytes, vlen, vlen_stride, vlen_bytes, B, C, Hkv, G, D, q_sb, k_sb,
// k_sp, k_sh, v_sb, v_sp, v_sh, ks_sb, ks_sp, ks_sh, vs_sb, vs_sp, vs_sh,
// bits, splits, scale, stream): k / v int8 codes [B, C, Hkv, D] (bits 8)
// or packed int4 [B, C, Hkv, D / 2] (bits 4), strides in bytes; scales f32
// [B, C, Hkv], strides in floats; q and out as above, in x's type.
#define QUANT_ENTRY(NAME, T)                                                 \
  extern "C" int NAME(                                                       \
      const void* q, const void* k, const void* v, const void* k_scale,      \
      const void* v_scale, void* out, const void* qpos,                      \
      long long qpos_stride, int qpos_bytes, const void* vlen,               \
      long long vlen_stride, int vlen_bytes, int B, int C, int Hkv, int G,   \
      int D, long long q_sb, long long k_sb, long long k_sp, long long k_sh, \
      long long v_sb, long long v_sp, long long v_sh, long long ks_sb,       \
      long long ks_sp, long long ks_sh, long long vs_sb, long long vs_sp,    \
      long long vs_sh, int bits, int splits, float scale, void* stream) {    \
    if (bits != 8 && bits != 4)                                              \
      return static_cast<int>(cudaErrorInvalidValue);                        \
    return entry<T>(q, k, v, k_scale, v_scale, out, qpos, qpos_stride,       \
                    qpos_bytes, vlen, vlen_stride, vlen_bytes, B, C, Hkv, G, \
                    D, q_sb, k_sb, k_sp, k_sh, v_sb, v_sp, v_sh, ks_sb,      \
                    ks_sp, ks_sh, vs_sb, vs_sp, vs_sh, bits, splits, scale,  \
                    stream);                                                 \
  }

QUANT_ENTRY(decode_attention_quant_bf16, bf16)
QUANT_ENTRY(decode_attention_quant_f32, float)

// Dynamic shared memory of one launch, in bytes (the wrapper's check):
// q of elem_bytes, pages of `bits` (16: the fp kernel).
extern "C" long long decode_attention_smem_bytes(int G, int D, int C,
                                                 int splits, int elem_bytes,
                                                 int bits) {
  return static_cast<long long>(
      smem_total(G, D, C, splits, elem_bytes, bits));
}
