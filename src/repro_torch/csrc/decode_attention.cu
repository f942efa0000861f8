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
// Design: one CTA (4 warps) per (slot, kv head, split); the `splits` CTAs
// of a (slot, kv head) divide its n positions evenly and form one thread
// block cluster.  A position's D elements are read by D / V lanes as
// 16-byte vectors (V = 8 bf16 or 4 f32), a warp covers 32 V / D positions
// a step and each thread keeps kUnroll vectors in flight; K and V are read
// in place through their strides (a slot-prefix view of the cache runs
// without a copy).  The CTA keeps its scores in shared memory; the max and
// the sum of the softmax are exchanged across the cluster in rank order
// through distributed shared memory, so every CTA rounds its
// probabilities exactly as one softmax over all n positions would; each
// CTA's P.V partial [G, D] is summed over the ranks in order by the rank
// that owns its share of the outputs.  One launch, no atomics: the result
// does not change from run to run.
//
// Plain C interface, loaded with ctypes.  Each entry returns the launch's
// CUDA error (0 when it was taken).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;          // K / V vectors in flight per thread
constexpr int kMaxSplits = 8;       // the portable cluster size
constexpr float kBigNeg = -2.0e9f;  // the reference's masked score

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float v, float* o) { *o = v; }
__device__ __forceinline__ void store(float v, bf16* o) {
  *o = __float2bfloat16_rn(v);
}
// v rounded to T and widened back (the probabilities are cast to v's type)
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const bf16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T, int V>
__device__ __forceinline__ void unpack(const uint4& raw, float (&f)[V]) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < V; ++j) f[j] = to_f32(e[j]);
}

// Element b of an int32 or int64 array whose elements lie `stride` apart.
__device__ __forceinline__ long long load_index(const void* p,
                                                long long stride, int bytes,
                                                int b) {
  return bytes == 8 ? static_cast<const long long*>(p)[b * stride]
                    : static_cast<const int*>(p)[b * stride];
}

// Strides in elements.  q [B, H, D]: heads D apart, slots q_sb apart; out
// [B, H, D] contiguous; k / v [B, C, Hkv, D]: slots, positions and heads
// *_sb, *_sp, *_sh apart.  vlen_bytes 0: no valid-length bound.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  const void* qpos;
  const void* vlen;
  long long qpos_stride, vlen_stride;
  int qpos_bytes, vlen_bytes;
  int C, Hkv, D, splits, cap;  // cap: positions one split holds at most
  long long q_sb, k_sb, k_sp, k_sh, v_sb, v_sp, v_sh;
  float scale;                 // sqrt(D), as the reference divides by it
};

// The G per-thread values summed (MAX = false) or maxed over the CTA into
// dst[G]: each warp by a shuffle tree, then the warps in order.
template <int G, bool MAX>
__device__ __forceinline__ void block_reduce(float (&x)[G], float* scratch,
                                             float* dst) {
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
  if (threadIdx.x < G) {
    float r = scratch[threadIdx.x];
    for (int w = 1; w < kWarps; ++w) {
      const float y = scratch[w * G + threadIdx.x];
      r = MAX ? fmaxf(r, y) : r + y;
    }
    dst[threadIdx.x] = r;
  }
}

inline size_t smem_floats(int G, int D, int cap) {
  return static_cast<size_t>(G) * cap            // scores, then probabilities
         + static_cast<size_t>(G) * D            // the CTA's P.V partial
         + static_cast<size_t>(kWarps) * G * D   // the warps' P.V partials
         + static_cast<size_t>(kWarps) * G       // reduce scratch
         + 2 * static_cast<size_t>(G);           // max, sum
}

// Grid (splits, B * Hkv); cluster (splits, 1, 1).
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const Args a) {
  constexpr int V = 16 / sizeof(T);
  const int LP = a.D / V;          // lanes of one position
  const int P = 32 / LP;           // positions of one warp step
  const int step = kWarps * P;     // positions of one CTA step
  extern __shared__ __align__(16) float smem[];
  float* sc = smem;                              // [G][cap]
  float* part = sc + G * a.cap;                  // [G][D]
  float* wred = part + G * a.D;                  // [kWarps][G][D]
  float* scratch = wred + kWarps * G * a.D;      // [kWarps][G]
  float* smax = scratch + kWarps * G;            // [G]
  float* ssum = smax + G;                        // [G]

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
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

  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh + d0;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh + d0;

  // 1. scores of positions [lo, hi)
  {
    float qf[G][V];
    const T* qb = static_cast<const T*>(a.q) + b * a.q_sb
                  + static_cast<long long>(h) * G * a.D + d0;
#pragma unroll
    for (int g = 0; g < G; ++g)
      unpack<T, V>(*reinterpret_cast<const uint4*>(qb + g * a.D), qf[g]);
    // base is uniform over the warp: every lane takes part in the shuffles
    for (int base = lo + warp * P; base < hi; base += step * kUnroll) {
      uint4 raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int p = base + u * step + pw;
        raw[u] = make_uint4(0u, 0u, 0u, 0u);
        if (p < hi && !none)
          raw[u] = *reinterpret_cast<const uint4*>(kb + p * a.k_sp);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int p = base + u * step + pw;
        float kf[V];
        unpack<T, V>(raw[u], kf);
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
  block_reduce<G, true>(x, scratch, smax);
  cluster.sync();                    // every rank's max is written
  float gmax[G];
#pragma unroll
  for (int g = 0; g < G; ++g) gmax[g] = -INFINITY;
  for (int r = 0; r < a.splits; ++r) {
    const float* m = cluster.map_shared_rank(smax, r);
#pragma unroll
    for (int g = 0; g < G; ++g) gmax[g] = fmaxf(gmax[g], m[g]);
  }

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
  block_reduce<G, false>(x, scratch, ssum);
  cluster.sync();                    // every rank's sum is written
  float total[G];
#pragma unroll
  for (int g = 0; g < G; ++g) total[g] = 0.f;
  for (int r = 0; r < a.splits; ++r) {
    const float* l = cluster.map_shared_rank(ssum, r);
#pragma unroll
    for (int g = 0; g < G; ++g) total[g] += l[g];
  }
  const T* tag = nullptr;
  for (int i = tid; i < hi - lo; i += kThreads)
#pragma unroll
    for (int g = 0; g < G; ++g)
      sc[g * a.cap + i] = round_to(sc[g * a.cap + i] / total[g], tag);
  __syncthreads();

  // 4. P.V over positions [lo, hi), f32
  float acc[G][V];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < V; ++j) acc[g][j] = 0.f;
  for (int base = lo + warp * P; base < hi; base += step * kUnroll) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = base + u * step + pw;
      raw[u] = make_uint4(0u, 0u, 0u, 0u);
      if (p < hi) raw[u] = *reinterpret_cast<const uint4*>(vb + p * a.v_sp);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = base + u * step + pw;
      if (p < hi) {
        float vf[V];
        unpack<T, V>(raw[u], vf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float pg = sc[g * a.cap + p - lo];
#pragma unroll
          for (int j = 0; j < V; ++j) acc[g][j] = fmaf(pg, vf[j], acc[g][j]);
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
  const int GD = G * a.D;
  for (int i = tid; i < GD; i += kThreads) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += wred[w * GD + i];
    part[i] = s;
  }
  cluster.sync();                    // every rank's partial is written

  // 5. rank r sums its share of the G x D outputs over the ranks in order
  const int share = (GD + a.splits - 1) / a.splits;
  const int end = min(GD, (rank + 1) * share);
  T* ob = static_cast<T*>(a.out)
          + (static_cast<long long>(b) * a.Hkv + h) * GD;
  for (int i = rank * share + tid; i < end; i += kThreads) {
    float s = 0.f;
    for (int r = 0; r < a.splits; ++r) s += cluster.map_shared_rank(part, r)[i];
    store(s, ob + i);
  }
  cluster.sync();                    // no CTA leaves while a peer reads it
}

template <typename T, int G>
int launch(const Args& a, int B, cudaStream_t stream) {
  auto kernel = decode_attention_kernel<T, G>;
  constexpr int kMaxSmem = 227 * 1024;
  // once per instantiation, at its first launch (never inside a graph
  // capture: callers warm up first)
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const size_t smem = sizeof(float) * smem_floats(G, a.D, a.cap);
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
// 8} holding every position, 16-byte aligned rows.
template <typename T>
bool launchable(const Args& a, int B, int G) {
  constexpr int V = 16 / sizeof(T);
  const int LP = a.D / V;
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const auto vec = [](long long s) { return (s * sizeof(T)) % 16 == 0; };
  return B >= 1 && a.C >= 1 && a.Hkv >= 1 && a.D % V == 0 && LP >= 1
         && LP <= 32 && (LP & (LP - 1)) == 0
         && (G == 1 || G == 2 || G == 4 || G == 8)
         && (a.splits == 1 || a.splits == 2 || a.splits == 4
             || a.splits == kMaxSplits)
         && static_cast<long long>(a.cap) * a.splits >= a.C
         && B * a.Hkv <= 65535 && (a.qpos_bytes == 4 || a.qpos_bytes == 8)
         && (a.vlen_bytes == 0 || a.vlen_bytes == 4 || a.vlen_bytes == 8)
         && aligned(a.q) && aligned(a.k) && aligned(a.v) && aligned(a.out)
         && vec(a.q_sb) && vec(a.k_sb) && vec(a.k_sp) && vec(a.k_sh)
         && vec(a.v_sb) && vec(a.v_sp) && vec(a.v_sh);
}

template <typename T>
int run(const Args& a, int B, int G, void* stream) {
  if (!launchable<T>(a, B, G)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (G) {
    case 1: return launch<T, 1>(a, B, s);
    case 2: return launch<T, 2>(a, B, s);
    case 4: return launch<T, 4>(a, B, s);
    default: return launch<T, 8>(a, B, s);
  }
}

template <typename T>
int entry(const void* q, const void* k, const void* v, void* out,
          const void* qpos, long long qpos_stride, int qpos_bytes,
          const void* vlen, long long vlen_stride, int vlen_bytes, int B,
          int C, int Hkv, int G, int D, long long q_sb, long long k_sb,
          long long k_sp, long long k_sh, long long v_sb, long long v_sp,
          long long v_sh, int splits, float scale, void* stream) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
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
  a.q_sb = q_sb;
  a.k_sb = k_sb;
  a.k_sp = k_sp;
  a.k_sh = k_sh;
  a.v_sb = v_sb;
  a.v_sp = v_sp;
  a.v_sh = v_sh;
  a.scale = scale;
  return run<T>(a, B, G, stream);
}

}  // namespace

// (q, k, v, out, qpos, qpos_stride, qpos_bytes, vlen, vlen_stride,
// vlen_bytes, B, C, Hkv, G, D, q_sb, k_sb, k_sp, k_sh, v_sb, v_sp, v_sh,
// splits, scale, stream): q [B, H = Hkv * G, D] (heads contiguous, slots
// q_sb apart), k / v [B, C, Hkv, D] by their strides, out a contiguous
// [B, H, D]; qpos / vlen int32 or int64 per slot (vlen_bytes 0: none),
// strides in elements; scale = sqrt(D).
extern "C" int decode_attention_bf16(
    const void* q, const void* k, const void* v, void* out, const void* qpos,
    long long qpos_stride, int qpos_bytes, const void* vlen,
    long long vlen_stride, int vlen_bytes, int B, int C, int Hkv, int G,
    int D, long long q_sb, long long k_sb, long long k_sp, long long k_sh,
    long long v_sb, long long v_sp, long long v_sh, int splits, float scale,
    void* stream) {
  return entry<bf16>(q, k, v, out, qpos, qpos_stride, qpos_bytes, vlen,
                     vlen_stride, vlen_bytes, B, C, Hkv, G, D, q_sb, k_sb,
                     k_sp, k_sh, v_sb, v_sp, v_sh, splits, scale, stream);
}

extern "C" int decode_attention_f32(
    const void* q, const void* k, const void* v, void* out, const void* qpos,
    long long qpos_stride, int qpos_bytes, const void* vlen,
    long long vlen_stride, int vlen_bytes, int B, int C, int Hkv, int G,
    int D, long long q_sb, long long k_sb, long long k_sp, long long k_sh,
    long long v_sb, long long v_sp, long long v_sh, int splits, float scale,
    void* stream) {
  return entry<float>(q, k, v, out, qpos, qpos_stride, qpos_bytes, vlen,
                      vlen_stride, vlen_bytes, B, C, Hkv, G, D, q_sb, k_sb,
                      k_sp, k_sh, v_sb, v_sp, v_sh, splits, scale, stream);
}

// Dynamic shared memory of one launch, in bytes (the wrapper's check).
extern "C" long long decode_attention_smem_bytes(int G, int D, int C,
                                                 int splits) {
  return static_cast<long long>(
      sizeof(float) * smem_floats(G, D, (C + splits - 1) / splits));
}
