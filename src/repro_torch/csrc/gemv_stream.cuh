// Streaming decode GEMV body for Hopper (sm_90a), shared by pim_gemv.cu,
// splitk_gemv.cu, triton_gemv.cu and grouped_gemv.cu's grouped kernel
// (ragged_gemv keeps gemv_tile.cuh).
//
//   out[p][R, M] = x[p][R, K] @ w_t[p][K, M]      (w_t K-major)
//
// p runs over `parts` (blockIdx.y): the K parts of a split-K launch (whose
// sums meet in a cluster), or the experts of a grouped launch, or just one.
//
// Bound: at decode batch each weight element feeds 2 * R flops, far below
// the ~295 flops/byte where an H100 stops being memory bound, so the floor
// is the weight bytes over HBM bandwidth (3.35 TB/s): every SM has to pull
// ~25 GB/s, all the time.
//
// One CTA (256 threads, 8 warps) owns one column block of m_blk = 64 or 128
// outputs of one part over the part's k_part rows.  Its K walk streams
// through a ring of `stages` slots in dynamic shared memory, filled by the
// tensor memory accelerator (TMA): one thread asks for a K sub-tile (ks
// rows, 16 KB of weights: 64 rows of 128 bf16 columns, 128 of 64) as
// m_blk / (128 / sizeof(T)) boxes of 128 bytes a row, plus x's box of the
// same ks columns for the launch's rows, all counted on the slot's
// mbarrier.  The copies of sub-tiles i+1 .. i+stages-1 are in flight while
// sub-tile i is multiplied, so no point of the K walk has zero weight
// bytes in flight.  The weight boxes land in the 128-byte swizzle (16-byte
// chunk c of row r at chunk c ^ (r % 8)), so the eight rows an ldmatrix
// reads fall in distinct bank groups; slots are 1024-byte aligned, as the
// swizzle asks.  w_t is a 3-D tensor map {M, k_part, parts} and x one of
// {k_part, parts, R} (or {k_part, R, parts}, whichever keeps the strides
// increasing): the copy engine zero-fills past M (a ragged last column
// block), past the K part (a ragged last sub-tile) and past the last row.
//
// Why TMA and a shallow ring (measured on an H100 SXM; PERF.md):
// filled with 16-byte cp.async copies, a CTA streamed about half of what
// an SM must pull, whatever the ring depth (2..8 slots, 16..112 KB ahead);
// TMA boxes nearly doubled that, again flat in the depth.  So the planner
// keeps 2 slots by default (16 KB ahead a CTA, 32-64 KB an SM at the 2-4
// CTAs an SM holds on olmo-1b's grids) and spends shared memory on CTAs
// per SM instead; every other depth stays a plan (and an autotune
// candidate) of its own.
//
//   bf16: warp-level mma.sync.m16n8k16 (bf16 in, f32 accumulate) computing
//         out^T = w_t^T . x^T.  W is the A operand, taken from the slot with
//         ldmatrix.x4.trans; x is the n = 8 operand, NT of them a launch
//         (NT * 8 >= the rows, up to 64): every A fragment, so every weight
//         byte, is read from shared memory once and multiplied into all NT
//         row tiles (lanes of rows past the box feed zeros).  Warp w owns
//         m16 tile w % (m_blk / 16) and, when m_blk = 64, every second k16
//         step of each sub-tile (k group w / 4).  bf16 x bf16 products are
//         exact in f32: only the order of the sums differs from the plain
//         version.
//   f32:  scalar f32 FMAs (no TF32: that would round x and W to 10-bit
//         mantissas, which the reference's f32 product does not).  Thread
//         t owns column t % m_blk and every (256 / m_blk)-th row of each
//         sub-tile, for up to 8 rows a launch.
//
// More rows than one launch holds (f32 past 8, bf16 past 64) run as row
// chunks, one launch each over the same tensor maps.
//
// After the walk the k groups' f32 sums meet in shared memory (the ring,
// drained) and are added in a fixed order, group 0 first.  Without a
// cluster the CTA casts and writes its part's `out`.  splitk_gemv keeps
// the CTA's f32 partial [R, m_blk] in shared memory; the `deg` CTAs of one
// column block form one thread block cluster (cluster dims (1, deg, 1):
// rank r is K part r), and after cluster.sync() rank r sums its m_blk /
// deg columns over ranks 0, 1, ..., deg - 1 in that order through
// distributed shared memory, casts and writes `out`; a second
// cluster.sync() keeps every CTA alive until its peers have read it.  One
// launch, no atomics, no partials in HBM.
//
// Determinism: ks follows from the plan's k_blk alone and the warps' k
// steps from m_blk, so the stage count changes how many copies are in
// flight, never the order of the sums: outputs at every depth are
// bit-identical.
//
// w_t's rows lie ld elements apart (ld >= M, ld * sizeof(T) a multiple of
// 16 bytes), its parts w_ps apart; x's rows and parts lie x_rs / x_ps
// apart: a column slice of a wider prepacked weight, an expert slice of a
// stack and a row or expert view of x run in place.
#pragma once

#include <cooperative_groups.h>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace gemv_stream {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxB = 8;            // rows of one mma's n, and of f32
constexpr int kMaxTiles = 8;        // n tiles a bf16 launch holds: 64 rows
constexpr int kMaxStages = 8;
constexpr int kMaxDeg = 8;          // split-K parts: the portable cluster size
constexpr int kMinCtasPerSm = 4;    // launch bound: at most 64 registers
constexpr int kRowBytes = 128;      // one swizzled row of a weight box
constexpr int kAlign = 1024;        // the 128-byte swizzle's alignment
constexpr int kMaxSmem = 227 * 1024;  // opt-in shared memory of one CTA

// k groups: warps (bf16) or threads (f32) sharing one column range, each
// walking its own k steps of every sub-tile.
__host__ __device__ inline int groups(int m_blk, int elem_bytes) {
  return (elem_bytes == 2 ? kWarps * 16 : kThreads) / m_blk;
}

// One ring slot: the weight boxes [ks][m_blk] and x's box [B][ks] (B: the
// rows of the box).
__host__ __device__ inline size_t slot_bytes(int B, int m_blk, int ks,
                                             int elem_bytes) {
  const size_t bytes = (static_cast<size_t>(m_blk) + B) * ks * elem_bytes;
  return (bytes + kAlign - 1) / kAlign * kAlign;
}

// The ring, or the epilogue (the k groups' sums, then split-K's partial
// tile) that reuses it, if larger.
__host__ __device__ inline size_t body_bytes(int B, int m_blk, int ks,
                                             int stages, int elem_bytes,
                                             int deg) {
  const size_t ring = stages * slot_bytes(B, m_blk, ks, elem_bytes);
  const size_t epi = sizeof(float) * B * m_blk
                     * (groups(m_blk, elem_bytes) + (deg > 1 ? 1 : 0));
  return ring > epi ? ring : epi;
}

// Dynamic shared memory of a launch: alignment slack, the body, and one
// mbarrier per slot.
inline size_t smem_bytes(int B, int m_blk, int ks, int stages,
                         int elem_bytes, int deg) {
  return kAlign + body_bytes(B, m_blk, ks, stages, elem_bytes, deg)
         + 8 * stages;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void store(float v, float* o) { *o = v; }
__device__ __forceinline__ void store(float v, bf16* o) {
  *o = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n"
      :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// A box of a 3-D tensor map into shared memory, counted on bar.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&a)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_16816(float (&c)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of column c of row r in a slot's swizzled weight boxes.
template <typename T>
__device__ __forceinline__ int w_offset(int r, int c, int ks) {
  constexpr int kBoxCols = kRowBytes / sizeof(T);
  const int in_box = (c % kBoxCols) * static_cast<int>(sizeof(T));
  return (c / kBoxCols) * ks * kRowBytes + r * kRowBytes
         + (((in_box >> 4) ^ (r & 7)) << 4) + (in_box & 15);
}

// The epilogue: red holds the k groups' f32 sums [kGroups][B][MBLK]; add
// them in group order, then (no cluster) cast and write the first `rows`
// rows of out, or (split-K) keep the partial [B][MBLK] behind them and sum
// the cluster's partials in rank order through distributed shared memory.
template <typename T, int MBLK, bool CLUSTER, int kGroups>
__device__ __forceinline__ void finish(float* red, T* __restrict__ out,
                                       int B, int rows, int M, int col0,
                                       long long o_rs) {
  const int tid = threadIdx.x;
  float* part = red + kGroups * B * MBLK;          // [B][MBLK], split-K
  for (int i = tid; i < B * MBLK; i += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kGroups; ++q) s += red[q * B * MBLK + i];
    if constexpr (CLUSTER) {
      part[i] = s;
    } else {
      const int c = col0 + i % MBLK;
      const int b = i / MBLK;
      if (c < M && b < rows) store(s, out + b * o_rs + c);
    }
  }

  if constexpr (CLUSTER) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every part's partial tile is written
    const int deg = static_cast<int>(cluster.num_blocks());
    const int rank = static_cast<int>(cluster.block_rank());
    const int cols = MBLK / deg;
    for (int i = tid; i < B * cols; i += kThreads) {
      const int b = i / cols;
      const int c = rank * cols + i % cols;
      // all deg remote loads in flight at once, then summed in rank order
      float v[kMaxDeg];
#pragma unroll
      for (int q = 0; q < kMaxDeg; ++q)
        v[q] = q < deg ? cluster.map_shared_rank(part, q)[b * MBLK + c] : 0.f;
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < kMaxDeg; ++q)
        if (q < deg) s += v[q];
      if (col0 + c < M && b < rows) store(s, out + b * o_rs + col0 + c);
    }
    cluster.sync();  // no CTA leaves while a peer still reads its tile
  }
}

// Grid (ceil(M / MBLK), parts); with CLUSTER the parts of a column block are
// one cluster and share `out`, else part p writes out + p * o_ps.  B is
// the rows of x's box (at most NT * 8 for bf16, kMaxB for f32), `rows` of
// them (from row0 on) are stored; out rows lie o_rs apart, and `out`
// already points at row0.  x_part_dim says which dimension of x's map is
// the part (1) and which the row (the other).
template <typename T, int MBLK, int NT, bool CLUSTER>
__global__ void __launch_bounds__(kThreads, NT > 4 ? 2 : kMinCtasPerSm)
stream_kernel(const __grid_constant__ CUtensorMap tw,
              const __grid_constant__ CUtensorMap tx, T* __restrict__ out,
              int B, int rows, int M, int k_part, int ks, int stages,
              int row0, int x_part_dim, long long o_ps, long long o_rs) {
  constexpr bool kMma = std::is_same<T, bf16>::value;
  static_assert(kMma || NT == 1, "f32 holds kMaxB rows a launch");
  constexpr int kBoxCols = kRowBytes / sizeof(T);
  constexpr int kTiles = MBLK / 16;          // m16 tiles (bf16)
  constexpr int kGroups = (kMma ? kWarps * 16 : kThreads) / MBLK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((kAlign - (smem_addr(smem_raw) & (kAlign - 1)))
                  & (kAlign - 1));
  const int slot = static_cast<int>(slot_bytes(B, MBLK, ks, sizeof(T)));
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      smem + body_bytes(B, MBLK, ks, stages, sizeof(T), CLUSTER ? 2 : 1));
  const int tid = threadIdx.x;
  const int col0 = blockIdx.x * MBLK;
  const int part = blockIdx.y;
  const int n_sub = (k_part + ks - 1) / ks;
  const int w_bytes = MBLK * ks * static_cast<int>(sizeof(T));
  const unsigned tx_bytes = static_cast<unsigned>((MBLK + B) * ks * sizeof(T));
  const int xc1 = x_part_dim == 1 ? part : row0;
  const int xc2 = x_part_dim == 1 ? row0 : part;
  if constexpr (!CLUSTER) out += part * o_ps;

  if (tid == 0) {
    for (int q = 0; q < stages; ++q) mbar_init(&bars[q], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // One thread asks for sub-tile i (rows [i * ks, + ks) of the part) in
  // slot i % stages: its weight boxes and its x box.
  auto issue = [&](int i) {
    unsigned char* ws = smem + (i % stages) * slot;
    uint64_t* bar = &bars[i % stages];
    mbar_expect_tx(bar, tx_bytes);
#pragma unroll
    for (int h = 0; h < MBLK / kBoxCols; ++h)
      tma_load_3d(ws + h * ks * kRowBytes, &tw, col0 + h * kBoxCols, i * ks,
                  part, bar);
    tma_load_3d(ws + w_bytes, &tx, i * ks, xc1, xc2, bar);
  };

  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;   // mma group: A row / B column / C row
  const int t = lane & 3;    // thread in group
  // bf16: warp's m16 tile and k group; f32: thread's column and k group
  const int mt = warp % kTiles;
  const int wkg = warp / kTiles;
  const int fc = tid % MBLK;
  const int fkg = tid / MBLK;
  // ldmatrix.x4: lanes 8i..8i+7 give the rows of matrix i; matrices 0-3
  // are (k 0-7, m 0-7), (k 0-7, m 8-15), (k 8-15, m 0-7), (k 8-15, m 8-15)
  const int lrow = (lane & 7) + ((lane >> 4) << 3);
  const int lcol = mt * 16 + (((lane >> 3) & 1) << 3);

  constexpr int kAcc = kMma ? 4 : kMaxB;
  float acc[NT][kAcc];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < kAcc; ++q) acc[j][q] = 0.f;

  if (tid == 0)
    for (int q = 0; q < stages - 1 && q < n_sub; ++q) issue(q);
  for (int i = 0; i < n_sub; ++i) {
    __syncthreads();  // sub-tile i - 1 is consumed: its slot is free
    if (tid == 0 && i + stages - 1 < n_sub) issue(i + stages - 1);
    mbar_wait(&bars[i % stages], (i / stages) & 1);
    const unsigned char* ws = smem + (i % stages) * slot;
    const T* xs = reinterpret_cast<const T*>(ws + w_bytes);   // [B][ks]
    if constexpr (kMma) {
      for (int kk = wkg * 16; kk < ks; kk += kGroups * 16) {
        uint32_t a[4];
        ldmatrix_x4_trans(a, ws + w_offset<T>(kk + lrow, lcol, ks));
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          // B fragment: x[n = 8j + g][k = 2t, 2t+1] and [8 + 2t, 9 + 2t]
          const int n = j * 8 + g;
          uint32_t b0 = 0u, b1 = 0u;
          if (n < B) {
            b0 = *reinterpret_cast<const uint32_t*>(xs + n * ks + kk + 2 * t);
            b1 = *reinterpret_cast<const uint32_t*>(xs + n * ks + kk + 8
                                                    + 2 * t);
          }
          mma_16816(acc[j], a, b0, b1);
        }
      }
    } else {
      for (int r = fkg; r < ks; r += kGroups) {
        const float wv =
            *reinterpret_cast<const float*>(ws + w_offset<T>(r, fc, ks));
#pragma unroll
        for (int b = 0; b < kMaxB; ++b)
          if (b < B) acc[0][b] = fmaf(xs[b * ks + r], wv, acc[0][b]);
      }
    }
  }
  __syncthreads();  // every sub-tile is consumed: the epilogue reuses it

  float* red = reinterpret_cast<float*>(smem);     // [kGroups][B][MBLK]
  if constexpr (kMma) {
    // C fragment of tile j: (m = g, n = 2t, 2t+1) in c0, c1; (m = g + 8,
    // ...) in c2, c3; out[8j + n][m] = C[m][n]
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = j * 8 + 2 * t + h;
        if (n < B) {
          float* r = red + (wkg * B + n) * MBLK + mt * 16 + g;
          r[0] = acc[j][h];
          r[8] = acc[j][2 + h];
        }
      }
    }
  } else {
#pragma unroll
    for (int b = 0; b < kMaxB; ++b)
      if (b < B) red[(fkg * B + b) * MBLK + fc] = acc[0][b];
  }
  __syncthreads();
  finish<T, MBLK, CLUSTER, kGroups>(red, out, B, rows, M, col0, o_rs);
}

// One streaming problem, strides in elements: x rows x_rs apart and parts
// x_ps apart; w_t rows ld apart and parts w_ps apart; out rows o_rs apart
// and (without a cluster) parts o_ps apart.  Split-K: parts are the deg K
// parts of one x row and one w_t (x_ps = k_part, w_ps = k_part * ld),
// summed in a cluster into one out (o_ps = 0).  Grouped: parts are experts.
struct Problem {
  const void* x;
  const void* w;
  void* out;
  int R;          // x rows
  int M;
  int k_part;     // K rows a part walks
  int parts;
  long long ld, w_ps;
  long long x_rs, x_ps;
  long long o_rs, o_ps;
};

// What every launch takes: whole 16-byte vectors along M, 16-byte strides
// (TMA's rule) and aligned x and w_t, a K walk of whole 8-row groups in
// each part, a column block the kernels are built for (split among the
// cluster's ranks), a sub-tile of whole k16 steps that one box can span,
// and a ring the card's shared memory holds at B rows a box.
inline bool launchable(const Problem& p, int B, int m_blk, int ks,
                       int stages, int elem_bytes, bool cluster) {
  const int deg = cluster ? p.parts : 1;
  const auto strided = [elem_bytes](long long s) {
    return s > 0 && (s * elem_bytes) % 16 == 0;
  };
  return p.R >= 1 && B >= 1 && B <= p.R && p.M >= 1 && p.k_part >= 1
         && p.k_part % 8 == 0 && p.parts >= 1 && p.parts <= 65535
         && p.ld >= p.M && strided(p.ld) && strided(p.w_ps)
         && strided(p.x_rs) && strided(p.x_ps)
         && p.M % (16 / elem_bytes) == 0
         && (m_blk == 64 || m_blk == 128) && m_blk % deg == 0
         && deg <= kMaxDeg && ks >= 16 && ks % 16 == 0 && ks <= 256
         && stages >= 1 && stages <= kMaxStages
         && reinterpret_cast<uintptr_t>(p.x) % 16 == 0
         && reinterpret_cast<uintptr_t>(p.w) % 16 == 0
         && smem_bytes(B, m_blk, ks, stages, elem_bytes, deg)
                <= static_cast<size_t>(kMaxSmem);
}

// Host side, with internal linkage: each library that includes this header
// keeps its own once-per-instantiation flags below (a template's static
// local with external linkage would be one object across every library
// in the process).
namespace {

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no link
// against libcuda).
inline PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess
        || q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }();
  return fn;
}

// The two tensor maps of a problem: w_t as {M, k_part, parts} in boxes of
// one swizzled row by ks, x as {k_part, parts, R} (or {k_part, R, parts}
// when the parts lie further apart than the rows) in boxes of ks by B
// rows.  Sets *x_part_dim to the map dimension that is the part.
template <typename T>
bool encode_maps(CUtensorMap* tw, CUtensorMap* tx, int* x_part_dim,
                 const Problem& p, int B, int ks) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = encode_fn();
  if (encode == nullptr) return false;
  const CUtensorMapDataType type = std::is_same<T, bf16>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const cuuint64_t es = sizeof(T);
  const cuuint64_t kp = p.k_part;
  const cuuint64_t parts = p.parts, R = p.R;
  const cuuint64_t wdim[3] = {static_cast<cuuint64_t>(p.M), kp, parts};
  const cuuint64_t wstride[2] = {static_cast<cuuint64_t>(p.ld) * es,
                                 static_cast<cuuint64_t>(p.w_ps) * es};
  const cuuint32_t wbox[3] = {kRowBytes / sizeof(T),
                              static_cast<cuuint32_t>(ks), 1};
  const bool part_inner = p.x_ps <= p.x_rs;
  *x_part_dim = part_inner ? 1 : 2;
  const cuuint64_t xdim[3] = {kp, part_inner ? parts : R,
                              part_inner ? R : parts};
  const cuuint64_t xps = static_cast<cuuint64_t>(p.x_ps) * es;
  const cuuint64_t xrs = static_cast<cuuint64_t>(p.x_rs) * es;
  const cuuint64_t xstride[2] = {part_inner ? xps : xrs,
                                 part_inner ? xrs : xps};
  const cuuint32_t rows = static_cast<cuuint32_t>(B);
  const cuuint32_t xbox[3] = {static_cast<cuuint32_t>(ks),
                              part_inner ? 1u : rows, part_inner ? rows : 1u};
  const cuuint32_t ones[3] = {1, 1, 1};
  return encode(tw, type, 3, const_cast<void*>(p.w), wdim, wstride, wbox,
                ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
         && encode(tx, type, 3, const_cast<void*>(p.x), xdim, xstride, xbox,
                   ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                   CU_TENSOR_MAP_SWIZZLE_NONE,
                   CU_TENSOR_MAP_L2_PROMOTION_NONE,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int MBLK, int NT, bool CLUSTER>
int launch(const CUtensorMap& tw, const CUtensorMap& tx, const Problem& p,
           int B, int row0, int ks, int stages, int x_part_dim,
           cudaStream_t stream) {
  auto kernel = stream_kernel<T, MBLK, NT, CLUSTER>;
  // once per instantiation, at its first launch (never inside a graph
  // capture: callers warm up first): allow the opt-in shared memory
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int deg = CLUSTER ? p.parts : 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.M + MBLK - 1) / MBLK, p.parts, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes(B, MBLK, ks, stages, sizeof(T), deg);
  cfg.stream = stream;
  cudaLaunchAttribute attrs[1];
  if (CLUSTER) {
    attrs[0].id = cudaLaunchAttributeClusterDimension;
    attrs[0].val.clusterDim.x = 1;
    attrs[0].val.clusterDim.y = deg;
    attrs[0].val.clusterDim.z = 1;
    cfg.attrs = attrs;
    cfg.numAttrs = 1;
  }
  const int rows = p.R - row0 < B ? p.R - row0 : B;
  T* out = static_cast<T*>(p.out) + row0 * p.o_rs;
  const cudaError_t rc = cudaLaunchKernelEx(
      &cfg, kernel, tw, tx, out, B, rows, p.M, p.k_part, ks, stages, row0,
      x_part_dim, p.o_ps, p.o_rs);
  const cudaError_t last = cudaGetLastError();  // clear it either way
  return static_cast<int>(rc != cudaSuccess ? rc : last);
}

template <typename T, int MBLK, int MAX_NT, bool CLUSTER>
int launch_rows(const CUtensorMap& tw, const CUtensorMap& tx,
                const Problem& p, int B, int row0, int ks, int stages,
                int x_part_dim, cudaStream_t s) {
  if constexpr (MAX_NT >= 8) {
    if (B > 32)
      return launch<T, MBLK, 8, CLUSTER>(tw, tx, p, B, row0, ks, stages,
                                         x_part_dim, s);
  }
  if constexpr (MAX_NT >= 4) {
    if (B > 16)
      return launch<T, MBLK, 4, CLUSTER>(tw, tx, p, B, row0, ks, stages,
                                         x_part_dim, s);
  }
  if constexpr (MAX_NT >= 2) {
    if (B > 8)
      return launch<T, MBLK, 2, CLUSTER>(tw, tx, p, B, row0, ks, stages,
                                         x_part_dim, s);
  }
  return launch<T, MBLK, 1, CLUSTER>(tw, tx, p, B, row0, ks, stages,
                                     x_part_dim, s);
}

// The problem in launches of up to MAX_NT * 8 rows (bf16) or kMaxB (f32),
// each over the same two tensor maps; returns the first failing launch's
// CUDA error, else 0.
template <typename T, bool CLUSTER, int MAX_NT>
int run(const Problem& p, int m_blk, int ks, int stages, void* stream) {
  constexpr bool kMma = std::is_same<T, bf16>::value;
  constexpr int kRows = kMma ? MAX_NT * 8 : kMaxB;
  const int B = p.R < kRows ? p.R : kRows;
  if (!launchable(p, B, m_blk, ks, stages, sizeof(T), CLUSTER))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tw, tx;
  int x_part_dim = 1;
  if (!encode_maps<T>(&tw, &tx, &x_part_dim, p, B, ks))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kNt = kMma ? MAX_NT : 1;
  for (int row0 = 0; row0 < p.R; row0 += B) {
    const int rc =
        m_blk == 64
            ? launch_rows<T, 64, kNt, CLUSTER>(tw, tx, p, B, row0, ks,
                                                stages, x_part_dim, s)
            : launch_rows<T, 128, kNt, CLUSTER>(tw, tx, p, B, row0, ks,
                                                 stages, x_part_dim, s);
    if (rc != 0) return rc;
  }
  return 0;
}

// out[B, M] = x[B, K] @ w_t[K, M] over deg K parts (deg 1: pim_gemv; with
// CLUSTER: splitk_gemv's cluster reduce), x contiguous, B <= kMaxB.
template <typename T, bool CLUSTER>
int run_dense(const void* x, const void* w, void* out, int B, int K, int M,
              int ld, int deg, int m_blk, int ks, int stages, void* stream) {
  if (B > kMaxB || deg < 1 || K % deg)
    return static_cast<int>(cudaErrorInvalidValue);
  const int kp = K / deg;
  const Problem p{x, w, out, B, M, kp, deg,
                  ld, static_cast<long long>(kp) * ld,
                  K, kp, M, 0};
  return run<T, CLUSTER, 1>(p, m_blk, ks, stages, stream);
}

}  // namespace

}  // namespace gemv_stream
