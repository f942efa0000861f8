// Streaming decode GEMV body for Hopper (sm_90a), shared by pim_gemv.cu,
// splitk_gemv.cu, quant_gemv.cu, triton_gemv.cu and both kernels of
// grouped_gemv.cu.
//
//   out[p][R, M] = x[p][R, K] @ w_t[p][K, M]      (w_t K-major)
//
// p runs over `parts` (blockIdx.y): the K parts of a split-K launch (whose
// sums meet in a cluster), or the experts of a grouped launch, or just one.
// The body is one CTA's K walk (`walk`): stream_kernel runs one a CTA;
// ragged_gemv's kernel picks its expert on the device and runs one walk a
// row chunk, the expert as a fourth dimension of the weight map.
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
//
// Quantized codes (Q = 8 or 4: quant_gemv.cu).  w_t holds int8 codes
// [K, M], or packed int4 [K / 2, M] (stored row i: K row 2i in the low
// nibble, 2i + 1 in the high one), with one f32 scale per (block of
// `block` K rows, column) in s [K / block, M]:
//
//   out[R, M] = sum over blocks b of  s[b, :] * (x[:, b] @ q[b, :])
//
// A slot holds one box of ks stored rows of m_blk code bytes (m_blk
// columns; 128 rows of 128, or 256 of 64: 16 KB), the box of the
// kx / block scale rows of the column block, and x's box of the kx = ks
// (int8) or 2 ks (int4) K rows, all counted on the slot's mbarrier: codes
// and their scales arrive together.  The code box lands in the 128-byte (64-
// byte for m_blk = 64) swizzle.  Every code is an integer bf16 holds
// exactly; it is turned into bf16 in registers without a conversion
// instruction (int8: the byte, offset by 128, is put under the exponent of
// 2^23 with prmt, 2^23 + 128 is subtracted in f32 and a prmt packs the
// upper halves of the pair, which are exact bf16s; int4: one lop3 puts the offset nibble under the exponent of
// 128 in bf16 and a bf16x2 subtraction of 136 recovers it), and fed to
// the same mma.sync as the bf16 weights: warp w owns the m16 tile of
// columns 16 (w % (m_blk / 16)) .. + 15, its A row r being column
// 2 (r % 8) + r / 8 of the tile, so a thread's two rows are two
// neighbouring code bytes, read as one 16-bit shared load per K row (the
// int4 pairs of neighbouring K rows come from one byte).  Each scale block
// is accumulated into a zeroed fragment and then added as
// acc = fma(s[col], part, acc) in f32: bf16 x bf16 products are exact in
// f32, so only the order of the f32 sums differs from the plain version
// (which multiplies q * s first).  Warps of one column range (m_blk = 64)
// take every second block.  f32 x runs scalar f32 FMAs per block, then the
// same scale FMA.
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

// K rows of one sub-tile of ks stored rows (int4 packs two a byte).
__host__ __device__ inline int sub_k(int ks, int q) {
  return q == 4 ? 2 * ks : ks;
}

// One ring slot: the weight boxes [ks][m_blk] and x's box [B][ks] (B: the
// rows of the box); for codes (q = 8 / 4) the code box [ks][m_blk] bytes,
// the scale box [kx / block][m_blk] f32 and x's box [B][kx].
__host__ __device__ inline size_t slot_bytes(int B, int m_blk, int ks,
                                             int elem_bytes, int q = 0,
                                             int block = 32) {
  const int kx = sub_k(ks, q);
  const size_t bytes =
      q ? static_cast<size_t>(m_blk) * ks
              + static_cast<size_t>(B) * kx * elem_bytes
              + sizeof(float) * (kx / block) * m_blk
        : (static_cast<size_t>(m_blk) + B) * ks * elem_bytes;
  return (bytes + kAlign - 1) / kAlign * kAlign;
}

// The ring, or the epilogue (the k groups' sums, then split-K's partial
// tile) that reuses it, if larger.
__host__ __device__ inline size_t body_bytes(int B, int m_blk, int ks,
                                             int stages, int elem_bytes,
                                             int deg, int q = 0,
                                             int block = 32) {
  const size_t ring =
      stages * slot_bytes(B, m_blk, ks, elem_bytes, q, block);
  const size_t epi = sizeof(float) * B * m_blk
                     * (groups(m_blk, elem_bytes) + (deg > 1 ? 1 : 0));
  return ring > epi ? ring : epi;
}

// Dynamic shared memory of a launch: alignment slack, the body, and one
// mbarrier per slot.
inline size_t smem_bytes(int B, int m_blk, int ks, int stages,
                         int elem_bytes, int deg, int q = 0,
                         int block = 32) {
  return kAlign
         + body_bytes(B, m_blk, ks, stages, elem_bytes, deg, q, block)
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

// A box of a 4-D tensor map (an expert stack's K parts) into shared
// memory, counted on bar.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_addr(bar))
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

// Byte offset of code byte c of stored row r in a slot's code box of
// PITCH-byte rows: the TMA's 128-byte (PITCH 128) or 64-byte (PITCH 64)
// swizzle XORs address bits 4-6 (4-5) with bits 7-9 (7-8).
template <int PITCH>
__device__ __forceinline__ int code_offset(int r, int c) {
  const int a = r * PITCH + c;
  return a ^ ((a >> 3) & (PITCH == 128 ? 0x70 : 0x30));
}

__device__ __forceinline__ uint32_t lds16(const unsigned char* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b,
                                         uint32_t sel) {
  return __byte_perm(a, b, sel);
}

// bf16x2 of two int8 codes held offset by 128 (u = q ^ 0x80) in bytes lo
// and hi of w: each byte goes under the exponent of 2^23 (the f32
// 2^23 + u) and 2^23 + 128 is subtracted (exact); a small integer's f32
// has a zero low half, so its upper half is its bf16, and one prmt packs
// the pair, lo in the low half.
__device__ __forceinline__ uint32_t int8_pair(uint32_t w, int lo, int hi) {
  const float f_lo = __fsub_rn(
      __uint_as_float(prmt(w, 0x4B000000u, 0x7540u | lo)), 8388736.f);
  const float f_hi = __fsub_rn(
      __uint_as_float(prmt(w, 0x4B000000u, 0x7540u | hi)), 8388736.f);
  return prmt(__float_as_uint(f_lo), __float_as_uint(f_hi), 0x7632u);
}

// bf16x2 of the two signed nibbles of byte i of w (low nibble in the low
// half); sh = w >> 4.  One lop3 gives (nibble ^ 8) under the exponent of
// 128: the bf16 136 + q; subtracting 136 is exact.
__device__ __forceinline__ uint32_t int4_pair(uint32_t w, uint32_t sh,
                                              int i) {
  const uint32_t r = prmt(w, sh, i | (i << 4) | ((4 + i) << 8)
                                     | ((4 + i) << 12));
  uint32_t v;
  asm("lop3.b32 %0, %1, %2, %3, 0x6A;\n"      // (a & b) ^ c
      : "=r"(v) : "r"(r), "r"(0x000F000Fu), "r"(0x43084308u));
  const uint32_t k136 = 0x43084308u;
  const __nv_bfloat162 d =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
              *reinterpret_cast<const __nv_bfloat162*>(&k136));
  return *reinterpret_cast<const uint32_t*>(&d);
}

// Byte offsets, in a code box of PITCH-byte rows, of the code rows the
// thread at (g, t) reads in a k16 step at K row 0, for its A rows g, g + 8
// (code columns cq, cq + 1): int8 K rows 2t, 2t + 1, 2t + 8, 2t + 9; int4
// stored rows t (K rows 2t, 2t + 1) and t + 4.  The step at K row kk (a
// multiple of 16) reads them kk (int8) or kk / 2 (int4) rows further: the
// swizzle's XOR pattern repeats every 8 rows, so it adds whole rows.
template <int Q, int PITCH>
__device__ __forceinline__ void code_rows(int (&off)[4], int cq, int t) {
  if constexpr (Q == 8) {
    off[0] = code_offset<PITCH>(2 * t, cq);
    off[1] = code_offset<PITCH>(2 * t + 1, cq);
    off[2] = code_offset<PITCH>(2 * t + 8, cq);
    off[3] = code_offset<PITCH>(2 * t + 9, cq);
  } else {
    off[0] = code_offset<PITCH>(t, cq);
    off[1] = code_offset<PITCH>(t + 4, cq);
    off[2] = off[3] = 0;
  }
}

// The A fragment of one k16 step of codes for the thread at (g, t) whose A
// rows g, g + 8 are the code columns cq, cq + 1: registers (row, k) =
// (g, 2t|2t+1), (g + 8, 2t|2t+1), (g, 2t+8|2t+9), (g + 8, 2t+8|2t+9), each
// pair k-ascending from the low half.  rows: the step's first code row;
// off: code_rows'.
template <int Q>
__device__ __forceinline__ void code_fragment(uint32_t (&a)[4],
                                              const unsigned char* rows,
                                              const int (&off)[4]) {
  if constexpr (Q == 8) {
    // bytes [(cq, r), (cq + 1, r), (cq, r + 1), (cq + 1, r + 1)], + 128
    const uint32_t w0 = prmt(lds16(rows + off[0]), lds16(rows + off[1]),
                             0x5410u) ^ 0x80808080u;
    const uint32_t w1 = prmt(lds16(rows + off[2]), lds16(rows + off[3]),
                             0x5410u) ^ 0x80808080u;
    a[0] = int8_pair(w0, 0, 2);
    a[1] = int8_pair(w0, 1, 3);
    a[2] = int8_pair(w1, 0, 2);
    a[3] = int8_pair(w1, 1, 3);
  } else {
    // bytes [(cq, r), (cq + 1, r), (cq, r + 4), (cq + 1, r + 4)]
    const uint32_t w = prmt(lds16(rows + off[0]), lds16(rows + off[1]),
                            0x5410u);
    const uint32_t sh = w >> 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = int4_pair(w, sh, i);
  }
}

// Code (q) of K row k, column c, as f32 (the scalar f32 path).
template <int Q, int PITCH>
__device__ __forceinline__ float code_value(const unsigned char* ws, int k,
                                            int c) {
  if constexpr (Q == 8) {
    return static_cast<float>(
        static_cast<int8_t>(ws[code_offset<PITCH>(k, c)]));
  } else {
    const unsigned u = ws[code_offset<PITCH>(k / 2, c)];
    // sign-extended nibble: the low one by shifting it to the top first
    const int8_t top = static_cast<int8_t>((k & 1) ? u : u << 4);
    return static_cast<float>(top >> 4);
  }
}

// The epilogue: red holds the k groups' f32 sums [kGroups][B][MBLK]; add
// them in group order, then (no cluster) cast and write the first `rows`
// rows of out, or (split-K) keep the partial [B][MBLK] behind them and sum
// the cluster's partials in rank order through distributed shared memory.
// keep (or null: every row) flags the rows that are stored.
template <typename T, int MBLK, bool CLUSTER, int kGroups>
__device__ __forceinline__ void finish(float* red, T* __restrict__ out,
                                       int B, int rows, int M, int col0,
                                       long long o_rs,
                                       const unsigned char* keep) {
  const int tid = threadIdx.x;
  float* part = red + kGroups * B * MBLK;          // [B][MBLK], split-K
  const auto stored = [&](int b) {
    return b < rows && (keep == nullptr || keep[b]);
  };
  for (int i = tid; i < B * MBLK; i += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kGroups; ++q) s += red[q * B * MBLK + i];
    if constexpr (CLUSTER) {
      part[i] = s;
    } else {
      const int c = col0 + i % MBLK;
      const int b = i / MBLK;
      if (c < M && stored(b)) store(s, out + b * o_rs + c);
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
      if (col0 + c < M && stored(b)) store(s, out + b * o_rs + col0 + c);
    }
    cluster.sync();  // no CTA leaves while a peer still reads its tile
  }
}

// The dynamic shared memory of a kernel, moved up to the swizzle's 1 KB.
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((kAlign - (smem_addr(raw) & (kAlign - 1))) & (kAlign - 1));
}

// One mbarrier per ring slot, made visible to the copy engine; the walk's
// first __syncthreads() publishes them to the CTA.
__device__ __forceinline__ void init_bars(uint64_t* bars, int stages) {
  if (threadIdx.x == 0) {
    for (int q = 0; q < stages; ++q) mbar_init(&bars[q], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// What one K walk of a CTA streams and stores.  The box holds B rows of x,
// copied xbox rows at a time (B a multiple of xbox); `rows` of them are
// stored (those keep flags, when keep is not null), rows o_rs apart from
// `out`.  The weight boxes come from map coordinates (column, K row of the
// part, wpart) or, for an expert stack, (column, K row, wpart, expert);
// x's from (K row, xpart, xrow) when x_part_dim is 1, else (K row, xrow,
// xpart).  seq counts the sub-tiles the CTA's ring took before this walk:
// slot and mbarrier phase follow from it, so one CTA can walk many times.
struct Walk {
  int B, xbox, rows;
  const unsigned char* keep;
  int M, k_part, ks, stages, seq, block, col0;
  int wpart, expert, xpart, xrow, x_part_dim;
  long long o_rs;
};

// One K walk through the ring and its epilogue (see the header).  Q: 0 for
// weights of type T (ts unused), 8 / 4 for int8 / packed int4 codes scaled
// per `block` K rows by the f32 map ts; ks counts stored rows.  EXPERT:
// the weight map has the expert as a fourth dimension.
template <typename T, int MBLK, int NT, bool CLUSTER, int Q, bool EXPERT>
__device__ __forceinline__ void walk(const CUtensorMap& tw,
                                     const CUtensorMap& tx,
                                     const CUtensorMap& ts,
                                     unsigned char* smem, uint64_t* bars,
                                     T* __restrict__ out, const Walk& a) {
  constexpr bool kMma = std::is_same<T, bf16>::value;
  static_assert(kMma || NT == 1, "f32 holds kMaxB rows a launch");
  static_assert(Q == 0 || Q == 8 || Q == 4, "codes are int8 or int4");
  // weight columns of one box, and bytes of one box row
  constexpr int kBoxCols = Q ? MBLK : kRowBytes / sizeof(T);
  constexpr int kPitch = Q ? MBLK : kRowBytes;
  constexpr int kTiles = MBLK / 16;          // m16 tiles (bf16)
  constexpr int kGroups = (kMma ? kWarps * 16 : kThreads) / MBLK;
  const int B = a.B, ks = a.ks, stages = a.stages;
  const int slot =
      static_cast<int>(slot_bytes(B, MBLK, ks, sizeof(T), Q, a.block));
  const int tid = threadIdx.x;
  const int col0 = a.col0;
  const int kx = sub_k(ks, Q);               // K rows of one sub-tile
  const int n_sub = (a.k_part + kx - 1) / kx;
  const int w_bytes = MBLK * ks * (Q ? 1 : static_cast<int>(sizeof(T)));
  const int s_rows = Q ? kx / a.block : 0;   // scale blocks of a sub-tile
  // slot: weights (or codes), scales, x; every box starts 128-byte aligned
  const int s_bytes = s_rows * MBLK * static_cast<int>(sizeof(float));
  const unsigned tx_bytes = static_cast<unsigned>(
      w_bytes + s_bytes + B * kx * static_cast<int>(sizeof(T)));

  __syncthreads();  // the barriers are set and the ring (or the epilogue
                    // of the CTA's last walk) is free
  // One thread asks for sub-tile i (K rows [i * kx, + kx) of the part) in
  // slot (seq + i) % stages: its weight boxes, its x boxes and (codes) its
  // scales.
  auto issue = [&](int i) {
    const int q = (a.seq + i) % stages;
    unsigned char* ws = smem + q * slot;
    uint64_t* bar = &bars[q];
    mbar_expect_tx(bar, tx_bytes);
#pragma unroll
    for (int h = 0; h < MBLK / kBoxCols; ++h) {
      if constexpr (EXPERT)
        tma_load_4d(ws + h * ks * kPitch, &tw, col0 + h * kBoxCols, i * ks,
                    a.wpart, a.expert, bar);
      else
        tma_load_3d(ws + h * ks * kPitch, &tw, col0 + h * kBoxCols, i * ks,
                    a.wpart, bar);
    }
    if constexpr (Q != 0)
      tma_load_3d(ws + w_bytes, &ts, col0, i * s_rows, a.wpart, bar);
    for (int r = 0; r < B; r += a.xbox) {
      unsigned char* xd = ws + w_bytes + s_bytes
                          + r * kx * static_cast<int>(sizeof(T));
      if (a.x_part_dim == 1)
        tma_load_3d(xd, &tx, i * kx, a.xpart, a.xrow + r, bar);
      else
        tma_load_3d(xd, &tx, i * kx, a.xrow + r, a.xpart, bar);
    }
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
  // codes: A rows g, g + 8 of the warp's tile are columns cq, cq + 1
  const int cq = mt * 16 + 2 * g;
  int coff[4] = {0, 0, 0, 0};
  if constexpr (Q != 0) code_rows<Q, kPitch>(coff, cq, t);

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
    const int q = (a.seq + i) % stages;
    mbar_wait(&bars[q], ((a.seq + i) / stages) & 1);
    const unsigned char* ws = smem + q * slot;
    const float* ss = reinterpret_cast<const float*>(ws + w_bytes);
    const T* xs = reinterpret_cast<const T*>(ws + w_bytes + s_bytes);
    if constexpr (kMma && Q == 0) {
      for (int kk = wkg * 16; kk < ks; kk += kGroups * 16) {
        uint32_t a4[4];
        ldmatrix_x4_trans(a4, ws + w_offset<T>(kk + lrow, lcol, ks));
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (j * 8 >= B) break;   // a tile past the box: never stored
          // B fragment: x[n = 8j + g][k = 2t, 2t+1] and [8 + 2t, 9 + 2t]
          const int n = j * 8 + g;
          uint32_t b0 = 0u, b1 = 0u;
          if (n < B) {
            b0 = *reinterpret_cast<const uint32_t*>(xs + n * kx + kk + 2 * t);
            b1 = *reinterpret_cast<const uint32_t*>(xs + n * kx + kk + 8
                                                    + 2 * t);
          }
          mma_16816(acc[j], a4, b0, b1);
        }
      }
    } else if constexpr (kMma) {
      // codes: each scale block of the sub-tile into a zeroed fragment,
      // then scaled into acc; k group wkg takes every kGroups-th block
      for (int bi = wkg; bi < s_rows; bi += kGroups) {
        float sum[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) sum[j][q] = 0.f;
#pragma unroll 2
        for (int kk = bi * a.block; kk < (bi + 1) * a.block; kk += 16) {
          uint32_t a4[4];
          code_fragment<Q>(a4, ws + (Q == 4 ? kk / 2 : kk) * kPitch, coff);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const int n = j * 8 + g;
            uint32_t b0 = 0u, b1 = 0u;
            if (n < B) {
              b0 = *reinterpret_cast<const uint32_t*>(xs + n * kx + kk
                                                      + 2 * t);
              b1 = *reinterpret_cast<const uint32_t*>(xs + n * kx + kk + 8
                                                      + 2 * t);
            }
            mma_16816(sum[j], a4, b0, b1);
          }
        }
        // C rows g, g + 8 are columns cq, cq + 1
        const float2 s = *reinterpret_cast<const float2*>(ss + bi * MBLK
                                                          + cq);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          acc[j][0] = fmaf(s.x, sum[j][0], acc[j][0]);
          acc[j][1] = fmaf(s.x, sum[j][1], acc[j][1]);
          acc[j][2] = fmaf(s.y, sum[j][2], acc[j][2]);
          acc[j][3] = fmaf(s.y, sum[j][3], acc[j][3]);
        }
      }
    } else if constexpr (Q == 0) {
      for (int r = fkg; r < ks; r += kGroups) {
        const float wv =
            *reinterpret_cast<const float*>(ws + w_offset<T>(r, fc, ks));
#pragma unroll
        for (int b = 0; b < kMaxB; ++b)
          if (b < B) acc[0][b] = fmaf(xs[b * kx + r], wv, acc[0][b]);
      }
    } else {
      for (int bi = fkg; bi < s_rows; bi += kGroups) {
        float sum[kMaxB];
#pragma unroll
        for (int b = 0; b < kMaxB; ++b) sum[b] = 0.f;
        for (int k = bi * a.block; k < (bi + 1) * a.block; ++k) {
          const float wv = code_value<Q, kPitch>(ws, k, fc);
#pragma unroll
          for (int b = 0; b < kMaxB; ++b)
            if (b < B) sum[b] = fmaf(xs[b * kx + k], wv, sum[b]);
        }
        const float s = ss[bi * MBLK + fc];
#pragma unroll
        for (int b = 0; b < kMaxB; ++b) acc[0][b] = fmaf(s, sum[b], acc[0][b]);
      }
    }
  }
  __syncthreads();  // every sub-tile is consumed: the epilogue reuses it

  float* red = reinterpret_cast<float*>(smem);     // [kGroups][B][MBLK]
  if constexpr (kMma) {
    // C fragment of tile j: (m = g, n = 2t, 2t+1) in c0, c1; (m = g + 8,
    // ...) in c2, c3; out[8j + n][col(m)] = C[m][n], col(m) = mt * 16 + m
    // for weights and cq + (m >= 8) for codes
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = j * 8 + 2 * t + h;
        if (n < B) {
          float* r = red + (wkg * B + n) * MBLK + (Q ? cq : mt * 16 + g);
          r[0] = acc[j][h];
          r[Q ? 1 : 8] = acc[j][2 + h];
        }
      }
    }
  } else {
#pragma unroll
    for (int b = 0; b < kMaxB; ++b)
      if (b < B) red[(fkg * B + b) * MBLK + fc] = acc[0][b];
  }
  __syncthreads();
  finish<T, MBLK, CLUSTER, kGroups>(red, out, B, a.rows, a.M, col0, a.o_rs,
                                    a.keep);
}

// Grid (ceil(M / MBLK), parts); with CLUSTER the parts of a column block are
// one cluster and share `out`, else part p writes out + p * o_ps.  B is
// the rows of x's box (at most NT * 8 for bf16, kMaxB for f32), `rows` of
// them (from row0 on) are stored; out rows lie o_rs apart, and `out`
// already points at row0.  x_part_dim says which dimension of x's map is
// the part (1) and which the row (the other).
template <typename T, int MBLK, int NT, bool CLUSTER, int Q>
__global__ void __launch_bounds__(kThreads,
                                  (Q != 0 || NT > 4) ? 2 : kMinCtasPerSm)
stream_kernel(const __grid_constant__ CUtensorMap tw,
              const __grid_constant__ CUtensorMap tx,
              const __grid_constant__ CUtensorMap ts, T* __restrict__ out,
              int B, int rows, int M, int k_part, int ks, int stages,
              int row0, int x_part_dim, long long o_ps, long long o_rs,
              int block) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      smem + body_bytes(B, MBLK, ks, stages, sizeof(T), CLUSTER ? 2 : 1, Q,
                        block));
  init_bars(bars, stages);
  const int part = blockIdx.y;
  const Walk a{B, B, rows, nullptr, M, k_part, ks, stages, 0, block,
               static_cast<int>(blockIdx.x) * MBLK, part, 0, part, row0,
               x_part_dim, o_rs};
  walk<T, MBLK, NT, CLUSTER, Q, false>(tw, tx, ts, smem, bars,
                                       CLUSTER ? out : out + part * o_ps, a);
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
  // codes only: f32 scales [k_part / block, M] a part, rows lds floats
  // apart, parts s_ps apart (w, ld and w_ps then count code bytes)
  const void* s = nullptr;
  long long lds = 0, s_ps = 0;
  int block = 0;
  // expert stacks split in K parts (ragged_gemv): w_t's parts of each of
  // `experts` experts, the experts w_es apart (0: no expert dimension)
  int experts = 0;
  long long w_es = 0;
};

// What every launch takes: whole 16-byte vectors along M, 16-byte strides
// (TMA's rule) and aligned x and w_t, a K walk of whole 8-row groups in
// each part, a column block the kernels are built for (split among the
// cluster's ranks), a sub-tile of whole k16 steps that one box can span,
// and a ring the card's shared memory holds at B rows a box.  Codes (q =
// 8 / 4): a 128- or 64-byte code box, a K part and a sub-tile of whole
// scale blocks of whole k16 steps, and aligned scales with 16-byte strides.
inline bool launchable(const Problem& p, int B, int m_blk, int ks,
                       int stages, int elem_bytes, bool cluster, int q = 0) {
  const int deg = cluster ? p.parts : 1;
  const int w_elem = q ? 1 : elem_bytes;
  const auto strided = [](long long s, int e) {
    return s > 0 && (s * e) % 16 == 0;
  };
  const auto aligned = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  const int kx = sub_k(ks, q);
  const bool shape_ok =
      q == 0 ? ks >= 16 && ks % 16 == 0 && ks <= 256
             : (q == 8 || q == 4) && p.block >= 16 && p.block % 16 == 0
                   && p.k_part % p.block == 0 && ks >= 1 && kx % p.block == 0
                   && ks <= 256 && kx <= 256 && p.s != nullptr
                   && aligned(p.s) && p.lds >= p.M && strided(p.lds, 4)
                   && strided(p.s_ps, 4);
  return p.R >= 1 && B >= 1 && B <= p.R && p.M >= 1 && p.k_part >= 1
         && p.k_part % 8 == 0 && p.parts >= 1 && p.parts <= 65535
         && p.ld >= p.M && strided(p.ld, w_elem) && strided(p.w_ps, w_elem)
         && (p.experts == 0 || strided(p.w_es, w_elem))
         && strided(p.x_rs, elem_bytes) && strided(p.x_ps, elem_bytes)
         && p.M % (16 / w_elem) == 0
         && (m_blk == 64 || m_blk == 128) && m_blk % deg == 0
         && deg <= kMaxDeg && shape_ok
         && stages >= 1 && stages <= kMaxStages
         && aligned(p.x) && aligned(p.w)
         && smem_bytes(B, m_blk, ks, stages, elem_bytes, deg, q, p.block)
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

// The tensor maps of a problem: w_t as {M, k_part, parts} (an expert
// stack: {M, k_part, parts, experts}) in boxes of one swizzled row by ks,
// x as {k_part, parts, R} (or {k_part, R, parts} when
// the parts lie further apart than the rows) in boxes of kx by B rows.
// Codes (Q): w_t as bytes {M, stored rows of a part, parts} in boxes of
// m_blk by ks, and the scales as {M, k_part / block, parts} in boxes of
// m_blk by kx / block (ts; left alone for weights).  Sets *x_part_dim to
// the map dimension that is the part.
template <typename T, int Q>
bool encode_maps(CUtensorMap* tw, CUtensorMap* tx, CUtensorMap* ts,
                 int* x_part_dim, const Problem& p, int B, int m_blk,
                 int ks) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = encode_fn();
  if (encode == nullptr) return false;
  const CUtensorMapDataType type = std::is_same<T, bf16>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const cuuint64_t es = sizeof(T);
  const cuuint64_t we = Q ? 1 : sizeof(T);
  const cuuint64_t kp = p.k_part;
  const cuuint64_t parts = p.parts, R = p.R;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const cuuint64_t wdim[4] = {static_cast<cuuint64_t>(p.M),
                              Q == 4 ? kp / 2 : kp, parts,
                              static_cast<cuuint64_t>(p.experts)};
  const cuuint64_t wstride[3] = {static_cast<cuuint64_t>(p.ld) * we,
                                 static_cast<cuuint64_t>(p.w_ps) * we,
                                 static_cast<cuuint64_t>(p.w_es) * we};
  const cuuint32_t wbox[4] = {
      static_cast<cuuint32_t>(Q ? m_blk : kRowBytes / sizeof(T)),
      static_cast<cuuint32_t>(ks), 1, 1};
  const bool part_inner = p.x_ps <= p.x_rs;
  *x_part_dim = part_inner ? 1 : 2;
  const cuuint64_t xdim[3] = {kp, part_inner ? parts : R,
                              part_inner ? R : parts};
  const cuuint64_t xps = static_cast<cuuint64_t>(p.x_ps) * es;
  const cuuint64_t xrs = static_cast<cuuint64_t>(p.x_rs) * es;
  const cuuint64_t xstride[2] = {part_inner ? xps : xrs,
                                 part_inner ? xrs : xps};
  const cuuint32_t rows = static_cast<cuuint32_t>(B);
  const cuuint32_t xbox[3] = {static_cast<cuuint32_t>(sub_k(ks, Q)),
                              part_inner ? 1u : rows, part_inner ? rows : 1u};
  if (encode(tw, Q ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : type,
             p.experts ? 4 : 3,
             const_cast<void*>(p.w), wdim, wstride, wbox, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             Q && m_blk == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                              : CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS
      || encode(tx, type, 3, const_cast<void*>(p.x), xdim, xstride, xbox,
                ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  if constexpr (Q == 0) {
    return true;
  } else {
    const cuuint64_t sdim[3] = {static_cast<cuuint64_t>(p.M),
                                kp / p.block, parts};
    const cuuint64_t sstride[2] = {static_cast<cuuint64_t>(p.lds) * 4,
                                   static_cast<cuuint64_t>(p.s_ps) * 4};
    const cuuint32_t sbox[3] = {static_cast<cuuint32_t>(m_blk),
                                static_cast<cuuint32_t>(sub_k(ks, Q)
                                                        / p.block), 1};
    return encode(ts, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                  const_cast<void*>(p.s), sdim, sstride, sbox, ones,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  }
}

// Launch kKernel on grid (n_m, y) of kThreads-thread CTAs with `smem`
// bytes of dynamic shared memory, the blocks of y in clusters of deg (1:
// no cluster); returns the launch's CUDA error.
template <auto kKernel, typename... Args>
int launch_ex(int n_m, int y, size_t smem, int deg, cudaStream_t stream,
              Args... args) {
  // once per kernel, at its first launch (never inside a graph capture:
  // callers warm up first): allow the opt-in shared memory beside the
  // kernel's static shared memory
  static const cudaError_t attr = [] {
    cudaFuncAttributes fa;
    const cudaError_t rc = cudaFuncGetAttributes(&fa, kKernel);
    if (rc != cudaSuccess) return rc;
    return cudaFuncSetAttribute(
        kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem - static_cast<int>(fa.sharedSizeBytes));
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_m, y, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[1];
  if (deg > 1) {
    attrs[0].id = cudaLaunchAttributeClusterDimension;
    attrs[0].val.clusterDim.x = 1;
    attrs[0].val.clusterDim.y = deg;
    attrs[0].val.clusterDim.z = 1;
    cfg.attrs = attrs;
    cfg.numAttrs = 1;
  }
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, kKernel, args...);
  const cudaError_t last = cudaGetLastError();  // clear it either way
  return static_cast<int>(rc != cudaSuccess ? rc : last);
}

template <typename T, int MBLK, int NT, bool CLUSTER, int Q>
int launch(const CUtensorMap& tw, const CUtensorMap& tx,
           const CUtensorMap& ts, const Problem& p, int B, int row0, int ks,
           int stages, int x_part_dim, cudaStream_t stream) {
  const int deg = CLUSTER ? p.parts : 1;
  const int rows = p.R - row0 < B ? p.R - row0 : B;
  T* out = static_cast<T*>(p.out) + row0 * p.o_rs;
  return launch_ex<stream_kernel<T, MBLK, NT, CLUSTER, Q>>(
      (p.M + MBLK - 1) / MBLK, p.parts,
      smem_bytes(B, MBLK, ks, stages, sizeof(T), deg, Q, p.block), deg,
      stream, tw, tx, ts, out, B, rows, p.M, p.k_part, ks, stages, row0,
      x_part_dim, p.o_ps, p.o_rs, p.block);
}

template <typename T, int MBLK, int MAX_NT, bool CLUSTER, int Q>
int launch_rows(const CUtensorMap& tw, const CUtensorMap& tx,
                const CUtensorMap& ts, const Problem& p, int B, int row0,
                int ks, int stages, int x_part_dim, cudaStream_t s) {
  if constexpr (MAX_NT >= 8) {
    if (B > 32)
      return launch<T, MBLK, 8, CLUSTER, Q>(tw, tx, ts, p, B, row0, ks,
                                            stages, x_part_dim, s);
  }
  if constexpr (MAX_NT >= 4) {
    if (B > 16)
      return launch<T, MBLK, 4, CLUSTER, Q>(tw, tx, ts, p, B, row0, ks,
                                            stages, x_part_dim, s);
  }
  if constexpr (MAX_NT >= 2) {
    if (B > 8)
      return launch<T, MBLK, 2, CLUSTER, Q>(tw, tx, ts, p, B, row0, ks,
                                            stages, x_part_dim, s);
  }
  return launch<T, MBLK, 1, CLUSTER, Q>(tw, tx, ts, p, B, row0, ks, stages,
                                        x_part_dim, s);
}

// The problem in launches of up to MAX_NT * 8 rows (bf16) or kMaxB (f32),
// each over the same tensor maps; returns the first failing launch's CUDA
// error, else 0.  ks counts stored rows (Q = 4: half the sub-tile's K).
template <typename T, bool CLUSTER, int MAX_NT, int Q = 0>
int run(const Problem& p, int m_blk, int ks, int stages, void* stream) {
  constexpr bool kMma = std::is_same<T, bf16>::value;
  constexpr int kRows = kMma ? MAX_NT * 8 : kMaxB;
  const int B = p.R < kRows ? p.R : kRows;
  if (!launchable(p, B, m_blk, ks, stages, sizeof(T), CLUSTER, Q))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tw, tx, ts;
  int x_part_dim = 1;
  if (!encode_maps<T, Q>(&tw, &tx, &ts, &x_part_dim, p, B, m_blk, ks))
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (Q == 0) ts = tw;   // an operand the weight kernels ignore
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kNt = kMma ? MAX_NT : 1;
  for (int row0 = 0; row0 < p.R; row0 += B) {
    const int rc =
        m_blk == 64
            ? launch_rows<T, 64, kNt, CLUSTER, Q>(tw, tx, ts, p, B, row0,
                                                   ks, stages, x_part_dim, s)
            : launch_rows<T, 128, kNt, CLUSTER, Q>(tw, tx, ts, p, B, row0,
                                                    ks, stages, x_part_dim,
                                                    s);
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
