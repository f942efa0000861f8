// Expert-stack decode GEMVs for Hopper (sm_90a): the grouped and the ragged
// program shapes of an MoE layer.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/grouped_gemv.py:
//
//   grouped_gemv (body _grouped_kernel):
//       out[E, C, M] = xs[E, C, K] @ w[E, K, M]          (uniform C rows)
//   ragged_gemv (body _ragged_kernel):
//       out[T, M], row t = x[t] @ w[e] for offsets[e] <= t < offsets[e + 1];
//       rows offsets[E] <= t < T come back zero
//
// Bound on this card: at decode an expert sees a handful of rows (at most
// one per token), so each weight element feeds 2 * rows flops, far below the
// ~295 flops/byte where an H100 stops being memory bound: the floor is the
// bytes of the experts that have rows, over HBM bandwidth (3.35 TB/s).
//
// grouped_gemv runs the streaming body of the dense kernels
// (gemv_stream.cuh) with the expert as the third dimension of both tensor
// maps: the stack as {M, K, E} (rows ld apart, experts es apart) and xs as
// {K, C, E} (rows x_rs apart, experts x_es apart), so expert and row views
// run in place.  One CTA per (column block, expert) streams the expert's
// weights once through the TMA ring; bf16 runs on mma.sync with C <= 8 as
// one n = 8 tile (lanes past C zero) and larger C as up to 8 tiles that
// share each weight sub-tile (64 rows a launch, larger C in row chunks of
// 64); f32 runs the body's scalar FMAs in row chunks of 8.  The plan
// (kernels/gemv_plan.py::plan_grouped_stream) picks the column block so the
// E x n_m grid fills whole waves of the card's SMs.
//
// ragged_gemv runs the same body with a grid of expert slots: the host
// knows T but not the counts, so it launches min(E, T) slots x the column
// blocks x `deg` K parts.  Each CTA reads the offsets on the device (each
// clamped to [0, T], as the plain version reads them) and a scan of the
// counts gives slot j the j-th expert that has rows; a slot with none
// exits before it asks for a copy (every rank of its cluster decides the
// same way), so at batch 1 (top-6) 6 slots are launched, not 64.  The
// stack is a 4-D map {M, k_part, deg, E} and x one of {k_part, deg, T}, so
// the copy engine zero-fills past the K part, past M and past T; the CTA
// passes its expert, K part and rows as run-time coordinates.  When few
// experts have rows the K walk splits over a cluster of deg = 2, 4 or 8
// CTAs whose f32 partials are summed in rank order through distributed
// shared memory (gemv_stream.cuh's split-K epilogue).  bf16 runs mma.sync
// on as many n8 tiles as the expert has rows (1, 2 or 4, decided in the
// CTA: one row pays for one tile), up to 32 rows a walk and row chunks
// beyond (32, not the grouped kernel's 64: the kernel then holds 64
// registers a thread, so 4 CTAs an SM); f32 walks row chunks of 8.  Rows of the x box past the expert's
// end are computed and never stored.  A row's sums follow from the plan
// alone, whatever slot, tiles or neighbours its expert got.  Slot 0's
// rank-0 CTAs write the rows no expert holds as zeros ([offsets[E], T)
// for monotone offsets), whether or not they found an expert.  Where the
// offsets are not monotone, ranges may overlap: a row is stored by the
// last expert that holds it, as in the plain version.  The plan
// (gemv_plan.py::plan_ragged_stream) picks deg and the column block from
// min(E, T), the column blocks and the SM count.
//
// Both accumulate in f32 and round once to the output type; sums run in a
// fixed order with no atomics, so a result does not change from run to run
// (grouped_gemv's at every ring depth).
//
// Plain C interface, loaded with ctypes.  Each entry returns the (first
// failing) launch's CUDA error, 0 when every launch was taken.
#include <algorithm>

#include "gemv_stream.cuh"

namespace {

using gemv_stream::bf16;
using gemv_stream::kThreads;
using gemv_stream::kWarps;

constexpr int kRaggedTiles = 4;   // n8 tiles of one bf16 walk: 32 rows

// offsets[i] clamped to [0, R]
__device__ __forceinline__ int row_at(const int* off, int i, int R) {
  return min(max(off[i], 0), R);
}

// The last expert whose rows [off[e], max(off[e + 1], off[e])) hold row r
// (the plain version's last writer), -1 if none.
__device__ int owner(const int* off, int E, int R, int r) {
  for (int e = E - 1; e >= 0; --e) {
    const int lo = row_at(off, e, R);
    if (r >= lo && r < max(row_at(off, e + 1, R), lo)) return e;
  }
  return -1;
}

// Grid (ceil(M / MBLK), min(E, R) * deg), clusters of deg along y: slot
// blockIdx.y / deg, K part blockIdx.y % deg.  x [R, K] rows; a walk holds
// up to MAX_NT * 8 rows (bf16) or kMaxB (f32), its box rows a multiple of
// xbox; the ring is sized for b_max box rows.
template <typename T, int MBLK, int MAX_NT, bool CLUSTER>
__global__ void __launch_bounds__(kThreads,
                                  MAX_NT > 4 ? 2
                                             : gemv_stream::kMinCtasPerSm)
ragged_kernel(const __grid_constant__ CUtensorMap tw,
              const __grid_constant__ CUtensorMap tx,
              const int* __restrict__ offsets, T* __restrict__ out, int R,
              int E, int M, int k_part, int ks, int stages, int xbox,
              int b_max, int deg) {
  constexpr int kRows = std::is_same<T, bf16>::value ? MAX_NT * 8
                                                     : gemv_stream::kMaxB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_warp[kWarps];
  __shared__ int s_pick;
  __shared__ unsigned char s_keep[kRows];
  unsigned char* smem = gemv_stream::aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      smem + gemv_stream::body_bytes(b_max, MBLK, ks, stages, sizeof(T),
                                     CLUSTER ? 2 : 1));
  gemv_stream::init_bars(bars, stages);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int slot = blockIdx.y / deg, rank = blockIdx.y % deg;
  const int col0 = blockIdx.x * MBLK;

  // the slot's expert: the slot-th with rows, by a scan of the counts
  if (tid == 0) s_pick = -1;
  bool mono = true;
  for (int e0 = 0, base = 0; e0 < E; e0 += kThreads) {
    const int e = e0 + tid;
    bool has = false;
    if (e < E) {
      const int lo = row_at(offsets, e, R), nx = row_at(offsets, e + 1, R);
      has = nx > lo;
      mono = mono && nx >= lo;
    }
    const unsigned m = __ballot_sync(0xffffffffu, has);
    __syncthreads();   // the last pass has read s_warp
    if (lane == 0) s_warp[warp] = __popc(m);
    __syncthreads();
    int before = base + __popc(m & ((1u << lane) - 1u));
    for (int q = 0; q < kWarps; ++q) {
      if (q < warp) before += s_warp[q];
      base += s_warp[q];
    }
    if (has && before == slot) s_pick = e;
  }
  mono = __syncthreads_and(mono);   // and s_pick is published
  const int e = s_pick;

  // rows no expert holds come back zero: monotone offsets hold exactly
  // [offsets[0], offsets[E])
  if (slot == 0 && rank == 0) {
    const int c0 = row_at(offsets, 0, R), cE = row_at(offsets, E, R);
    const int n_free = mono ? c0 + R - cE : R;
    for (int i = tid; i < n_free * MBLK; i += kThreads) {
      const int k = i / MBLK, c = col0 + i % MBLK;
      const int r = !mono || k < c0 ? k : cE + k - c0;
      if (c < M && (mono || owner(offsets, E, R, r) < 0))
        gemv_stream::store(0.f, out + static_cast<size_t>(r) * M + c);
    }
  }
  if (e < 0) return;   // the same for every rank of the cluster

  const int lo = row_at(offsets, e, R);
  const int hi = max(row_at(offsets, e + 1, R), lo);
  const int n_sub = (k_part + ks - 1) / ks;
  const CUtensorMap& ts = tw;   // no scales: an operand the walk ignores
  int seq = 0;
  for (int r0 = lo; r0 < hi; r0 += kRows, seq += n_sub) {
    const int n = min(kRows, hi - r0);
    const unsigned char* keep = nullptr;
    if (!mono) {   // overlapping ranges: store the rows this expert owns
      __syncthreads();   // the last walk's epilogue has read s_keep
      if (tid < n) s_keep[tid] = owner(offsets, E, R, r0 + tid) == e;
      keep = s_keep;
    }
    const gemv_stream::Walk a{(n + xbox - 1) / xbox * xbox, xbox, n, keep,
                              M, k_part, ks, stages, seq, 0, col0, rank, e,
                              rank, r0, 1, M};
    T* o = out + static_cast<size_t>(r0) * M;
    if constexpr (MAX_NT >= 4) {
      if (a.B > 16) {
        gemv_stream::walk<T, MBLK, 4, CLUSTER, 0, true>(tw, tx, ts, smem,
                                                        bars, o, a);
        continue;
      }
      if (a.B > 8) {
        gemv_stream::walk<T, MBLK, 2, CLUSTER, 0, true>(tw, tx, ts, smem,
                                                        bars, o, a);
        continue;
      }
    }
    gemv_stream::walk<T, MBLK, 1, CLUSTER, 0, true>(tw, tx, ts, smem, bars,
                                                    o, a);
  }
}

template <typename T, int MBLK, int MAX_NT>
int launch_ragged(bool cluster, const CUtensorMap& tw, const CUtensorMap& tx,
                  const int* offsets, T* out, int R, int E, int M, int kp,
                  int ks, int stages, int xbox, int b_max, int deg,
                  cudaStream_t stream) {
  const int n_m = (M + MBLK - 1) / MBLK;
  const int y = std::min(E, R) * deg;
  const size_t smem = gemv_stream::smem_bytes(b_max, MBLK, ks, stages,
                                              sizeof(T), deg);
  return cluster
             ? gemv_stream::launch_ex<ragged_kernel<T, MBLK, MAX_NT, true>>(
                   n_m, y, smem, deg, stream, tw, tx, offsets, out, R, E, M,
                   kp, ks, stages, xbox, b_max, deg)
             : gemv_stream::launch_ex<ragged_kernel<T, MBLK, MAX_NT, false>>(
                   n_m, y, smem, 1, stream, tw, tx, offsets, out, R, E, M,
                   kp, ks, stages, xbox, b_max, deg);
}

// x [R, K] contiguous, w [E, K, M] rows ld apart and experts es apart, out
// [R, M]; deg K parts of K / deg rows, sub-tiles of ks rows.
template <typename T>
int run_ragged(const void* x, const void* offsets, const void* w, void* out,
               int R, int K, int M, int ld, long long es, int E, int deg,
               int m_blk, int ks, int stages, cudaStream_t stream) {
  constexpr bool kMma = std::is_same<T, bf16>::value;
  constexpr int kRows = kMma ? kRaggedTiles * 8 : gemv_stream::kMaxB;
  if (R < 1 || E < 1 || deg < 1 || K % deg
      || static_cast<long long>(std::min(E, R)) * deg > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int kp = K / deg;
  const int xbox = std::min(R, gemv_stream::kMaxB);
  const int b_max = (std::min(R, kRows) + xbox - 1) / xbox * xbox;
  gemv_stream::Problem p{x, w, out, R, M, kp, deg,
                         ld, static_cast<long long>(kp) * ld,
                         K, kp, M, 0};
  p.experts = E;
  p.w_es = es;
  if (!gemv_stream::launchable(p, xbox, m_blk, ks, stages, sizeof(T),
                               deg > 1)
      || gemv_stream::smem_bytes(b_max, m_blk, ks, stages, sizeof(T), deg)
             > static_cast<size_t>(gemv_stream::kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tw, tx, ts;
  int x_part_dim = 1;   // kp <= K: the map is {kp, deg, R}
  if (!gemv_stream::encode_maps<T, 0>(&tw, &tx, &ts, &x_part_dim, p, xbox,
                                      m_blk, ks))
    return static_cast<int>(cudaErrorInvalidValue);
  const int* off = static_cast<const int*>(offsets);
  T* o = static_cast<T*>(out);
  const bool cl = deg > 1;
  constexpr int kTiles = kMma ? kRaggedTiles : 1;
  if (kMma && b_max > 8)
    return m_blk == 64
               ? launch_ragged<T, 64, kTiles>(cl, tw, tx, off, o, R, E, M,
                                              kp, ks, stages, xbox, b_max,
                                              deg, stream)
               : launch_ragged<T, 128, kTiles>(cl, tw, tx, off, o, R, E, M,
                                               kp, ks, stages, xbox, b_max,
                                               deg, stream);
  return m_blk == 64
             ? launch_ragged<T, 64, 1>(cl, tw, tx, off, o, R, E, M, kp, ks,
                                       stages, xbox, b_max, deg, stream)
             : launch_ragged<T, 128, 1>(cl, tw, tx, off, o, R, E, M, kp, ks,
                                        stages, xbox, b_max, deg, stream);
}

template <typename T>
int run_grouped(const void* xs, const void* w, void* out, int E, int C,
                int K, int M, int ld, long long es, long long x_es,
                long long x_rs, int m_blk, int k_blk, int stages,
                cudaStream_t stream) {
  const gemv_stream::Problem p{xs, w, out, C, M, K, E, ld, es,
                               x_rs, x_es, M,
                               static_cast<long long>(C) * M};
  return gemv_stream::run<T, false, gemv_stream::kMaxTiles>(p, m_blk, k_blk,
                                                            stages, stream);
}

}  // namespace

// (xs, w, out, E, C, K, M, ld, es, x_es, x_rs, m_blk, k_blk, stages,
// stream); ld is the row stride and es the expert stride of w, x_es and
// x_rs the expert and row strides of xs, all in elements; out is a
// contiguous [E, C, M].
extern "C" int grouped_gemv_bf16(const void* xs, const void* w, void* out,
                                 int E, int C, int K, int M, int ld,
                                 long long es, long long x_es,
                                 long long x_rs, int m_blk, int k_blk,
                                 int stages, void* stream) {
  return run_grouped<bf16>(xs, w, out, E, C, K, M, ld, es, x_es, x_rs,
                           m_blk, k_blk, stages,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int grouped_gemv_f32(const void* xs, const void* w, void* out,
                                int E, int C, int K, int M, int ld,
                                long long es, long long x_es, long long x_rs,
                                int m_blk, int k_blk, int stages,
                                void* stream) {
  return run_grouped<float>(xs, w, out, E, C, K, M, ld, es, x_es, x_rs,
                            m_blk, k_blk, stages,
                            static_cast<cudaStream_t>(stream));
}

// (x, offsets, w, out, T, K, M, ld, es, E, deg, m_blk, k_blk, stages,
// stream); offsets is int32 [E + 1] on the device, deg the K parts of a
// cluster (1: none).
extern "C" int ragged_gemv_bf16(const void* x, const void* offsets,
                                const void* w, void* out, int rows, int K,
                                int M, int ld, long long es, int E, int deg,
                                int m_blk, int k_blk, int stages,
                                void* stream) {
  return run_ragged<bf16>(x, offsets, w, out, rows, K, M, ld, es, E, deg,
                          m_blk, k_blk, stages,
                          static_cast<cudaStream_t>(stream));
}

extern "C" int ragged_gemv_f32(const void* x, const void* offsets,
                               const void* w, void* out, int rows, int K,
                               int M, int ld, long long es, int E, int deg,
                               int m_blk, int k_blk, int stages,
                               void* stream) {
  return run_ragged<float>(x, offsets, w, out, rows, K, M, ld, es, E, deg,
                           m_blk, k_blk, stages,
                           static_cast<cudaStream_t>(stream));
}
