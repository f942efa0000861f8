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
// ragged_gemv keeps the first design: one CTA per (expert, column block)
// cell running the output-stationary tile body of gemv_tile.cuh on the
// expert's [K, M] slice (no copy: the slice is w + e * es, rows ld apart)
// and the cell's rows of x.  The Pallas ragged kernel computes every
// expert cell over all T rows and masks the store; here a cell reads its
// row range from `offsets` on the device and walks only those rows, in
// chunks of kMaxB (the register accumulators), so any count distribution is
// right, up to all T rows on one expert.  A cell whose expert has no rows
// returns before it reads any weight: at batch 8 with top-6 of 64 experts
// about 35 experts have rows, so the kernel streams about 35/64 of the
// stack instead of all of it.  The last expert's cells also write the tail
// rows [offsets[E], T) as zeros.
//
// Both accumulate in f32 and round once to the output type; sums run in a
// fixed order with no atomics, so a result does not change from run to run
// (grouped_gemv's at every ring depth).
//
// Plain C interface, loaded with ctypes.  Each entry returns the (first
// failing) launch's CUDA error, 0 when every launch was taken.
#include "gemv_stream.cuh"
#include "gemv_tile.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(gemv::kThreads)
ragged_gemv_kernel(const T* __restrict__ x, const int* __restrict__ offsets,
                   const T* __restrict__ w, T* __restrict__ out, int rows,
                   int K, int M, int ld, long long es, int E, int m_blk,
                   int k_blk) {
  extern __shared__ float smem[];
  const int mb = blockIdx.x;
  const int e = blockIdx.y;
  // clamped to [0, rows]: a malformed offsets vector never reads or writes
  // outside the buffers
  const int start = min(max(offsets[e], 0), rows);
  const int end = min(max(offsets[e + 1], start), rows);
  const T* we = w + static_cast<size_t>(e) * es;
  T* ob = out + static_cast<size_t>(mb) * m_blk;
  // start and end are the same for every thread: the loop (and the early
  // exit of an expert with no rows) is uniform over the CTA
  for (int r0 = start; r0 < end; r0 += gemv::kMaxB) {
    const int B = min(gemv::kMaxB, end - r0);
    gemv::gemv_tile<T, T>(x + static_cast<size_t>(r0) * K, K, we, ld,
                          ob + static_cast<size_t>(r0) * M, M, B, 0, K, mb,
                          m_blk, k_blk, smem);
  }
  if (e == E - 1) {
    for (int i = threadIdx.x; i < (rows - end) * m_blk; i += gemv::kThreads)
      gemv::store(0.f, ob + static_cast<size_t>(end + i / m_blk) * M
                           + i % m_blk);
  }
}

template <typename T>
bool aligned(int ld, long long es) {
  return (ld * sizeof(T)) % 16 == 0 && (es * sizeof(T)) % 16 == 0;
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

template <typename T>
int launch_ragged(const void* x, const void* offsets, const void* w,
                  void* out, int rows, int K, int M, int ld, long long es,
                  int E, int m_blk, int k_blk, cudaStream_t stream) {
  if (ld < M || !aligned<T>(ld, es))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(M / m_blk, E);
  ragged_gemv_kernel<T><<<grid, gemv::kThreads,
                          gemv::smem_bytes<T>(gemv::kMaxB, k_blk), stream>>>(
      static_cast<const T*>(x), static_cast<const int*>(offsets),
      static_cast<const T*>(w), static_cast<T*>(out), rows, K, M, ld, es, E,
      m_blk, k_blk);
  return static_cast<int>(cudaGetLastError());
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
  return run_grouped<__nv_bfloat16>(xs, w, out, E, C, K, M, ld, es, x_es,
                                    x_rs, m_blk, k_blk, stages,
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

// (x, offsets, w, out, T, K, M, ld, es, E, m_blk, k_blk, stream); offsets
// is int32 [E + 1] on the device.
extern "C" int ragged_gemv_bf16(const void* x, const void* offsets,
                                const void* w, void* out, int rows, int K,
                                int M, int ld, long long es, int E, int m_blk,
                                int k_blk, void* stream) {
  return launch_ragged<__nv_bfloat16>(x, offsets, w, out, rows, K, M, ld, es,
                                      E, m_blk, k_blk,
                                      static_cast<cudaStream_t>(stream));
}

extern "C" int ragged_gemv_f32(const void* x, const void* offsets,
                               const void* w, void* out, int rows, int K,
                               int M, int ld, long long es, int E, int m_blk,
                               int k_blk, void* stream) {
  return launch_ragged<float>(x, offsets, w, out, rows, K, M, ld, es, E,
                              m_blk, k_blk,
                              static_cast<cudaStream_t>(stream));
}
