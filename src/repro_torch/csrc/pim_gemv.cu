// Output-stationary decode GEMV for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/pim_gemv.py::pim_gemv
// (body _gemv_kernel): out[B, M] = x[B, K] @ w_t[K, M] with an f32
// accumulator resident over the whole K walk.
//
// Bound on this card: at B <= 8 the GEMV does 2*B flops per weight element,
// far below the ~295 flops/byte where an H100 stops being memory bound, so
// the floor is the weight bytes over HBM bandwidth (3.35 TB/s).  The body
// (gemv_stream.cuh) streams each weight byte once through a ring of TMA
// copies in shared memory, runs bf16 on the tensor cores
// (mma.sync.m16n8k16, f32 accumulate) and f32 on scalar FMAs, and writes
// the output once.  One CTA walks the whole K of one column block; the
// planner (kernels/gemv_plan.py) picks the column block so the grid is
// resident in one wave (or whole waves) on the card's SMs.
//
// Plain C interface, loaded with ctypes.  Each entry returns the launch's
// CUDA error (0 when it was taken).
#include "gemv_stream.cuh"

// (x, w_t, out, B, K, M, ld, m_blk, k_blk, stages, stream); ld is w_t's row
// stride in elements, k_blk the rows of one ring slot, stages the ring
// depth.
extern "C" int pim_gemv_bf16(const void* x, const void* w_t, void* out, int B,
                             int K, int M, int ld, int m_blk, int k_blk,
                             int stages, void* stream) {
  return gemv_stream::run_dense<__nv_bfloat16, false>(
      x, w_t, out, B, K, M, ld, 1, m_blk, k_blk, stages, stream);
}

extern "C" int pim_gemv_f32(const void* x, const void* w_t, void* out, int B,
                            int K, int M, int ld, int m_blk, int k_blk,
                            int stages, void* stream) {
  return gemv_stream::run_dense<float, false>(x, w_t, out, B, K, M, ld, 1,
                                              m_blk, k_blk, stages, stream);
}

// Dynamic shared memory one launch of either streaming kernel takes, in
// bytes (the planner's smem_bytes must equal it).
extern "C" long long gemv_stream_smem_bytes(int B, int m_blk, int k_blk,
                                            int stages, int elem_bytes,
                                            int split_k) {
  return static_cast<long long>(gemv_stream::smem_bytes(
      B, m_blk, k_blk, stages, elem_bytes, split_k));
}
