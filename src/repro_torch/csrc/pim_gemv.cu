// Output-stationary decode GEMV for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/pim_gemv.py::pim_gemv
// (body _gemv_kernel): out[B, M] = x[B, K] @ w_t[K, M] with an f32
// accumulator resident over the whole K walk.
//
// Bound on this card: at B <= 8 the GEMV does 2*B flops per weight element,
// far below the ~295 flops/byte where an H100 stops being memory bound, so
// the floor is the weight bytes over HBM bandwidth (3.35 TB/s).  The design
// therefore reads every weight byte exactly once, as 16-byte coalesced
// vectors along the contiguous M axis, keeps x in shared memory and the
// accumulators in registers, and writes the output once (gemv_tile.cuh).
// The planner (kernels/gemv_plan.py) picks the column block so the grid
// has enough CTAs; when it cannot, the dispatcher prefers splitk_gemv.
//
// Plain C interface, loaded with ctypes.  Each entry returns
// cudaGetLastError() after the launch.
#include "gemv_tile.cuh"

// (x, w_t, out, B, K, M, ld, m_blk, k_blk, stream); ld is w_t's row stride
// in elements.
extern "C" int pim_gemv_bf16(const void* x, const void* w_t, void* out, int B,
                             int K, int M, int ld, int m_blk, int k_blk,
                             void* stream) {
  return gemv::launch_tile<__nv_bfloat16, __nv_bfloat16>(
      x, w_t, out, B, K, M, ld, 1, m_blk, k_blk,
      static_cast<cudaStream_t>(stream));
}

extern "C" int pim_gemv_f32(const void* x, const void* w_t, void* out, int B,
                            int K, int M, int ld, int m_blk, int k_blk,
                            void* stream) {
  return gemv::launch_tile<float, float>(x, w_t, out, B, K, M, ld, 1, m_blk,
                                         k_blk,
                                         static_cast<cudaStream_t>(stream));
}
