// Split-K decode GEMV for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/splitk_gemv.py::splitk_gemv
// (body _splitk_kernel): K is split into `deg` parts, each part computes
// f32 partials [deg, B, M], and the partials are summed in a fixed order.
//
// Bound on this card: like pim_gemv, the weight bytes over HBM bandwidth.
// A narrow matrix (small M) has too few column blocks to fill the 132 SMs,
// so the K walk is split into `deg` parts (blockIdx.y) that multiply the
// CTA count by `deg`.  Each part streams its weights through the same ring
// and tensor-core body as pim_gemv (gemv_stream.cuh).  The partials never
// reach HBM: the deg CTAs of one column block form one thread block
// cluster, each keeps its f32 partial [B, m_blk] in shared memory, and
// rank r sums its slice of the columns over ranks 0, 1, ..., deg - 1 in
// that order through distributed shared memory, then casts to x's type.
// One launch, no atomics, no second kernel.
//
// Plain C interface, loaded with ctypes.  Each entry returns the launch's
// CUDA error (0 when it was taken; a cluster the card refuses is an
// error, never a fallback).
#include "gemv_stream.cuh"

namespace {

bool cluster_degree(int deg) { return deg == 2 || deg == 4 || deg == 8; }

}  // namespace

// (x, w_t, out, B, K, M, ld, deg, m_blk, k_blk, stages, stream); ld is w_t's
// row stride in elements, deg the split degree (2, 4 or 8: the portable
// cluster sizes), k_blk the rows of one ring slot, stages the ring depth.
extern "C" int splitk_gemv_bf16(const void* x, const void* w_t, void* out,
                                int B, int K, int M, int ld, int deg,
                                int m_blk, int k_blk, int stages,
                                void* stream) {
  if (!cluster_degree(deg)) return static_cast<int>(cudaErrorInvalidValue);
  return gemv_stream::run<__nv_bfloat16, true>(
      x, w_t, out, B, K, M, ld, deg, m_blk, k_blk, stages, stream);
}

extern "C" int splitk_gemv_f32(const void* x, const void* w_t, void* out,
                               int B, int K, int M, int ld, int deg,
                               int m_blk, int k_blk, int stages,
                               void* stream) {
  if (!cluster_degree(deg)) return static_cast<int>(cudaErrorInvalidValue);
  return gemv_stream::run<float, true>(x, w_t, out, B, K, M, ld, deg, m_blk,
                                       k_blk, stages, stream);
}
