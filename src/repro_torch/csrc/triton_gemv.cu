// Column-block decode GEMV for Hopper (sm_90a): the gpu backend's kernel.
//
// Replaces the Pallas-Triton kernel src/repro/kernels/triton_gemv.py::
// triton_gemv (body _gemv_kernel): out[B, M] = x[B, K] @ w_t[K, M] with an
// f32 accumulator held over the whole K walk, one program per column block
// and the K walk a loop inside it.
//
// Bound on this card: at decode (B <= 8) each weight element feeds 2 * B
// flops, far below the ~295 flops/byte where an H100 stops being memory
// bound, so the floor is the weight bytes over HBM bandwidth (3.35 TB/s).
// The body is pim_gemv's (gemv_stream.cuh): a ring of TMA-filled 16 KB K
// sub-tiles in shared memory, bf16 on mma.sync.m16n8k16 with f32
// accumulation, f32 on scalar FMAs (no TF32).  One launch, no cluster.
//
// The plan is the JAX package's (plan_triton_gemv: a power-of-two column
// block of 64 to 512 dividing M, a power-of-two K chunk); the wrapper maps
// each of its column blocks onto m_blk / 128 CTAs of the body (64-column
// plans onto one 64-column CTA), walks K in the body's own sub-tiles, and
// takes the plan's ring depth.  Batches above 8 share each weight sub-tile
// among up to 8 n = 8 tiles of the mma (64 rows a launch); f32 runs row
// chunks of 8, one launch each.
//
// w_t's rows lie ld elements apart (ld >= M, ld * sizeof(T) a multiple of
// 16 bytes), so a column slice of a wider prepacked weight runs in place.
//
// Plain C interface, loaded with ctypes.  Each entry returns the first
// launch's CUDA error (0 when every launch was taken).
#include "gemv_stream.cuh"

namespace {

template <typename T>
int run_triton(const void* x, const void* w, void* out, int B, int K, int M,
               int ld, int m_blk, int ks, int stages, void* stream) {
  const gemv_stream::Problem p{x, w, out, B, M, K, 1, ld,
                               static_cast<long long>(K) * ld,
                               K, K, M, 0};
  return gemv_stream::run<T, false, gemv_stream::kMaxTiles>(p, m_blk, ks,
                                                            stages, stream);
}

}  // namespace

// (x, w_t, out, B, K, M, ld, m_blk, k_blk, stages, stream); ld is w_t's row
// stride in elements, m_blk the body's column block (64 or 128), k_blk the
// rows of one ring slot, stages the ring depth.
extern "C" int triton_gemv_bf16(const void* x, const void* w_t, void* out,
                                int B, int K, int M, int ld, int m_blk,
                                int k_blk, int stages, void* stream) {
  return run_triton<__nv_bfloat16>(x, w_t, out, B, K, M, ld, m_blk, k_blk,
                                   stages, stream);
}

extern "C" int triton_gemv_f32(const void* x, const void* w_t, void* out,
                               int B, int K, int M, int ld, int m_blk,
                               int k_blk, int stages, void* stream) {
  return run_triton<float>(x, w_t, out, B, K, M, ld, m_blk, k_blk, stages,
                           stream);
}
