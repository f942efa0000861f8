// Split-K decode GEMV for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/splitk_gemv.py::splitk_gemv
// (body _splitk_kernel): K is split into `deg` parts, each part writes f32
// partials [deg, B, M], and the partials are summed afterwards.
//
// Bound on this card: like pim_gemv, the weight bytes over HBM bandwidth.
// A narrow matrix (small M) has too few column blocks to put a CTA on every
// one of the 132 SMs, so the K walk is split into `deg` independent parts
// (blockIdx.y) that multiply the CTA count by `deg`.  The price is the f32
// partials, written once and read once by the reduce: 2 * deg * B * M * 4
// bytes, small next to the weights at decode widths.  The reduce is a second
// kernel that sums the parts in a fixed order (part 0, 1, ...), with no
// atomics, then casts to x's type.
//
// Plain C interface, loaded with ctypes.  Each entry returns
// cudaGetLastError() after its launches.
#include "gemv_tile.cuh"

namespace {

template <typename OutT>
__global__ void splitk_reduce_kernel(const float* __restrict__ partials,
                                     OutT* __restrict__ out, int deg, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int p = 0; p < deg; ++p) s += partials[static_cast<size_t>(p) * n + i];
  gemv::store(s, out + i);
}

template <typename T>
int splitk(const void* x, const void* w_t, void* partials, void* out, int B,
           int K, int M, int ld, int deg, int m_blk, int k_blk,
           cudaStream_t stream) {
  int rc = gemv::launch_tile<T, float>(x, w_t, partials, B, K, M, ld, deg,
                                       m_blk, k_blk, stream);
  if (rc != 0) return rc;
  const int n = B * M;
  const int threads = 256;
  splitk_reduce_kernel<T><<<(n + threads - 1) / threads, threads, 0, stream>>>(
      static_cast<const float*>(partials), static_cast<T*>(out), deg, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (x, w_t, partials, out, B, K, M, ld, deg, m_blk, k_blk, stream); ld is
// w_t's row stride in elements.
extern "C" int splitk_gemv_bf16(const void* x, const void* w_t, void* partials,
                                void* out, int B, int K, int M, int ld,
                                int deg, int m_blk, int k_blk, void* stream) {
  return splitk<__nv_bfloat16>(x, w_t, partials, out, B, K, M, ld, deg, m_blk,
                               k_blk, static_cast<cudaStream_t>(stream));
}

extern "C" int splitk_gemv_f32(const void* x, const void* w_t, void* partials,
                               void* out, int B, int K, int M, int ld, int deg,
                               int m_blk, int k_blk, void* stream) {
  return splitk<float>(x, w_t, partials, out, B, K, M, ld, deg, m_blk, k_blk,
                       static_cast<cudaStream_t>(stream));
}
