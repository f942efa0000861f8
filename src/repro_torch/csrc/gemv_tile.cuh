// Output-stationary decode GEMV body shared by pim_gemv.cu and splitk_gemv.cu.
//
//   out[B, M] = x[B, K] @ w_t[K, M]      (w_t K-major, B <= kMaxB)
//
// w_t's rows lie ld elements apart (ld >= M, ld * sizeof(T) a multiple of 16
// bytes), so a column slice of a wider prepacked weight runs without a copy.
//
// One CTA owns one column block of m_blk columns.  Its threads split into
// `tcols = m_blk / V` column lanes, each owning V neighbouring columns (one
// 16-byte vector per K row), and `groups = kThreads / tcols` row groups that
// walk interleaved K rows, so every K row of the block is one coalesced
// stream of 16-byte loads.  x is staged chunk by chunk in shared memory as
// f32; the f32 accumulators for all B rows stay in registers for the whole
// K walk.  At the end the row groups are summed through shared memory in a
// fixed order (group 0, 1, ...), so the result is deterministic.
//
// blockIdx.y selects a K part of k_part rows: the output-stationary kernel
// runs with one part and writes `out` in x's type; the split-K kernel runs
// with `deg` parts and writes f32 partials [deg, B, M].
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gemv {

constexpr int kThreads = 256;  // threads per CTA
constexpr int kMaxB = 8;       // decode batch held in registers
constexpr int kUnroll = 4;     // K rows in flight per thread

template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int n = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int n = 8; };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float v, float* o) { *o = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* o) {
  *o = __float2bfloat16_rn(v);
}

// Dynamic shared memory a launch needs: the x chunk plus the reduce tile.
template <typename T>
inline size_t smem_bytes(int B, int k_blk) {
  return sizeof(float) * (static_cast<size_t>(B) * k_blk
                          + static_cast<size_t>(kThreads) * Vec<T>::n);
}

template <typename T, typename OutT>
__global__ void __launch_bounds__(kThreads)
gemv_tile_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 OutT* __restrict__ out, int B, int K, int M, int ld,
                 int k_part, int m_blk, int k_blk) {
  constexpr int V = Vec<T>::n;
  extern __shared__ float smem[];
  float* xs = smem;                 // [B, k_blk]
  float* red = smem + B * k_blk;    // [groups, m_blk]

  const int tcols = m_blk / V;
  const int groups = kThreads / tcols;
  const int tid = threadIdx.x;
  const int g = tid / tcols;
  const int c = tid % tcols;
  const int col0 = blockIdx.x * m_blk + c * V;
  const int k_begin = blockIdx.y * k_part;

  float acc[kMaxB][V];
#pragma unroll
  for (int b = 0; b < kMaxB; ++b)
#pragma unroll
    for (int j = 0; j < V; ++j) acc[b][j] = 0.f;

  for (int k0 = k_begin; k0 < k_begin + k_part; k0 += k_blk) {
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < B * k_blk; i += kThreads) {
      const int b = i / k_blk;
      const int kk = i - b * k_blk;
      xs[i] = to_f32(x[static_cast<size_t>(b) * K + k0 + kk]);
    }
    __syncthreads();
    for (int kk = g; kk < k_blk; kk += groups * kUnroll) {
      uint4 raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = kk + u * groups;
        if (r < k_blk)
          raw[u] = *reinterpret_cast<const uint4*>(
              w + static_cast<size_t>(k0 + r) * ld + col0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = kk + u * groups;
        if (r >= k_blk) break;
        const T* wv = reinterpret_cast<const T*>(&raw[u]);
        float wf[V];
#pragma unroll
        for (int j = 0; j < V; ++j) wf[j] = to_f32(wv[j]);
#pragma unroll
        for (int b = 0; b < kMaxB; ++b) {
          if (b < B) {
            const float xv = xs[b * k_blk + r];
#pragma unroll
            for (int j = 0; j < V; ++j) acc[b][j] = fmaf(xv, wf[j], acc[b][j]);
          }
        }
      }
    }
  }

  OutT* o = out + static_cast<size_t>(blockIdx.y) * B * M
            + static_cast<size_t>(blockIdx.x) * m_blk;
#pragma unroll
  for (int b = 0; b < kMaxB; ++b) {
    if (b < B) {  // B is uniform over the CTA: every thread takes this path
      __syncthreads();
#pragma unroll
      for (int j = 0; j < V; ++j) red[g * m_blk + c * V + j] = acc[b][j];
      __syncthreads();
      for (int i = tid; i < m_blk; i += kThreads) {
        float s = 0.f;
        for (int gg = 0; gg < groups; ++gg) s += red[gg * m_blk + i];
        store(s, o + static_cast<size_t>(b) * M + i);
      }
    }
  }
}

template <typename T, typename OutT>
inline int launch_tile(const void* x, const void* w, void* out, int B, int K,
                       int M, int ld, int parts, int m_blk, int k_blk,
                       cudaStream_t stream) {
  if (ld < M || (ld * sizeof(T)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(M / m_blk, parts);
  gemv_tile_kernel<T, OutT><<<grid, kThreads, smem_bytes<T>(B, k_blk),
                              stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<OutT*>(out), B, K, M, ld, K / parts, m_blk, k_blk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gemv
