// Output-stationary decode GEMV tile body of ragged_gemv (grouped_gemv.cu).
//
//   out[B, M] = x[B, K] @ w_t[K, M]      (w_t K-major, B <= kMaxB)
//
// w_t's rows lie ld elements apart (ld >= M, ld * sizeof(T) a multiple of 16
// bytes), so an expert's slice of a stack runs without a copy.
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
// The ragged kernel calls gemv_tile once per chunk of up to kMaxB rows of
// an (expert, column block) cell.  The dense and grouped kernels run the
// streaming body of gemv_stream.cuh instead.
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

// One CTA's tile: out rows [0, B) of column block `mb` over the K rows
// [k_begin, k_begin + k_part).  x rows lie ldx elements apart, w rows ld
// apart, out rows ldo apart; `o` points at the block's first output column
// of row 0.  Every thread of the CTA must call this with the same arguments
// (it synchronises the CTA).  smem holds smem_bytes<T>(kMaxB, k_blk).
template <typename T, typename OutT>
__device__ __forceinline__ void gemv_tile(
    const T* __restrict__ x, int ldx, const T* __restrict__ w, int ld,
    OutT* __restrict__ o, int ldo, int B, int k_begin, int k_part, int mb,
    int m_blk, int k_blk, float* smem) {
  constexpr int V = Vec<T>::n;
  float* xs = smem;                 // [B, k_blk]
  float* red = smem + B * k_blk;    // [groups, m_blk]

  const int tcols = m_blk / V;
  const int groups = kThreads / tcols;
  const int tid = threadIdx.x;
  const int g = tid / tcols;
  const int c = tid % tcols;
  const int col0 = mb * m_blk + c * V;

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
      xs[i] = to_f32(x[static_cast<size_t>(b) * ldx + k0 + kk]);
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
        store(s, o + static_cast<size_t>(b) * ldo + i);
      }
    }
  }
}

}  // namespace gemv
