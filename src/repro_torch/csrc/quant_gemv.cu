// Block-scaled int8 / packed-int4 decode GEMV for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels src/repro/kernels/quant_gemv.py::quant_gemv
// (body _quant_kernel) and ::quant4_gemv (body _quant4_kernel):
//
//   out[B, M] = x[B, K] @ (q[K, M] * s[K / block, M])      (f32 contraction)
//
// q holds int8 codes [K, M], or packed int4 codes [K / 2, M] (packed row i:
// K row 2i in the low nibble, K row 2i + 1 in the high nibble, both
// sign-extended); s holds one f32 scale per (K block, column).  Each weight
// element is dequantized as q * s in f32 and then multiplied with x, as the
// TPU kernels do; out is written in x's type.  The rows of q lie ldw bytes
// apart and those of s lds floats apart (ldw >= M, ldw a multiple of 16,
// lds of 4), so a column slice of a wider prepacked weight runs without a
// copy.
//
// Bound on this card: every code byte, the scales (a quarter of the int8
// code bytes at block 32), x and out each cross HBM once, at 3.35 TB/s.
// At B = 8 int4 a byte feeds 32 f32 FMAs, so these simple scalar kernels
// may become limited by FMA issue before bytes.
//
// Design.  One CTA owns one column block of m_blk columns.  Its threads
// split into tcols = m_blk / 16 column lanes, each owning 16 neighbouring
// columns (one 16-byte code vector per stored row: 16 int8 columns, or 16
// int4 columns x 2 K rows), and groups = 256 / tcols row groups.  x is
// staged chunk by chunk in shared memory as f32 [k_blk, XB] (XB = B rounded
// up to a power of two, padded with zeros).  Inside a chunk a row group
// walks whole slabs: runs of consecutive stored rows inside ONE scale block,
// so a thread loads its 16 columns' scales once per slab, not once per row.
// The slab is the scale block, halved while the chunk has fewer slabs than
// row groups.  The f32 accumulators for all XB rows stay in registers over
// the whole K walk; at the end the row groups are summed through shared
// memory in a fixed order, so the result is deterministic.
//
// Plain C interface, loaded with ctypes.  Each entry returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a shape the
// kernel does not take).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads per CTA
constexpr int kVec = 16;       // code bytes per thread per stored row
constexpr int kUnroll = 4;     // stored rows in flight per thread
constexpr int kMaxB = 8;       // x rows one launch holds

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float v, float* o) { *o = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* o) {
  *o = __float2bfloat16_rn(v);
}

// Signed nibbles of one packed byte: the cast back to int8_t before the
// arithmetic right shift is what sign-extends the low nibble.
__device__ __forceinline__ int low_nibble(int8_t b) {
  return static_cast<int>(static_cast<int8_t>(static_cast<uint8_t>(b) << 4))
         >> 4;
}
__device__ __forceinline__ int high_nibble(int8_t b) {
  return static_cast<int>(b) >> 4;
}

// Shared memory in floats: the x chunk [k_blk, xb], reused after the K walk
// by the row-group tile [256 * 16], then the second reduce level [256].
__host__ __device__ inline int red2_offset(int xb, int k_blk) {
  const int xs = k_blk * xb;
  return xs > kThreads * kVec ? xs : kThreads * kVec;
}
inline size_t smem_bytes(int xb, int k_blk) {
  return sizeof(float) * (static_cast<size_t>(red2_offset(xb, k_blk))
                          + kThreads);
}

template <typename T, int XB, bool kInt4>
__global__ void __launch_bounds__(kThreads)
quant_gemv_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ scales, T* __restrict__ out,
                  int B, int K, int M, int ldw, int lds, int block, int m_blk,
                  int k_blk) {
  constexpr int kRows = kInt4 ? 2 : 1;  // K rows per stored row
  extern __shared__ float smem[];
  float* xs = smem;  // [k_blk, XB]; the reduce tile after the K walk

  const int tcols = m_blk / kVec;
  const int groups = kThreads / tcols;
  const int tid = threadIdx.x;
  const int g = tid / tcols;
  const int c = tid % tcols;
  const int col0 = blockIdx.x * m_blk + c * kVec;

  const int chunk_rows = k_blk / kRows;  // stored rows per x chunk
  int slab = block / kRows;              // stored rows per scale block
  while (slab % 2 == 0 && chunk_rows / slab < groups) slab /= 2;
  const int n_slabs = chunk_rows / slab;

  float acc[XB][kVec];
#pragma unroll
  for (int b = 0; b < XB; ++b)
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[b][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += k_blk) {
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < XB * k_blk; i += kThreads) {
      const int b = i / k_blk;
      const int kk = i - b * k_blk;
      xs[kk * XB + b] =
          b < B ? to_f32(x[static_cast<size_t>(b) * K + k0 + kk]) : 0.f;
    }
    __syncthreads();
    const int row0 = k0 / kRows;  // first stored row of the chunk
    for (int sl = g; sl < n_slabs; sl += groups) {
      const int r0 = sl * slab;  // first stored row of the slab, in chunk
      const int sb = (k0 + r0 * kRows) / block;
      float s[kVec];
      const float4* sp = reinterpret_cast<const float4*>(
          scales + static_cast<size_t>(sb) * lds + col0);
#pragma unroll
      for (int q = 0; q < kVec / 4; ++q) {
        const float4 v = sp[q];
        s[4 * q] = v.x;
        s[4 * q + 1] = v.y;
        s[4 * q + 2] = v.z;
        s[4 * q + 3] = v.w;
      }
      for (int r = 0; r < slab; r += kUnroll) {
        uint4 raw[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (r + u < slab)
            raw[u] = *reinterpret_cast<const uint4*>(
                w + static_cast<size_t>(row0 + r0 + r + u) * ldw + col0);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (r + u >= slab) break;
          const int8_t* q = reinterpret_cast<const int8_t*>(&raw[u]);
          const float* x0 = xs + (r0 + r + u) * kRows * XB;
          float xv0[XB];
#pragma unroll
          for (int b = 0; b < XB; ++b) xv0[b] = x0[b];
          if constexpr (kInt4) {
            float xv1[XB];
#pragma unroll
            for (int b = 0; b < XB; ++b) xv1[b] = x0[XB + b];
#pragma unroll
            for (int j = 0; j < kVec; ++j) {
              const float w0 = static_cast<float>(low_nibble(q[j])) * s[j];
              const float w1 = static_cast<float>(high_nibble(q[j])) * s[j];
#pragma unroll
              for (int b = 0; b < XB; ++b) {
                acc[b][j] = fmaf(xv0[b], w0, acc[b][j]);
                acc[b][j] = fmaf(xv1[b], w1, acc[b][j]);
              }
            }
          } else {
#pragma unroll
            for (int j = 0; j < kVec; ++j) {
              const float w0 = static_cast<float>(q[j]) * s[j];
#pragma unroll
              for (int b = 0; b < XB; ++b)
                acc[b][j] = fmaf(xv0[b], w0, acc[b][j]);
            }
          }
        }
      }
    }
  }

  // Sum the row groups, one x row at a time, in a fixed order: level 1,
  // each of the parts = 256 / m_blk threads of a column sums every
  // parts-th group; level 2, one thread per column sums the parts.
  float* red = smem;                            // [groups, m_blk]: 256 * 16
  float* red2 = smem + red2_offset(XB, k_blk);  // [parts, m_blk]: 256
  const int parts = kThreads / m_blk;
  const int col = tid % m_blk;
  const int part = tid / m_blk;
  T* o = out + static_cast<size_t>(blockIdx.x) * m_blk;
#pragma unroll
  for (int b = 0; b < XB; ++b) {
    if (b < B) {  // B is uniform over the CTA: every thread takes this path
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kVec; ++j) red[g * m_blk + c * kVec + j] = acc[b][j];
      __syncthreads();
      float sum = 0.f;
      for (int gg = part; gg < groups; gg += parts)
        sum += red[gg * m_blk + col];
      red2[part * m_blk + col] = sum;
      __syncthreads();
      if (tid < m_blk) {
        float t = 0.f;
        for (int p = 0; p < parts; ++p) t += red2[p * m_blk + tid];
        store(t, o + static_cast<size_t>(b) * M + tid);
      }
    }
  }
}

template <typename T, bool kInt4>
int launch(const void* x, const void* w, const void* scales, void* out, int B,
           int K, int M, int ldw, int lds, int block, int m_blk, int k_blk,
           cudaStream_t stream) {
  const int rows = kInt4 ? 2 : 1;
  if (B < 1 || B > kMaxB || block <= 0 || K % block || block % rows ||
      ldw < M || ldw % kVec || lds < M || lds % 4 ||
      m_blk < kVec || m_blk % kVec || kThreads % m_blk ||
      M % m_blk || k_blk <= 0 || K % k_blk || k_blk % block)
    return static_cast<int>(cudaErrorInvalidValue);
  const int xb = B == 1 ? 1 : B == 2 ? 2 : B <= 4 ? 4 : 8;
  const dim3 grid(M / m_blk);
  const size_t smem = smem_bytes(xb, k_blk);
  const T* xp = static_cast<const T*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sp = static_cast<const float*>(scales);
  T* op = static_cast<T*>(out);
  switch (xb) {
    case 1:
      quant_gemv_kernel<T, 1, kInt4><<<grid, kThreads, smem, stream>>>(
          xp, wp, sp, op, B, K, M, ldw, lds, block, m_blk, k_blk);
      break;
    case 2:
      quant_gemv_kernel<T, 2, kInt4><<<grid, kThreads, smem, stream>>>(
          xp, wp, sp, op, B, K, M, ldw, lds, block, m_blk, k_blk);
      break;
    case 4:
      quant_gemv_kernel<T, 4, kInt4><<<grid, kThreads, smem, stream>>>(
          xp, wp, sp, op, B, K, M, ldw, lds, block, m_blk, k_blk);
      break;
    default:
      quant_gemv_kernel<T, 8, kInt4><<<grid, kThreads, smem, stream>>>(
          xp, wp, sp, op, B, K, M, ldw, lds, block, m_blk, k_blk);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (x, codes, scales, out, B, K, M, ldw, lds, block, m_blk, k_blk, stream):
// K is the logical K (twice the packed rows for int4); ldw and lds are the
// row strides of the codes and the scales, in elements.
extern "C" int quant_gemv_bf16(const void* x, const void* w_q,
                               const void* scales, void* out, int B, int K,
                               int M, int ldw, int lds, int block, int m_blk,
                               int k_blk, void* stream) {
  return launch<__nv_bfloat16, false>(x, w_q, scales, out, B, K, M, ldw, lds,
                                      block, m_blk, k_blk,
                                      static_cast<cudaStream_t>(stream));
}

extern "C" int quant_gemv_f32(const void* x, const void* w_q,
                              const void* scales, void* out, int B, int K,
                              int M, int ldw, int lds, int block, int m_blk,
                              int k_blk, void* stream) {
  return launch<float, false>(x, w_q, scales, out, B, K, M, ldw, lds,
                              block, m_blk, k_blk,
                              static_cast<cudaStream_t>(stream));
}

extern "C" int quant4_gemv_bf16(const void* x, const void* w_q,
                                const void* scales, void* out, int B, int K,
                                int M, int ldw, int lds, int block, int m_blk,
                                int k_blk, void* stream) {
  return launch<__nv_bfloat16, true>(x, w_q, scales, out, B, K, M, ldw, lds,
                                     block, m_blk, k_blk,
                                     static_cast<cudaStream_t>(stream));
}

extern "C" int quant4_gemv_f32(const void* x, const void* w_q,
                               const void* scales, void* out, int B, int K,
                               int M, int ldw, int lds, int block, int m_blk,
                               int k_blk, void* stream) {
  return launch<float, true>(x, w_q, scales, out, B, K, M, ldw, lds,
                             block, m_blk, k_blk,
                             static_cast<cudaStream_t>(stream));
}
