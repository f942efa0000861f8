// Column-block decode GEMV on the tensor cores, for Hopper (sm_90a).
//
// Replaces the Pallas-Triton kernel src/repro/kernels/triton_gemv.py::
// triton_gemv (body _gemv_kernel): out[B, M] = x[B, K] @ w_t[K, M] with an
// f32 accumulator held over the whole K walk, one CTA per column block of
// m_blk outputs (the grid is exactly plan.n_m blocks, the occupancy the
// gpu backend's cost model prices) and the K walk a loop inside the CTA.
// The Pallas body is a matrix-unit dot on x zero-padded to 16 rows; here:
//
//   bf16: warp-level mma.sync.m16n8k16 (bf16 in, f32 accumulate) computing
//         out^T = w_t^T . x^T.  W is the A operand (16 output columns by 16
//         k), x the B operand (n = 8 batch rows: B <= 8 needs no padding of
//         x in memory, and a larger B runs in chunks of 8 rows, each
//         walking K again).  w_t is K-major (m contiguous), so each K
//         sub-tile is copied into shared memory as it lies and the A
//         fragments come out transposed with ldmatrix.x4.trans.  bf16 x
//         bf16 products are exact in f32, so only the order of the sums
//         differs from the plain version.
//   f32:  scalar f32 FMAs (the output-stationary body of gemv_tile.cuh,
//         one launch per call over the same n_m blocks).  Not TF32: that
//         would round x and W to 10-bit mantissas, which the reference's
//         f32 product does not.
//
// Bound on this card: at decode (B <= 8) each weight element feeds 2 * B
// flops, far below the ~295 flops/byte where an H100 stops being memory
// bound, so the floor is the weight bytes over HBM bandwidth (3.35 TB/s).
// The tensor cores take the multiply-adds off the issue slots that limit
// the scalar kernels at B = 8.  Simple first: one stage (copy a sub-tile,
// synchronise, compute), no TMA, no wgmma; the several CTAs an SM holds
// overlap one another's copies.
//
// The plan's k_blk is a Triton tile (up to 1024 rows); a k_blk x m_blk bf16
// tile can exceed shared memory, so the kernel walks K in sub-tiles of its
// own: ks = min(k_blk, 16384 / m_blk) rows, 32 KB of weights, padded by 16
// bytes a row so the eight rows an ldmatrix reads fall in distinct banks.
//
// w_t's rows lie ld elements apart (ld >= M, ld * sizeof(T) a multiple of
// 16 bytes), so a column slice of a wider prepacked weight runs in place.
//
// Plain C interface, loaded with ctypes.  Each entry returns
// cudaGetLastError() after the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemv_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 8;            // batch rows per mma (its n)
constexpr int kTileElems = 16384;   // weights per K sub-tile (32 KB bf16)
constexpr int kPad = 8;             // bf16 padding per shared-memory row

// Rows of a K sub-tile: the largest multiple of 16 that divides k_blk and
// keeps the sub-tile within kTileElems weights.
inline int sub_rows(int m_blk, int k_blk) {
  int ks = k_blk < kTileElems / m_blk ? k_blk : kTileElems / m_blk;
  while (k_blk % ks) ks -= 16;
  return ks;
}

inline size_t bf16_smem_bytes(int m_blk, int ks) {
  return sizeof(bf16) * (static_cast<size_t>(ks) * (m_blk + kPad)
                         + static_cast<size_t>(kRows) * (ks + kPad));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&a)[4],
                                                  const bf16* p) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_16816(float (&c)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One CTA: columns [blockIdx.x * m_blk, + m_blk), m_blk = 64 * TILES; each
// warp owns TILES m16 tiles of 16 neighbouring columns.
template <int TILES>
__global__ void __launch_bounds__(kThreads)
triton_gemv_bf16_kernel(const bf16* __restrict__ x,
                        const bf16* __restrict__ w, bf16* __restrict__ out,
                        int B, int K, int M, int ld, int ks) {
  constexpr int m_blk = 16 * TILES * kWarps;
  constexpr int wld = m_blk + kPad;       // shared row stride of W
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ws = reinterpret_cast<bf16*>(smem_raw);   // [ks][wld]
  bf16* xs = ws + static_cast<size_t>(ks) * wld;  // [kRows][ks + kPad]
  const int xld = ks + kPad;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;         // mma group: A row / B column / C row
  const int t = lane & 3;          // thread in group
  const int col0 = blockIdx.x * m_blk;
  const int wcol = warp * TILES * 16;           // warp's first column
  // ldmatrix.x4: lanes 8i..8i+7 give the rows of matrix i; matrices 0-3 are
  // (k 0-7, m 0-7), (k 0-7, m 8-15), (k 8-15, m 0-7), (k 8-15, m 8-15)
  const int lrow = (lane & 7) + ((lane >> 4) << 3);
  const int lcol = ((lane >> 3) & 1) << 3;
  const int wvecs = m_blk / 8;     // 16-byte vectors in a W row
  const int xvecs = ks / 8;        // ... in an x row

  for (int r0 = 0; r0 < B; r0 += kRows) {
    const int nb = min(kRows, B - r0);
    float acc[TILES][4];
#pragma unroll
    for (int j = 0; j < TILES; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;

    for (int k0 = 0; k0 < K; k0 += ks) {
      __syncthreads();  // the previous sub-tile's readers are done
#pragma unroll 4
      for (int i = tid; i < ks * wvecs; i += kThreads) {
        const int r = i / wvecs;
        const int c = (i - r * wvecs) * 8;
        *reinterpret_cast<uint4*>(ws + r * wld + c) =
            *reinterpret_cast<const uint4*>(
                w + static_cast<size_t>(k0 + r) * ld + col0 + c);
      }
      for (int i = tid; i < kRows * xvecs; i += kThreads) {
        const int n = i / xvecs;
        const int c = (i - n * xvecs) * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);   // rows past B are zero
        if (n < nb)
          v = *reinterpret_cast<const uint4*>(
              x + static_cast<size_t>(r0 + n) * K + k0 + c);
        *reinterpret_cast<uint4*>(xs + n * xld + c) = v;
      }
      __syncthreads();
      for (int kk = 0; kk < ks; kk += 16) {
        // B fragment: x[n = g][k = 2t, 2t+1] and [8 + 2t, 9 + 2t]
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(
            xs + g * xld + kk + 2 * t);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(
            xs + g * xld + kk + 8 + 2 * t);
#pragma unroll
        for (int j = 0; j < TILES; ++j) {
          uint32_t a[4];
          ldmatrix_x4_trans(a, ws + (kk + lrow) * wld + wcol + j * 16 + lcol);
          mma_16816(acc[j], a, b0, b1);
        }
      }
    }

    // C fragment: (m = g, n = 2t, 2t+1) in c0, c1 and (m = g + 8, ...) in
    // c2, c3; out[n][m] = C[m][n]
#pragma unroll
    for (int j = 0; j < TILES; ++j) {
      const int m = col0 + wcol + j * 16 + g;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = 2 * t + h;
        if (n < nb) {
          bf16* o = out + static_cast<size_t>(r0 + n) * M + m;
          o[0] = __float2bfloat16_rn(acc[j][h]);
          o[8] = __float2bfloat16_rn(acc[j][2 + h]);
        }
      }
    }
  }
}

// f32: the scalar-FMA output-stationary body over the same n_m blocks, rows
// in chunks of gemv::kMaxB.
__global__ void __launch_bounds__(gemv::kThreads)
triton_gemv_f32_kernel(const float* __restrict__ x,
                       const float* __restrict__ w, float* __restrict__ out,
                       int B, int K, int M, int ld, int m_blk, int k_blk) {
  extern __shared__ float smem[];
  const int mb = blockIdx.x;
  for (int r0 = 0; r0 < B; r0 += gemv::kMaxB) {
    const int nb = min(gemv::kMaxB, B - r0);
    gemv::gemv_tile<float, float>(
        x + static_cast<size_t>(r0) * K, K, w, ld,
        out + static_cast<size_t>(r0) * M + static_cast<size_t>(mb) * m_blk,
        M, nb, 0, K, mb, m_blk, k_blk, smem);
  }
}

template <int TILES>
int launch_bf16(const void* x, const void* w, void* out, int B, int K, int M,
                int ld, int ks, cudaStream_t stream) {
  constexpr int m_blk = 16 * TILES * kWarps;
  triton_gemv_bf16_kernel<TILES>
      <<<M / m_blk, kThreads, bf16_smem_bytes(m_blk, ks), stream>>>(
          static_cast<const bf16*>(x), static_cast<const bf16*>(w),
          static_cast<bf16*>(out), B, K, M, ld, ks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (x, w_t, out, B, K, M, ld, m_blk, k_blk, stream); ld is w_t's row stride
// in elements.  m_blk is 64, 128, 256 or 512 and divides M; k_blk is a
// power of two of at least 16 that divides K (plan_triton_gemv's rule).
extern "C" int triton_gemv_bf16(const void* x, const void* w_t, void* out,
                                int B, int K, int M, int ld, int m_blk,
                                int k_blk, void* stream) {
  if (ld < M || (ld * sizeof(bf16)) % 16 || m_blk <= 0 || M % m_blk
      || k_blk < 16 || k_blk % 16 || K % k_blk || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ks = sub_rows(m_blk, k_blk);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (m_blk) {
    case 64: return launch_bf16<1>(x, w_t, out, B, K, M, ld, ks, s);
    case 128: return launch_bf16<2>(x, w_t, out, B, K, M, ld, ks, s);
    case 256: return launch_bf16<4>(x, w_t, out, B, K, M, ld, ks, s);
    case 512: return launch_bf16<8>(x, w_t, out, B, K, M, ld, ks, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int triton_gemv_f32(const void* x, const void* w_t, void* out,
                               int B, int K, int M, int ld, int m_blk,
                               int k_blk, void* stream) {
  if (ld < M || (ld * sizeof(float)) % 16 || m_blk <= 0 || M % m_blk
      || m_blk % 4 || gemv::kThreads % (m_blk / 4) || k_blk <= 0
      || K % k_blk || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  triton_gemv_f32_kernel<<<M / m_blk, gemv::kThreads,
                           gemv::smem_bytes<float>(gemv::kMaxB, k_blk),
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w_t),
      static_cast<float*>(out), B, K, M, ld, m_blk, k_blk);
  return static_cast<int>(cudaGetLastError());
}
