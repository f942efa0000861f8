// Block-scaled int8 / packed-int4 decode GEMV for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels src/repro/kernels/quant_gemv.py::quant_gemv
// (body _quant_kernel) and ::quant4_gemv (body _quant4_kernel):
//
//   out[B, M] = x[B, K] @ (q[K, M] * s[K / block, M])      (f32 contraction)
//
// q holds int8 codes [K, M], or packed int4 codes [K / 2, M] (packed row i:
// K row 2i in the low nibble, K row 2i + 1 in the high nibble, both
// sign-extended); s holds one f32 scale per (K block, column); out is
// written in x's type.  The rows of q lie ldw bytes apart and those of s
// lds floats apart (ldw >= M, ldw a multiple of 16, lds of 4), so a column
// slice of a wider prepacked weight runs without a copy.
//
// Bound on this card: every code byte, the scales (a quarter of the int8
// code bytes at block 32), x and out each cross HBM once, at 3.35 TB/s.
// Turning each code into an operand costs instructions, so the design
// spends as few as it can a code (below).
//
// Design: the streaming body of pim_gemv / splitk_gemv (gemv_stream.cuh,
// Q = 8 or 4).  A ring of TMA slots carries the code box, x's box and the
// scale box of each K sub-tile together (the paper's placement rule: the
// scales are blocked beside their weights so both arrive at once).  bf16 x
// runs on mma.sync.m16n8k16 with the codes turned into bf16 in registers
// (exact: every code is a small integer), each scale block summed into a
// zeroed fragment and then scaled into the f32 accumulator
// (acc = fma(s, part, acc)); up to 64 rows share each code sub-tile.  f32 x
// takes scalar f32 FMAs per block (8 rows a launch).  A split-K plan runs
// its deg K parts as one thread block cluster that sums the parts in rank
// order in distributed shared memory.  The order of the sums depends on
// the plan's column block, sub-tile and split degree, never on the ring
// depth: outputs at every depth are bit-identical.
//
// Plain C interface, loaded with ctypes.  Each entry returns the first
// failing launch's CUDA error (cudaErrorInvalidValue for a shape the kernel
// does not take), else 0.
#include "gemv_stream.cuh"

namespace {

template <typename T, int Q>
int run_quant(const void* x, const void* w, const void* s, void* out, int B,
              int K, int M, int ldw, int lds, int block, int deg, int m_blk,
              int k_blk, int stages, void* stream) {
  if (B < 1 || deg < 1 || K % deg || block < 1 || k_blk % (Q == 4 ? 2 : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int kp = K / deg;
  if (kp % block) return static_cast<int>(cudaErrorInvalidValue);
  const long long kp_rows = Q == 4 ? kp / 2 : kp;
  gemv_stream::Problem p{x, w, out, B, M, kp, deg,
                         ldw, kp_rows * ldw,
                         K, kp, M, 0};
  p.s = s;
  p.lds = lds;
  p.s_ps = static_cast<long long>(kp / block) * lds;
  p.block = block;
  const int ks = Q == 4 ? k_blk / 2 : k_blk;   // stored rows of a sub-tile
  return deg > 1
             ? gemv_stream::run<T, true, gemv_stream::kMaxTiles, Q>(
                   p, m_blk, ks, stages, stream)
             : gemv_stream::run<T, false, gemv_stream::kMaxTiles, Q>(
                   p, m_blk, ks, stages, stream);
}

}  // namespace

// (x, codes, scales, out, B, K, M, ldw, lds, block, deg, m_blk, k_blk,
// stages, stream): K is the logical K (twice the packed rows for int4),
// ldw and lds the row strides of the codes (bytes) and the scales
// (floats), deg the split-K degree (a cluster when above 1), m_blk the
// column block (64 or 128), k_blk the K rows of one ring slot, stages the
// ring depth.
#define QUANT_ENTRY(NAME, T, Q)                                              \
  extern "C" int NAME(const void* x, const void* w_q, const void* scales,   \
                      void* out, int B, int K, int M, int ldw, int lds,     \
                      int block, int deg, int m_blk, int k_blk, int stages, \
                      void* stream) {                                       \
    return run_quant<T, Q>(x, w_q, scales, out, B, K, M, ldw, lds, block,   \
                           deg, m_blk, k_blk, stages, stream);              \
  }

QUANT_ENTRY(quant_gemv_bf16, __nv_bfloat16, 8)
QUANT_ENTRY(quant_gemv_f32, float, 8)
QUANT_ENTRY(quant4_gemv_bf16, __nv_bfloat16, 4)
QUANT_ENTRY(quant4_gemv_f32, float, 4)

// Dynamic shared memory of one launch in bytes (the planner's smem_bytes
// must equal it): B rows a box, k_blk K rows a slot.
extern "C" long long quant_gemv_smem_bytes(int B, int m_blk, int k_blk,
                                           int stages, int elem_bytes,
                                           int split_k, int bits,
                                           int block) {
  return static_cast<long long>(gemv_stream::smem_bytes(
      B, m_blk, bits == 4 ? k_blk / 2 : k_blk, stages, elem_bytes, split_k,
      bits, block));
}
