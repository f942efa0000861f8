"""Tile planning for the Hopper decode GEMV kernels.

The counterpart of ``repro/kernels/tpu_plan.py``.  The paper's Algorithm 1
sweeps tile height from tall to short until rows distribute evenly over
banks and the register budget holds.  On Hopper:

    bank            -> one CTA (one column block of m_blk outputs)
    register budget -> f32 accumulators for B <= MAX_BATCH rows of the
                       thread's 16-byte column vector, plus the x chunk
                       staged in shared memory (k_blk columns of x)
    even bank dist. -> m_blk divides M, k_blk divides the K walk
    cross-SIMD-lane -> 16-byte vector alignment: each thread owns
                       VEC_BYTES / elem_bytes neighbouring columns

``plan_gemv`` keeps the sweep: the tallest column block (at most
``MAX_M_BLK`` columns) that divides M, then the largest K chunk that divides
the K walk and fits the shared-memory budget.  ``stages`` is the number of
pipeline stages of the K stream; the kernels in this package have one.

Quantized weights (``plan_quant``) reckon the vector in bytes of the STORED
code: one 16-byte vector is 16 int8 columns, or 16 int4 columns times two
K rows.  Their K chunk is a whole number of scale blocks, and their column
block may narrow (down to 32 columns, one 32-byte sector per row) until
the grid has ``min_blocks`` CTAs: the quant path has no split-K to fill
the card with.
"""

from __future__ import annotations

from dataclasses import dataclass

THREADS = 256                # threads per CTA (csrc/gemv_tile.cuh kThreads)
VEC_BYTES = 16               # one vector load per thread per K row
MAX_BATCH = 8                # accumulator rows held in registers (kMaxB)
MAX_M_BLK = 128              # columns per CTA at most
MAX_K_BLK = 1024             # K rows of x staged per chunk at most
X_SMEM_BUDGET = 32 * 1024    # bytes of shared memory for the f32 x chunk
K_ALIGN = 8                  # K chunks and split-K parts are multiples of 8
SPLITK_DEGREES = (8, 4, 2)
QUANT_MIN_M_BLK = 32         # narrowest quant column block: one sector/row


@dataclass(frozen=True)
class GemvPlan:
    m_blk: int
    k_blk: int
    n_m: int
    n_k: int
    smem_bytes: int
    split_k: int = 1
    stages: int = 1


def vec_elems(elem_bytes: int) -> int:
    return VEC_BYTES // elem_bytes


def kernel_applicable(M: int, K: int, batch: int = 1,
                      elem_bytes: int = 2) -> bool:
    """The Hopper twin of ``ops.pallas_applicable``: whole 16-byte column
    vectors, a K walk of whole 8-row groups, and a batch that fits the
    register accumulators."""
    return (M % vec_elems(elem_bytes) == 0 and K % K_ALIGN == 0
            and 1 <= batch <= MAX_BATCH)


def plan_fits(plan: GemvPlan, M: int, K: int, batch: int = 1,
              elem_bytes: int = 2) -> bool:
    """Whether ``pim_gemv`` (``split_k == 1``) or ``splitk_gemv`` takes
    ``plan`` at this shape: the checks their wrappers make."""
    vec = vec_elems(elem_bytes)
    return (plan.stages == 1 and plan.m_blk > 0 and plan.k_blk > 0
            and plan.split_k >= 1 and plan.n_m * plan.m_blk == M
            and plan.m_blk % vec == 0 and THREADS % (plan.m_blk // vec) == 0
            and K % plan.split_k == 0
            and (K // plan.split_k) % plan.k_blk == 0
            and 4 * batch * plan.k_blk <= X_SMEM_BUDGET)


def _smem(batch: int, k_blk: int, elem_bytes: int) -> int:
    return 4 * (batch * k_blk + THREADS * vec_elems(elem_bytes))


def plan_gemv(M: int, K: int, batch: int = 1, *,
              elem_bytes: int = 2) -> GemvPlan:
    """Algorithm-1 sweep: tallest column block dividing M, then the largest
    K chunk dividing K that fits the x budget."""
    if M <= 0 or K <= 0:
        raise ValueError("M and K must be positive")
    if not kernel_applicable(M, K, batch, elem_bytes):
        raise ValueError(f"no Hopper GEMV plan for M={M} K={K} B={batch}")
    vec = vec_elems(elem_bytes)
    m_blk = MAX_M_BLK
    # tall first; a column block spans a power-of-two number of threads so
    # the CTA splits evenly into row groups
    while m_blk > vec and (M % m_blk or THREADS % (m_blk // vec)):
        m_blk //= 2
    k_cap = min(MAX_K_BLK, X_SMEM_BUDGET // (4 * max(batch, 1)), K)
    k_blk = next((k for k in range(k_cap, 0, -1)
                  if K % k == 0 and (k % K_ALIGN == 0 or k == K)), K)
    return GemvPlan(m_blk=m_blk, k_blk=k_blk, n_m=M // m_blk, n_k=K // k_blk,
                    smem_bytes=_smem(batch, k_blk, elem_bytes))


def valid_splitk_degree(K: int, degrees=SPLITK_DEGREES) -> int | None:
    """Highest degree that splits K into parts of whole 8-row groups."""
    for deg in degrees:
        if K % deg == 0 and (K // deg) % K_ALIGN == 0:
            return deg
    return None


def plan_splitk(M: int, K: int, batch: int = 1, *, degree: int,
                elem_bytes: int = 2) -> GemvPlan:
    """Split-K plan: the output-stationary plan of one K part, replicated
    over ``degree`` parts (the grid's second axis)."""
    if K % degree or (K // degree) % K_ALIGN:
        raise ValueError(f"split-K degree {degree} does not split K={K}")
    base = plan_gemv(M, K // degree, batch, elem_bytes=elem_bytes)
    return GemvPlan(m_blk=base.m_blk, k_blk=base.k_blk, n_m=base.n_m,
                    n_k=base.n_k, smem_bytes=base.smem_bytes, split_k=degree)


# --------------------------------------------------------------------------
# Quantized weights (csrc/quant_gemv.cu)
# --------------------------------------------------------------------------


def batch_rows(batch: int) -> int:
    """x rows one quant launch holds: B rounded up to a power of two, at
    most MAX_BATCH (the wrapper launches larger batches in row chunks)."""
    return min(1 << max(min(batch, MAX_BATCH) - 1, 0).bit_length(),
               MAX_BATCH)


def quant_applicable(M: int, K: int, *, bits: int, block: int) -> bool:
    """Whole 16-byte code vectors along M, and a K walk of whole scale
    blocks (whole byte pairs of K rows for int4)."""
    return (bits in (8, 4) and block > 0 and M % VEC_BYTES == 0
            and K % block == 0 and (bits == 8 or block % 2 == 0))


def _quant_smem(xb: int, k_blk: int) -> int:
    # the x chunk [k_blk, xb] f32, reused after the K walk by the row-group
    # reduce tile [THREADS * 16]; then the second reduce level [THREADS]
    return 4 * (max(k_blk * xb, THREADS * VEC_BYTES) + THREADS)


def plan_quant(M: int, K: int, batch: int = 1, *, bits: int = 8,
               block: int = 32, min_blocks: int = 1) -> GemvPlan:
    """Algorithm-1 sweep for the quant kernels: the tallest column block
    (whole code vectors, a power-of-two number of threads) dividing M,
    narrowed while the grid has fewer than ``min_blocks`` CTAs; then the
    largest K chunk of whole scale blocks dividing K that fits the x
    budget."""
    if not quant_applicable(M, K, bits=bits, block=block):
        raise ValueError(f"no quant plan for M={M} K={K} bits={bits} "
                         f"block={block}")
    m_blk = MAX_M_BLK
    while m_blk > VEC_BYTES and (M % m_blk
                                 or THREADS % (m_blk // VEC_BYTES)):
        m_blk //= 2
    while (M // m_blk < min_blocks and m_blk // 2 >= QUANT_MIN_M_BLK
           and M % (m_blk // 2) == 0):
        m_blk //= 2
    xb = batch_rows(batch)
    k_cap = min(MAX_K_BLK, X_SMEM_BUDGET // (4 * xb), K)
    k_blk = next((k for k in range(k_cap - k_cap % block, 0, -block)
                  if K % k == 0), block)
    return GemvPlan(m_blk=m_blk, k_blk=k_blk, n_m=M // m_blk, n_k=K // k_blk,
                    smem_bytes=_quant_smem(xb, k_blk))
