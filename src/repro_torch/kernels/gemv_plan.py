"""Tile planning for the Hopper decode GEMV kernels.

The counterpart of ``repro/kernels/tpu_plan.py``.  The paper's Algorithm 1
sweeps tile height from tall to short until rows distribute evenly over
banks and the register budget holds.  On Hopper:

    bank            -> one CTA (one column block of m_blk outputs)
    register budget -> shared memory: the ring of weight sub-tiles, and how
                       many CTAs an SM holds with it
    even bank dist. -> a grid resident in one wave (or whole waves) of the
                       card's SMs
    cross-SIMD-lane -> 16-byte vector alignment: each copy moves
                       VEC_BYTES / elem_bytes neighbouring columns

``plan_gemv`` / ``plan_splitk`` plan the streaming kernels ``pim_gemv`` and
``splitk_gemv`` (``csrc/gemv_stream.cuh``): a column block of 128 or 64
columns (the last one may be ragged), a K sub-tile of ``k_blk`` rows (16
KB of weights, whole k16 steps; the last one may be ragged), and a ring of
``stages`` sub-tiles filled by the TMA.  The depth is the TPU's
``pipeline_depth``: :func:`with_pipeline_depth` restages a plan, and the
order of the sums never depends on it.  The default depth is 2: on an H100
a CTA's streaming rate measured flat in the depth (PERF.md), so
shared memory goes to CTAs per SM instead.

``plan_tile`` keeps the first sweep for the kernels on ``gemv_tile.cuh``
(``grouped_gemv`` / ``ragged_gemv``): the tallest column block (at most
``MAX_M_BLK`` columns) that divides M, then the largest x chunk that
divides the K walk and fits the budget, one stage.

Quantized weights (``plan_quant``) reckon the vector in bytes of the STORED
code: one 16-byte vector is 16 int8 columns, or 16 int4 columns times two
K rows.  Their K chunk is a whole number of scale blocks, and their column
block may narrow (down to 32 columns, one 32-byte sector per row) until
the grid has ``min_blocks`` CTAs: the quant path has no split-K to fill
the card with.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

THREADS = 256                # threads per CTA (csrc/gemv_tile.cuh kThreads)
VEC_BYTES = 16               # one vector load per thread per K row
MAX_BATCH = 8                # accumulator rows held in registers (kMaxB)
MAX_M_BLK = 128              # columns per CTA at most
MAX_K_BLK = 1024             # K rows of x staged per chunk at most
X_SMEM_BUDGET = 32 * 1024    # bytes of shared memory for the f32 x chunk
K_ALIGN = 8                  # K chunks and split-K parts are multiples of 8
SPLITK_DEGREES = (8, 4, 2)   # also the cluster sizes of splitk_gemv
QUANT_MIN_M_BLK = 32         # narrowest quant column block: one sector/row

# the streaming kernels (csrc/gemv_stream.cuh)
STREAM_THREADS = 256         # kThreads: 8 warps
STREAM_M_BLKS = (128, 64)    # column blocks the kernels are built for
SUBTILE_BYTES = 16 * 1024    # weights in one ring slot
SUB_ALIGN = 16               # sub-tile rows: whole mma k16 steps
MAX_SUB_ROWS = 256           # ... and one TMA box's height at most
SLOT_ALIGN = 1024            # kAlign: slots start on the swizzle's 1 KB
DEFAULT_STAGES = 2           # the planner's ring depth
MAX_STAGES = 8               # kMaxStages
MAX_CTAS_PER_SM = 4          # __launch_bounds__(256, 4): <= 64 registers
SMEM_PER_SM = 228 * 1024     # Hopper: shared memory of one SM
SMEM_PER_CTA = 227 * 1024    # ... that one CTA may opt in to (kMaxSmem)
CTA_RESERVED = 1024          # ... and what the system keeps per CTA


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


def device_sms() -> int | None:
    """SMs of the current CUDA device; None on a host without one."""
    import torch

    if not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def stream_groups(m_blk: int, elem_bytes: int) -> int:
    """k groups of the streaming body: warps (bf16, one m16 tile each) or
    threads (f32, one column each) that share a column range."""
    return (128 if elem_bytes == 2 else STREAM_THREADS) // m_blk


def stream_smem(batch: int, m_blk: int, k_blk: int, stages: int,
                elem_bytes: int, split_k: int = 1) -> int:
    """Dynamic shared memory of one launch (``gemv_stream::smem_bytes``):
    1 KB of alignment slack, ``stages`` slots (the weight sub-tile and x's
    same columns, each slot rounded up to 1 KB) or the epilogue that
    reuses them (the k groups' f32 sums, then split-K's partial tile),
    and one 8-byte mbarrier per slot."""
    slot = _ceil((m_blk + batch) * k_blk * elem_bytes, SLOT_ALIGN) \
        * SLOT_ALIGN
    epi = 4 * batch * m_blk * (stream_groups(m_blk, elem_bytes)
                               + (split_k > 1))
    return SLOT_ALIGN + max(stages * slot, epi) + 8 * stages


def ctas_per_sm(smem: int) -> int:
    """CTAs one SM holds at this much dynamic shared memory each."""
    return min(MAX_CTAS_PER_SM, SMEM_PER_SM // (smem + CTA_RESERVED))


def sub_rows(m_blk: int, k_part: int, elem_bytes: int) -> int:
    """Rows of one K sub-tile (one TMA box's height): SUBTILE_BYTES of
    weights, at most the K part rounded up to whole k16 steps."""
    return min(SUBTILE_BYTES // (m_blk * elem_bytes),
               _ceil(k_part, SUB_ALIGN) * SUB_ALIGN)


def plan_fits(plan: GemvPlan, M: int, K: int, batch: int = 1,
              elem_bytes: int = 2) -> bool:
    """Whether ``pim_gemv`` (``split_k == 1``) or ``splitk_gemv`` takes
    ``plan`` at this shape: the checks their wrappers make."""
    deg = plan.split_k
    if (plan.m_blk not in STREAM_M_BLKS or deg not in (1, *SPLITK_DEGREES)
            or K % deg or (K // deg) % K_ALIGN or plan.k_blk <= 0
            or plan.k_blk % SUB_ALIGN or plan.k_blk > MAX_SUB_ROWS):
        return False
    n_k = _ceil(K // deg, plan.k_blk)
    return (plan.n_m == _ceil(M, plan.m_blk) and plan.n_k == n_k
            and 1 <= plan.stages <= min(MAX_STAGES, n_k)
            and stream_smem(batch, plan.m_blk, plan.k_blk, plan.stages,
                            elem_bytes, deg) <= SMEM_PER_CTA)


def _plan_stream(M: int, k_part: int, batch: int, deg: int,
                 elem_bytes: int, sms: int | None) -> GemvPlan:
    """Column block of a streaming launch over ``deg`` K parts of
    ``k_part`` rows, at the default ring depth.

    Tall first: 128 columns when that grid fills the SMs in one wave;
    else 64 when that grid is one wave (more SMs stream); else 128 when it
    is one wave; past one wave, the block whose grid is a whole number of
    waves (128 first).  Without an SM count (no card) the plan is the
    128-column one: it then only feeds the plain version's checks.
    """
    cands = []
    for m_blk in STREAM_M_BLKS:
        n_m = _ceil(M, m_blk)
        k_blk = sub_rows(m_blk, k_part, elem_bytes)
        n_k = _ceil(k_part, k_blk)
        stages = min(DEFAULT_STAGES, n_k)
        ctas = n_m * deg
        held = ctas_per_sm(stream_smem(batch, m_blk, k_blk, stages,
                                       elem_bytes, deg))
        cands.append(dict(m_blk=m_blk, k_blk=k_blk, n_m=n_m, n_k=n_k,
                          stages=stages, ctas=ctas,
                          wave=bool(sms) and ctas <= sms * held,
                          whole=bool(sms) and ctas % (sms * held) == 0))
    tall, narrow = cands
    if tall["wave"] and tall["ctas"] >= sms:
        pick = tall
    elif narrow["wave"]:
        pick = narrow
    elif tall["wave"] or tall["whole"] or not narrow["whole"]:
        pick = tall
    else:
        pick = narrow
    return GemvPlan(
        m_blk=pick["m_blk"], k_blk=pick["k_blk"], n_m=pick["n_m"],
        n_k=pick["n_k"], split_k=deg, stages=pick["stages"],
        smem_bytes=stream_smem(batch, pick["m_blk"], pick["k_blk"],
                               pick["stages"], elem_bytes, deg))


def plan_gemv(M: int, K: int, batch: int = 1, *, elem_bytes: int = 2,
              sms: int | None = None) -> GemvPlan:
    """``pim_gemv``'s plan: one K walk per column block (see
    :func:`_plan_stream`); ``sms`` defaults to the device's SM count."""
    if M <= 0 or K <= 0:
        raise ValueError("M and K must be positive")
    if not kernel_applicable(M, K, batch, elem_bytes):
        raise ValueError(f"no Hopper GEMV plan for M={M} K={K} B={batch}")
    return _plan_stream(M, K, batch, 1, elem_bytes,
                        device_sms() if sms is None else sms)


def valid_splitk_degree(K: int, degrees=SPLITK_DEGREES) -> int | None:
    """Highest degree that splits K into parts of whole 8-row groups."""
    for deg in degrees:
        if K % deg == 0 and (K // deg) % K_ALIGN == 0:
            return deg
    return None


def plan_splitk(M: int, K: int, batch: int = 1, *, degree: int,
                elem_bytes: int = 2, sms: int | None = None) -> GemvPlan:
    """``splitk_gemv``'s plan: ``degree`` K parts (one cluster per column
    block), each planned as :func:`_plan_stream` plans a launch."""
    if (degree not in SPLITK_DEGREES or K % degree
            or (K // degree) % K_ALIGN):
        raise ValueError(f"split-K degree {degree} does not split K={K}")
    if not kernel_applicable(M, K, batch, elem_bytes):
        raise ValueError(f"no Hopper GEMV plan for M={M} K={K} B={batch}")
    return _plan_stream(M, K // degree, batch, degree, elem_bytes,
                        device_sms() if sms is None else sms)


def with_pipeline_depth(plan: GemvPlan, depth: int, *, batch: int = 1,
                        elem_bytes: int = 2) -> GemvPlan | None:
    """``plan`` with a ring of ``depth`` sub-tiles, or None when it cannot
    be: a depth outside 1..MAX_STAGES, more slots than the K part has
    sub-tiles, or a ring past one CTA's shared memory.  The port of
    ``repro/kernels/tpu_plan.py::with_pipeline_depth``; the TPU's
    ``n_k % depth == 0`` (K blocks folded into one grid step) has no
    counterpart in a ring.  Tiles, and so the order of the sums, stay."""
    if depth == plan.stages:
        return plan
    if not 1 <= depth <= min(MAX_STAGES, plan.n_k):
        return None
    smem = stream_smem(batch, plan.m_blk, plan.k_blk, depth, elem_bytes,
                       plan.split_k)
    if smem > SMEM_PER_CTA:
        return None
    return replace(plan, stages=depth, smem_bytes=smem)


def plan_tile(M: int, K: int, batch: int = 1, *,
              elem_bytes: int = 2) -> GemvPlan:
    """The ``gemv_tile.cuh`` body's plan (the expert kernels): tallest
    column block dividing M, then the largest K chunk dividing K that fits
    the x budget; one stage."""
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


def _smem(batch: int, k_blk: int, elem_bytes: int) -> int:
    return 4 * (batch * k_blk + THREADS * vec_elems(elem_bytes))


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
