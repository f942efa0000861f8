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

``plan_grouped_stream`` plans ``grouped_gemv`` on the same body, with the
expert as the grid's second dimension: the column block whose ``E x n_m``
CTAs fill the card's waves best.  Its launch holds up to ``MAX_TILE_ROWS``
rows in bf16 (eight mma n-tiles that share each weight sub-tile) and
``MAX_BATCH`` in f32 (:func:`stream_rows`); more rows run in row chunks.

``plan_tile`` keeps the first sweep for the kernel on ``gemv_tile.cuh``
(``ragged_gemv``): the tallest column block (at most ``MAX_M_BLK``
columns) that divides M, then the largest x chunk that divides the K walk
and fits the budget, one stage.

Quantized weights (``plan_quant``) run on the same streaming body: a slot
holds one box of int8 / packed-int4 code rows (16 KB: 128 bytes a row for
a 128-column block, 64 for a 64-column one), x's box of the same K rows
and the box of their f32 scale rows.  A plan's ``k_blk`` counts K rows (two
a stored int4 row), a whole number of scale blocks that divides the K
part; the K parts of a split-K plan are whole scale blocks.  The planner
takes the smallest split degree, then the taller column block, whose grid
fills the card's SMs.
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
MAX_TILE_ROWS = 64           # kMaxTiles * 8: x rows one bf16 launch holds
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


def stream_rows(rows: int, elem_bytes: int) -> int:
    """x rows one launch of the streaming body holds (its x box): up to
    MAX_TILE_ROWS in bf16 (n = 8 tiles sharing each weight sub-tile), up
    to MAX_BATCH in f32; more rows run as chunks of this many."""
    return min(rows, MAX_TILE_ROWS if elem_bytes == 2 else MAX_BATCH)


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


def plan_grouped_stream(M: int, K: int, C: int, *, E: int,
                        sms: int | None = None,
                        elem_bytes: int = 2) -> GemvPlan:
    """``grouped_gemv``'s plan: one CTA per (column block, expert), each
    walking the expert's whole K in sub-tiles of ``SUBTILE_BYTES`` at the
    default ring depth.  The column block (128 or 64) is the one whose
    ``E x n_m`` CTAs fill the card's waves best (the share of the last
    wave's CTA slots in use; ties to the taller block); without an SM
    count (no card) the plan is the 128-column one.  The ring holds
    :func:`stream_rows` rows of x a slot."""
    if M <= 0 or K <= 0 or E <= 0 or C <= 0:
        raise ValueError("M, K, C and E must be positive")
    if not kernel_applicable(M, K, 1, elem_bytes):
        raise ValueError(f"no Hopper GEMV plan for M={M} K={K}")
    sms = device_sms() if sms is None else sms
    rows = stream_rows(C, elem_bytes)
    best, best_fill = None, -1.0
    for m_blk in STREAM_M_BLKS:
        k_blk = sub_rows(m_blk, K, elem_bytes)
        n_k = _ceil(K, k_blk)
        stages = min(DEFAULT_STAGES, n_k)
        smem = stream_smem(rows, m_blk, k_blk, stages, elem_bytes)
        ctas = E * _ceil(M, m_blk)
        wave = (sms or 1) * ctas_per_sm(smem)
        fill = ctas / (_ceil(ctas, wave) * wave) if sms else 0.0
        if fill > best_fill + 1e-9:
            best_fill = fill
            best = GemvPlan(m_blk=m_blk, k_blk=k_blk, n_m=_ceil(M, m_blk),
                            n_k=n_k, smem_bytes=smem, stages=stages)
    return best


def grouped_plan_fits(plan: GemvPlan, M: int, K: int, C: int,
                      elem_bytes: int = 2) -> bool:
    """Whether ``grouped_gemv`` takes ``plan`` for ``[E, C, K] @ [E, K,
    M]``: a streaming plan of one K part (:func:`plan_fits`) at the rows
    one launch holds."""
    return (plan.split_k == 1 and C >= 1
            and plan_fits(plan, M, K, stream_rows(C, elem_bytes),
                          elem_bytes))


def with_pipeline_depth(plan: GemvPlan, depth: int, *, batch: int = 1,
                        elem_bytes: int = 2, bits: int = 16,
                        block: int = 32) -> GemvPlan | None:
    """``plan`` with a ring of ``depth`` sub-tiles, or None when it cannot
    be: a depth outside 1..MAX_STAGES, more slots than the K part has
    sub-tiles, or a ring past one CTA's shared memory.  The port of
    ``repro/kernels/tpu_plan.py::with_pipeline_depth``; the TPU's
    ``n_k % depth == 0`` (K blocks folded into one grid step) has no
    counterpart in a ring.  Tiles, and so the order of the sums, stay.
    ``bits`` 8 / 4 restages a quant plan (its slots hold codes and scales
    of ``block`` K rows)."""
    if depth == plan.stages:
        return plan
    if not 1 <= depth <= min(MAX_STAGES, plan.n_k):
        return None
    if bits < 16:
        smem = quant_smem(stream_rows(batch, elem_bytes), plan.m_blk,
                          plan.k_blk, depth, elem_bytes, plan.split_k, bits,
                          block)
    else:
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
# Quantized weights (csrc/quant_gemv.cu on the streaming body)
# --------------------------------------------------------------------------

QUANT_SPLITS = (1, 2, 4, 8)  # split-K degrees of the quant kernels (clusters)
MAX_X_BOX = 256              # K rows of x's box: one TMA box dimension


def quant_applicable(M: int, K: int, *, bits: int, block: int) -> bool:
    """Whole 16-byte code vectors along M, and a K walk of whole scale
    blocks of whole k16 steps that one x box can hold."""
    return (bits in (8, 4) and 0 < block <= MAX_X_BOX and block % 16 == 0
            and M % VEC_BYTES == 0 and K % block == 0)


def quant_sub_rows(m_blk: int, k_part: int, bits: int, block: int) -> int:
    """K rows of one quant ring slot: SUBTILE_BYTES of codes, at most one x
    box (MAX_X_BOX rows), narrowed to the largest whole number of scale
    blocks that divides the K part."""
    k_blk = min(SUBTILE_BYTES // m_blk * (2 if bits == 4 else 1),
                MAX_X_BOX, k_part)
    k_blk = max(block, k_blk - k_blk % block)
    while k_part % k_blk:
        k_blk -= block
    return k_blk


def quant_smem(batch: int, m_blk: int, k_blk: int, stages: int,
               elem_bytes: int, split_k: int, bits: int, block: int) -> int:
    """Dynamic shared memory of one quant launch
    (``quant_gemv_smem_bytes``): 1 KB of alignment slack, ``stages`` slots
    (the code box, x's ``k_blk`` columns and the scale rows, each slot
    rounded up to 1 KB) or the epilogue that reuses them, and one 8-byte
    mbarrier per slot."""
    rows = k_blk // 2 if bits == 4 else k_blk
    slot = _ceil(m_blk * rows + batch * k_blk * elem_bytes
                 + 4 * (k_blk // block) * m_blk, SLOT_ALIGN) * SLOT_ALIGN
    epi = 4 * batch * m_blk * (stream_groups(m_blk, elem_bytes)
                               + (split_k > 1))
    return SLOT_ALIGN + max(stages * slot, epi) + 8 * stages


def quant_plan_fits(plan: GemvPlan, M: int, K: int, batch: int = 1, *,
                    bits: int, block: int, elem_bytes: int = 2) -> bool:
    """Whether ``quant_gemv`` / ``quant4_gemv`` take ``plan``: a column
    block of the body, a split degree of whole scale blocks, a slot of
    whole scale blocks dividing the K part that x's box spans, and a ring
    the card's shared memory holds at the rows one launch holds."""
    deg = plan.split_k
    if (not quant_applicable(M, K, bits=bits, block=block)
            or plan.m_blk not in STREAM_M_BLKS or deg not in QUANT_SPLITS
            or K % deg or (K // deg) % block or batch < 1):
        return False
    k_part = K // deg
    if (plan.k_blk <= 0 or plan.k_blk % block or plan.k_blk > MAX_X_BOX
            or k_part % plan.k_blk):
        return False
    n_k = k_part // plan.k_blk
    return (plan.n_m == _ceil(M, plan.m_blk) and plan.n_k == n_k
            and 1 <= plan.stages <= min(MAX_STAGES, n_k)
            and quant_smem(stream_rows(batch, elem_bytes), plan.m_blk,
                           plan.k_blk, plan.stages, elem_bytes, deg, bits,
                           block) <= SMEM_PER_CTA)


def quant_candidates(M: int, K: int, batch: int = 1, *, bits: int = 8,
                     block: int = 32, elem_bytes: int = 2) -> list[GemvPlan]:
    """The quant kernels' plans at the default ring depth, one per split
    degree of ``QUANT_SPLITS`` whose K parts are whole scale blocks and per
    column block (taller first), smallest degree first; the slot is
    :func:`quant_sub_rows`'."""
    rows = stream_rows(batch, elem_bytes)
    cands = []
    for deg in QUANT_SPLITS:
        k_part = K // deg
        if K % deg or k_part % block:
            continue
        for m_blk in STREAM_M_BLKS:
            k_blk = quant_sub_rows(m_blk, k_part, bits, block)
            n_k = k_part // k_blk
            stages = min(DEFAULT_STAGES, n_k)
            cands.append(GemvPlan(
                m_blk=m_blk, k_blk=k_blk, n_m=_ceil(M, m_blk), n_k=n_k,
                split_k=deg, stages=stages,
                smem_bytes=quant_smem(rows, m_blk, k_blk, stages,
                                      elem_bytes, deg, bits, block)))
    return cands


def plan_quant(M: int, K: int, batch: int = 1, *, bits: int = 8,
               block: int = 32, elem_bytes: int = 2,
               sms: int | None = None) -> GemvPlan:
    """The quant kernels' plan: of :func:`quant_candidates`, the first
    (smallest split degree, then the taller column block) whose
    ``deg x n_m`` CTAs fill ``sms`` SMs; if none does, the one with the
    most CTAs.  ``sms`` defaults to the device's SM count; without one (no
    card) the plan is the one-part 128-column one, which then only feeds
    the plain versions' checks."""
    if not quant_applicable(M, K, bits=bits, block=block):
        raise ValueError(f"no quant plan for M={M} K={K} bits={bits} "
                         f"block={block}")
    sms = device_sms() if sms is None else sms
    cands = quant_candidates(M, K, batch, bits=bits, block=block,
                             elem_bytes=elem_bytes)
    if not sms:
        return cands[0]
    return next((p for p in cands if p.n_m * p.split_k >= sms),
                max(cands, key=lambda p: p.n_m * p.split_k))
