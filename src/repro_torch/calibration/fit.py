"""Fit CostModel constants from measurement records (the port of
``repro.calibration.fit``: the same terms, bounds, probe grid and
coordinate descent).

The model terms are the csl-experiments GEMM-model decomposition applied to
each backend's estimator: effective bandwidth x efficiency (the streaming
term), fixed launch overhead, per-grid-program step cost, per-output-element
overhead, and the split-K partial-traffic multiplier.  The objective is the
quantity the acceptance bound is stated in — **MAPE**, mean(|predicted -
measured| / measured) over the sweep — minimized directly by bounded
coordinate descent over the continuous constants, *starting at the seed
values*.  Moves are only accepted when they lower the objective, so the
fitted model can never be worse than the seed on the sweep it was fitted
to (the "strictly better than seed" CI assertion is a property of the
search, not luck).

Each record is priced by the SAME estimator dispatch uses
(``estimate_cost_us`` / ``estimate_program_cost_us``) with the record's own
pinned (kernel, plan) — selection already happened at measure time, so the
fit regresses execution cost, never re-litigates picks.  Candidate
constants are swapped onto the backend via the calibration shadow slot for
the duration of a loss evaluation and always restored.

Degenerate sweeps (a single shape cannot separate bandwidth from overhead
terms) fit only ``gemv_efficiency`` and flag the result — graceful
degradation instead of nonsense constants.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

from repro_torch.calibration.measure import MeasurementRecord
from repro_torch.kernels.backends import CostModel, get_backend

# Continuous terms the regression may move.  ``min_parallel_blocks`` is
# structural (core/SM/bank count) and never fitted.  The collective terms
# (ring all-reduce bandwidth + launch, CostModel.collective_us) only show
# up in sharded-placement pricing — on a collective-free sweep no record's
# prediction depends on them, so coordinate descent (which accepts only
# strict improvements) leaves them at the 0.0 seed sentinel and
# uncalibrated selections stay bit-identical.
FIT_TERMS = ("bandwidth_gbps", "gemv_efficiency", "launch_us",
             "program_us", "elem_ns", "splitk_reduce_factor",
             "collective_gbps", "collective_launch_us")

# Per-term bounds, as (lo(seed), hi(seed)).  Bandwidth may move two orders
# of magnitude either way (an interpret-mode "TPU" on a CPU host is that
# far off); efficiency stays a physical fraction; overheads stay >= 0.
_BOUNDS = {
    "bandwidth_gbps": lambda s: (s / 128.0, s * 128.0),
    "gemv_efficiency": lambda s: (0.02, 1.0),
    "launch_us": lambda s: (0.0, 1e5),
    "program_us": lambda s: (0.0, 1e4),
    "elem_ns": lambda s: (0.0, 1e3),
    "splitk_reduce_factor": lambda s: (0.0, 16.0),
    "collective_gbps": lambda s: (0.0, 1e4),
    "collective_launch_us": lambda s: (0.0, 1e5),
}

# Multiplicative probe grid around the current value, plus an absolute
# ladder so zero-seeded terms (elem_ns) and far-off scales are reachable.
_FACTORS = (0.25, 0.5, 0.7, 0.85, 0.92, 0.96, 0.98, 0.99,
            1.01, 1.02, 1.04, 1.08, 1.2, 1.5, 2.0, 4.0)
_ABS_LADDER = {
    "launch_us": (0.0, 0.1, 0.5, 1.0, 5.0, 20.0, 100.0, 1000.0),
    "program_us": (0.0, 0.01, 0.1, 0.5, 2.0, 10.0, 100.0),
    "elem_ns": (0.0, 1e-4, 1e-3, 1e-2, 0.1, 1.0, 10.0),
    "splitk_reduce_factor": (0.0, 0.5, 1.0, 2.0, 4.0, 8.0),
    "collective_gbps": (0.0, 1.0, 10.0, 50.0, 100.0, 400.0, 1600.0),
    "collective_launch_us": (0.0, 0.5, 2.0, 10.0, 50.0, 200.0),
}


@dataclass
class FitResult:
    """One backend's fitted constants + the error report per fit."""

    backend: str
    constants: dict                 # full constant set (CostModel.constants)
    fitted: dict                    # just the terms the search moved
    mape: float                     # fitted model, over the whole sweep
    seed_mape: float                # same sweep, seed constants
    per_kernel_mape: dict = field(default_factory=dict)
    n_records: int = 0
    degenerate: bool = False        # single-shape sweep: efficiency-only fit

    def cost_model(self) -> CostModel:
        return get_backend(self.backend).seed_cost_model.with_constants(
            **self.constants)


@contextlib.contextmanager
def _swapped_cost_model(backend, cm: CostModel):
    """Run loss evaluations under candidate constants; always restore the
    backend's calibration slot as it was."""
    had = "_calibrated" in backend.__dict__
    prev = backend.__dict__.get("_calibrated")
    backend.apply_calibration(cm)
    try:
        yield
    finally:
        if had:
            backend.apply_calibration(prev)
        else:
            backend.reset_calibration()


def predict_us(backend, rec: MeasurementRecord) -> float:
    """Price one record under the backend's CURRENT cost model — the same
    estimator dispatch selection uses, with the record's pinned decision."""
    if rec.kind == "single":
        return backend.estimate_cost_us(
            rec.kernel, rec.M, rec.K, rec.batch,
            bits=rec.bits, x_bytes=rec.x_bytes, plan=rec.plan)
    return backend.estimate_program_cost_us(
        rec.key, mode=rec.kernel, x_bytes=rec.x_bytes)


def mape(backend, cm: CostModel,
         records: list[MeasurementRecord]) -> float:
    """mean(|predicted - measured| / measured) under constants ``cm``."""
    if not records:
        return float("nan")
    with _swapped_cost_model(backend, cm):
        errs = []
        for r in records:
            meas = r.robust_us
            if meas <= 0:
                continue
            errs.append(abs(predict_us(backend, r) - meas) / meas)
    return sum(errs) / max(len(errs), 1)


def _clamp(v: float, lo: float, hi: float) -> float:
    return min(max(v, lo), hi)


def _candidates(term: str, v: float, seed: float) -> list[float]:
    lo, hi = _BOUNDS[term](seed)
    cands = {_clamp(v * f, lo, hi) for f in _FACTORS if v > 0}
    for a in _ABS_LADDER.get(term, ()):
        cands.add(_clamp(a, lo, hi))
    cands.add(_clamp(v, lo, hi))
    return sorted(cands)


def fit_cost_model(backend_name: str, records: list[MeasurementRecord], *,
                   passes: int = 4) -> FitResult:
    """Bounded coordinate descent on MAPE, seeded at the class constants.

    Each pass sweeps every term in :data:`FIT_TERMS`, probing a
    multiplicative grid around the current value plus the term's absolute
    ladder; the best strictly-improving candidate is kept.  Deterministic
    (no randomness), monotone (the objective never increases), and cheap —
    the loss is pure-Python pricing of ~dozens of records.
    """
    backend = get_backend(backend_name)
    seed = backend.seed_cost_model
    records = [r for r in records if r.robust_us > 0]
    shapes = {(r.M, r.K, r.batch, r.kind) for r in records}
    degenerate = len(shapes) < 3
    terms = ("gemv_efficiency",) if degenerate else FIT_TERMS

    seed_err = mape(backend, seed, records)
    best_cm, best_err = seed, seed_err
    for _ in range(max(passes, 1)):
        improved = False
        for term in terms:
            cur = getattr(best_cm, term)
            for cand in _candidates(term, cur, getattr(seed, term)):
                if cand == cur:
                    continue
                cm = best_cm.with_constants(**{term: cand})
                err = mape(backend, cm, records)
                if err < best_err:
                    best_cm, best_err, improved = cm, err, True
        if not improved:
            break

    per_kernel: dict[str, float] = {}
    for kern in sorted({r.kernel for r in records}):
        per_kernel[kern] = mape(
            backend, best_cm, [r for r in records if r.kernel == kern])
    fitted = {
        t: getattr(best_cm, t) for t in terms
        if getattr(best_cm, t) != getattr(seed, t)
    }
    return FitResult(
        backend=backend_name, constants=best_cm.constants(), fitted=fitted,
        mape=best_err, seed_mape=seed_err, per_kernel_mape=per_kernel,
        n_records=len(records), degenerate=degenerate,
    )
