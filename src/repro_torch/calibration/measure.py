"""Instrumented GEMV sweeps: the measurement half of cost-model calibration.

Every :class:`~repro_torch.kernels.backends.CostModel` ships hand-seeded
constants until a sweep measures the real thing.  This module times the
REAL dispatch paths -- ``dispatch_gemv`` with the kernel pinned per
candidate, and ``execute_program`` for the three program kinds -- on
synthetic inputs, and emits one :class:`MeasurementRecord` per (backend,
kernel, shape) for ``calibration.fit`` to regress constants from (the
port of ``repro.calibration.measure``).

Measurement protocol (per record):

1. on the card the dispatch path is **captured into a CUDA graph** over
   weight copies that stream past the L2
   (:func:`~repro_torch.kernels.backends.base.time_trials_us`): serving
   replays its decode step as a graph, so the replay is what the cost
   model prices.  A host clock around an eager call would also count each
   wrapper's checks, its ctypes call and the tensor maps it encodes, and
   the fit would read that as phantom bandwidth.  This replaces the
   reference's ``jax.jit``;
2. **warm-up** -- one untimed call builds and loads the kernel before the
   capture;
3. **trials** -- ``trials`` replays, each between two CUDA events (on the
   CPU: ``trials`` host wall-clock calls after the warm-up);
4. raw per-trial times are kept on the record; outlier rejection
   (median/MAD) happens at fit time (:func:`robust_us`).

On the card the sweep runs in bf16 (``x_bytes`` 2), the dtype the port
serves; the reference, and this module on the CPU, measure f32
(``x_bytes`` 4).  Each record carries its dtype.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch
from repro_torch.kernels.backends import (
    DispatchPolicy,
    GemvKey,
    ProgramKey,
    get_backend,
)
from repro_torch.kernels.backends.base import (
    program_copies,
    time_trials_us,
    weight_copies,
)
from repro_torch.kernels.ops import pack_weight, quantize_weight

# the reference's cap on a measured weight's f32 bytes: the full sweep
# keeps the reference's shapes whatever dtype it runs in
MAX_WEIGHT_BYTES = 256 * 2**20

# Smoke sweep: every shape is >= the dispatcher's min_pallas_bytes gate
# (1 MiB weights) so the auto pick exercises real selection, small enough
# that the whole sweep is seconds.  The spread varies M, K, batch and
# aspect ratio -- a sweep where only one dimension moves cannot separate
# bandwidth from per-element overhead.
SMOKE_SINGLE_SHAPES: tuple[tuple[str, int, int, int, int], ...] = (
    # (label, M, K, batch, bits)
    ("sq_1k", 1024, 1024, 1, 16),
    ("tallk_512x4k", 512, 4096, 1, 16),
    ("widem_4kx512", 4096, 512, 1, 16),
    ("sq_2k", 2048, 2048, 1, 16),
    ("batched_1kx4k", 1024, 4096, 4, 16),
    ("int8_1k", 1024, 1024, 1, 8),
)
SMOKE_PROGRAM_SHAPES: tuple[tuple, ...] = (
    # (label, kind, Ms, K, batch, group, tokens)
    ("fused_2x512", "fused", (512, 512), 1024, 1, 2, 0),
    ("grouped_e4", "grouped", (512,), 1024, 2, 4, 0),
    ("ragged_e4", "ragged", (512,), 1024, 0, 4, 8),
)

# Full sweep: the smoke spread plus the registry decode shapes the
# dispatcher actually serves, byte-capped.
FULL_EXTRA_BATCHES = (2, 8)
FULL_ARCHS = ("gemma3-1b", "olmo-1b", "minitron-8b")


def sweep_dtype(device: torch.device) -> torch.dtype:
    """bf16 on the card (the dtype the port serves), f32 elsewhere (the
    reference's)."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


@dataclass(frozen=True)
class MeasurementRecord:
    """One timed (backend, kernel, shape) cell of a sweep.

    ``kernel`` is the executed kernel for single-GEMV records and the
    executed program *mode* for program records; ``key``/``plan`` are the
    in-process pricing handles (the exact decision that ran, so the fitter
    prices precisely what was measured -- they don't serialize, see
    :meth:`to_json`).  ``dtype`` is the measured x and weight dtype.
    """

    backend: str
    kind: str                      # "single" | "fused" | "grouped" | "ragged"
    label: str
    kernel: str                    # kernel name (single) or mode (program)
    M: int                         # total output width
    K: int
    batch: int
    bits: int
    x_bytes: int
    trials_us: tuple[float, ...]
    dtype: str = "float32"
    key: object = field(default=None, compare=False)
    plan: object = field(default=None, compare=False)

    @property
    def robust_us(self) -> float:
        """Median with median/MAD outlier rejection (see :func:`robust_us`)."""
        return robust_us(self.trials_us)

    def to_json(self) -> dict:
        return {
            "backend": self.backend, "kind": self.kind, "label": self.label,
            "kernel": self.kernel, "M": self.M, "K": self.K,
            "batch": self.batch, "bits": self.bits, "x_bytes": self.x_bytes,
            "dtype": self.dtype, "trials_us": list(self.trials_us),
            "robust_us": self.robust_us,
        }


def _median(a: list[float]) -> float:
    n = len(a)
    if n == 0:
        return float("nan")
    return a[n // 2] if n % 2 else 0.5 * (a[n // 2 - 1] + a[n // 2])


def robust_us(trials_us) -> float:
    """Median with median/MAD outlier rejection.

    Trials more than 3 scaled-MADs from the median are dropped (a GC
    pause or scheduler hiccup must not drag a constant), then the median
    of the survivors is the one number.
    """
    a = sorted(trials_us)
    med = _median(a)
    mad = _median(sorted(abs(t - med) for t in a))
    if mad <= 0:
        return med
    keep = [t for t in a if abs(t - med) <= 3 * 1.4826 * mad]
    return _median(keep) if keep else med


def measure_single(backend_name: str, label: str, M: int, K: int,
                   batch: int, bits: int, *, trials: int,
                   rng: np.random.Generator,
                   device: torch.device) -> list[MeasurementRecord]:
    """Time the auto pick and every applicable fixed kernel for one shape.

    One record per DISTINCT executed (kernel, plan): a pinned kernel the
    backend downgrades (e.g. a ``triton`` pin no plan tiles) would
    duplicate the ``ref`` record, so results dedupe on the kernel that
    actually ran.
    """
    backend = get_backend(backend_name)
    dtype = sweep_dtype(device)
    x_bytes = dtype.itemsize
    w = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((batch, K)).astype(
        np.float32)).to(device=device, dtype=dtype)
    if bits < 16:
        pw = quantize_weight(w.to(device=device, dtype=dtype), bits=bits,
                             block=32)
        pins = ("auto",)
    else:
        pw = pack_weight(w.to(device=device, dtype=dtype))
        pins = ("auto",) + tuple(
            k for k in backend.kernels if not k.startswith("quant"))
    pws = weight_copies(pw, device)
    records, seen = [], set()
    for pin in pins:
        pol = DispatchPolicy(backend=backend_name, kernel=pin)
        kernel, plan = backend.select_kernel(
            M, K, batch, bits=bits, block=pw.block, x_bytes=x_bytes,
            policy=pol)
        if (kernel, repr(plan)) in seen:
            continue
        seen.add((kernel, repr(plan)))
        trials_us = time_trials_us(
            lambda i, _pol=pol: dispatch.dispatch_gemv(x, pws[i],
                                                       policy=_pol),
            trials, copies=len(pws), device=device)
        records.append(MeasurementRecord(
            backend=backend_name, kind="single",
            label=f"{label}/{kernel}", kernel=kernel,
            M=M, K=K, batch=batch, bits=bits, x_bytes=x_bytes,
            trials_us=trials_us, dtype=str(dtype).removeprefix("torch."),
            key=GemvKey(M=M, K=K, batch=batch, bits=bits, block=pw.block,
                        dtype=str(dtype), backend=backend_name),
            plan=plan,
        ))
    return records


def measure_program(backend_name: str, label: str, kind: str,
                    Ms: tuple[int, ...], K: int, batch: int, group: int,
                    tokens: int, *, trials: int,
                    device: torch.device) -> MeasurementRecord:
    """Time one program shape under its planned joint mode."""
    backend = get_backend(backend_name)
    policy = DispatchPolicy(backend=backend_name)
    dtype = sweep_dtype(device)
    x_bytes = dtype.itemsize
    if kind == "ragged":
        batch = batch or max(1, -(-tokens // max(group, 1)))
    key = ProgramKey(kind=kind, Ms=Ms, K=K, batch=batch, group=group,
                     bits=16, block=32, dtype=str(dtype),
                     backend=backend_name, tokens=tokens)
    pplan = backend.plan_program(key, policy=policy)
    programs = program_copies(key, device)
    trials_us = time_trials_us(
        lambda i: backend.run_program_candidate(programs[i], pplan, policy),
        trials, copies=len(programs), device=device)
    return MeasurementRecord(
        backend=backend_name, kind=kind, label=f"{label}/{pplan.mode}",
        kernel=pplan.mode, M=key.total_M, K=K, batch=batch, bits=16,
        x_bytes=x_bytes, trials_us=trials_us,
        dtype=str(dtype).removeprefix("torch."), key=key, plan=pplan,
    )


def sweep_shapes(*, smoke: bool) -> tuple[list, list]:
    """(single shapes, program shapes) for a sweep tier."""
    singles = list(SMOKE_SINGLE_SHAPES)
    programs = list(SMOKE_PROGRAM_SHAPES)
    if smoke:
        return singles, programs
    from repro_torch.configs.registry import ARCHS

    for name in FULL_ARCHS:
        cfg = ARCHS[name]
        for tag, M, K in (("ffn_up", cfg.d_ff, cfg.d_model),
                          ("ffn_down", cfg.d_model, cfg.d_ff),
                          ("lm_head", cfg.vocab, cfg.d_model)):
            if M * K * 4 > MAX_WEIGHT_BYTES:
                continue
            singles.append((f"{name}/{tag}", M, K, 1, 16))
        for b in FULL_EXTRA_BATCHES:
            singles.append((f"{name}/ffn_down_b{b}",
                            cfg.d_model, cfg.d_ff, b, 16))
        hd = cfg.hd
        programs.append((
            f"{name}/qkv", "fused",
            (cfg.n_heads * hd, cfg.n_kv_heads * hd, cfg.n_kv_heads * hd),
            cfg.d_model, 1, 3, 0))
    return singles, programs


def run_sweep(backend_name: str, *, smoke: bool = False, trials: int = 0,
              seed: int = 0, device=None) -> list[MeasurementRecord]:
    """The full measurement pass: every sweep shape, every applicable
    kernel, all three program kinds, on ``device`` (the card unless the
    caller names another).  Returns the record list the fitter consumes
    (records keep their pricing handles; persist them via
    ``calibration.artifact``)."""
    device = resolve_device(device)
    trials = trials or (3 if smoke else 5)
    rng = np.random.default_rng(seed)
    singles, programs = sweep_shapes(smoke=smoke)
    records: list[MeasurementRecord] = []
    for label, M, K, batch, bits in singles:
        records.extend(measure_single(
            backend_name, label, M, K, batch, bits, trials=trials, rng=rng,
            device=device))
    for label, kind, Ms, K, batch, group, tokens in programs:
        records.append(measure_program(
            backend_name, label, kind, tuple(Ms), K, batch, group, tokens,
            trials=trials, device=device))
    return records
