"""Measured cost-model calibration: the port of ``repro.calibration``.

Measures the real dispatch paths (``measure``; on the card as replayed
CUDA graphs), fits each backend's
:class:`~repro_torch.kernels.backends.CostModel` constants to the
measurements (``fit``), and persists/activates the result
(``artifact``), replacing hand-seeded performance-model constants with
measured ones.

One-command entry point::

    PYTHONPATH=src python benchmarks/kernel_bench_torch.py \
        --calibrate --smoke --backend cpu --device cpu

or programmatically::

    from repro_torch.calibration import calibrate_backend
    doc = calibrate_backend("h100")          # on the card
"""

from repro_torch.calibration.artifact import (
    ARTIFACT_SCHEMA,
    apply_artifact,
    artifact_doc,
    calibrate_backend,
    load_artifact,
    table_entry,
    write_artifact,
)
from repro_torch.calibration.fit import (
    FIT_TERMS,
    FitResult,
    fit_cost_model,
    mape,
    predict_us,
)
from repro_torch.calibration.measure import (
    MeasurementRecord,
    measure_program,
    measure_single,
    robust_us,
    run_sweep,
    sweep_shapes,
)

__all__ = [
    "ARTIFACT_SCHEMA", "FIT_TERMS", "FitResult", "MeasurementRecord",
    "apply_artifact", "artifact_doc", "calibrate_backend", "fit_cost_model",
    "load_artifact", "mape", "measure_program", "measure_single",
    "predict_us", "robust_us", "run_sweep", "sweep_shapes", "table_entry",
    "write_artifact",
]
