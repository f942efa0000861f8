"""Calibration artifacts: persist fitted constants, apply them to dispatch
(the port of ``repro.calibration.artifact``).

Two persistence surfaces:

* the **standalone artifact** — one schema-versioned JSON document per
  backend (``build/calibration/<backend>.json``) carrying the fitted
  constants, the error report, and every raw measurement record (the
  bench-trajectory evidence: any future run can re-check the fit against
  the numbers that produced it);
* the **autotune-table ``calibration`` section** — the deployment surface:
  ``AutotuneTable.put_calibration`` stores ``{constants, mape, schema}``
  under the backend's namespace, and ``kernels.dispatch`` applies it to the
  backend on the next plan-cache miss (``_maybe_apply_calibration``), so a
  fleet ships fitted models the same way it ships autotuned placements.

``calibrate_backend`` is the one-command loop ``kernel_bench --calibrate``
drives: sweep -> fit -> artifact -> activate.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading

from repro_torch.calibration.fit import FitResult, fit_cost_model
from repro_torch.calibration.measure import MeasurementRecord, run_sweep
from repro_torch.kernels import dispatch
from repro_torch.kernels.backends import CostModel, get_backend

# Artifact document version: bump when the layout changes.
ARTIFACT_SCHEMA = 1

# under build/, which git ignores, so a run leaves the tree clean (the
# reference writes artifacts/calibration)
DEFAULT_OUT_DIR = os.path.join("build", "calibration")


def artifact_doc(fit: FitResult,
                 records: list[MeasurementRecord]) -> dict:
    """The schema-versioned JSON document for one backend's fit."""
    return {
        "schema": ARTIFACT_SCHEMA,
        "backend": fit.backend,
        "constants": dict(fit.constants),
        "fitted": dict(fit.fitted),
        "mape": fit.mape,
        "seed_mape": fit.seed_mape,
        "per_kernel_mape": dict(fit.per_kernel_mape),
        "n_records": fit.n_records,
        "degenerate": fit.degenerate,
        "records": [r.to_json() for r in records],
    }


def table_entry(doc: dict) -> dict:
    """The compact ``calibration``-section entry for the autotune table
    (constants + provenance; raw records stay in the artifact)."""
    return {
        "schema": doc["schema"],
        "constants": dict(doc["constants"]),
        "mape": doc["mape"],
        "seed_mape": doc["seed_mape"],
        "n_records": doc["n_records"],
        "degenerate": doc["degenerate"],
    }


def write_artifact(path: str, fit: FitResult,
                   records: list[MeasurementRecord]) -> dict:
    """Write the artifact atomically (tmp + ``os.replace``); returns the
    document."""
    doc = artifact_doc(fit, records)
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise
    return doc


def load_artifact(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    if doc.get("schema") != ARTIFACT_SCHEMA:
        raise ValueError(
            f"calibration artifact {path} has schema {doc.get('schema')!r}; "
            f"this package reads schema {ARTIFACT_SCHEMA}")
    if not isinstance(doc.get("constants"), dict) or "backend" not in doc:
        raise ValueError(f"malformed calibration artifact {path}")
    return doc


def apply_artifact(doc_or_path, *, publish: bool = True) -> CostModel:
    """Activate an artifact's constants on its backend.

    With ``publish`` (default) the entry also lands in the process
    autotune table's ``calibration`` section, so dispatch decisions made
    from OTHER call sites count as ``calibrated`` too and a subsequent
    ``save_autotune_table`` ships the constants with the placements.
    Returns the active :class:`CostModel`.
    """
    doc = (load_artifact(doc_or_path) if isinstance(doc_or_path, str)
           else doc_or_path)
    backend = get_backend(doc["backend"])
    cm = backend.seed_cost_model.with_constants(**doc["constants"])
    backend.apply_calibration(cm)
    if publish:
        dispatch.autotune_table().put_calibration(
            backend.name, table_entry(doc))
    return cm


def calibrate_backend(backend_name: str, *, smoke: bool = False,
                      trials: int = 0, out_dir: str = DEFAULT_OUT_DIR,
                      table_path: str | None = None, seed: int = 0,
                      device=None) -> dict:
    """The one-command loop: sweep -> fit -> artifact -> activate.

    Sweeps on ``device`` (the card unless the caller names another),
    writes ``<out_dir>/<backend>.json``, applies the fitted constants to
    the backend (and the process table's ``calibration`` section), and --
    when ``table_path`` is given -- merges them into the persistent v3
    autotune table.  Returns the artifact document with the written path
    added under ``"path"``.
    """
    records = run_sweep(backend_name, smoke=smoke, trials=trials, seed=seed,
                        device=device)
    fit = fit_cost_model(backend_name, records)
    path = os.path.join(out_dir, f"{backend_name}.json")
    doc = write_artifact(path, fit, records)
    apply_artifact(doc)
    if table_path:
        dispatch.save_autotune_table(table_path)
    doc["path"] = os.path.abspath(path)
    return doc
