"""GEMV backends: the contract plus the ``cpu``, ``h100`` and ``gpu``
targets."""

from repro_torch.kernels.backends import cpu, gpu, h100  # noqa: F401
from repro_torch.kernels.backends.base import (
    DEFAULT_POLICY,
    AutotuneTable,
    CostModel,
    DispatchPolicy,
    GemvBackend,
    GemvKey,
    GemvProgram,
    GemvRequest,
    ProgramKey,
    ProgramPlan,
    get_backend,
    register_backend,
    resolve_backend,
)

__all__ = [
    "DEFAULT_POLICY", "AutotuneTable", "CostModel", "DispatchPolicy",
    "GemvBackend", "GemvKey", "GemvProgram", "GemvRequest", "ProgramKey",
    "ProgramPlan",
    "get_backend", "register_backend",
    "resolve_backend",
]
