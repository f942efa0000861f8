"""GEMV backends: the contract plus the ``cpu`` and ``h100`` targets."""

from repro_torch.kernels.backends import cpu, h100  # noqa: F401 (register)
from repro_torch.kernels.backends.base import (
    DEFAULT_POLICY,
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
    "DEFAULT_POLICY", "CostModel", "DispatchPolicy", "GemvBackend", "GemvKey",
    "GemvProgram", "GemvRequest", "ProgramKey", "ProgramPlan",
    "get_backend", "register_backend",
    "resolve_backend",
]
