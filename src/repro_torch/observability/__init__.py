"""Observability: flight recorder, Perfetto export, structured warn-once
(the port of ``repro.observability``).

The serving and dispatch layers attribute where a request's latency went
(queued / prefill / decode / preempted, per request) and how well the cost
model priced each dispatch decision (predicted vs measured µs per kernel,
measured on the caller's device) through one
:class:`~repro_torch.observability.trace.Tracer`.  Nothing in this package
imports torch or the kernel layer at module scope.
"""

from repro_torch.observability.log import reset_warn_once, warn_once
from repro_torch.observability.trace import (
    SCHEMA_VERSION,
    DispatchRecord,
    Event,
    Span,
    Tracer,
    current_tracer,
    install_tracer,
    uninstall_tracer,
)

__all__ = [
    "SCHEMA_VERSION", "Tracer", "Span", "Event", "DispatchRecord",
    "install_tracer", "uninstall_tracer", "current_tracer",
    "warn_once", "reset_warn_once",
]
