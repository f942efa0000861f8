"""Structured warn-once: one memoized warning per key, mirrored to traces
(the port of ``repro/observability/log.py``).

* ``warn_once(key, message)`` warns through :mod:`warnings` the first
  time ``key`` is seen and is a silent no-op after;
* ``per_site=True`` memoizes on ``(key, caller file, caller line)``
  instead, so each distinct call site warns once;
* with a tracer installed (:func:`~repro_torch.observability.trace
  .current_tracer`), the first warning also lands in the trace as a
  ``warn_once`` event.

Callers that tie a warning's lifetime to a cache reset their namespace
with ``reset_warn_once(prefix)``; keys are namespaced by convention
(``"calibration:h100"``).
"""

from __future__ import annotations

import sys
import threading
import warnings

from repro_torch.observability.trace import current_tracer

_LOCK = threading.Lock()
_WARNED: set[tuple] = set()


def warn_once(key: str, message: str, *, category=RuntimeWarning,
              depth: int = 1, per_site: bool = False) -> bool:
    """Warn for ``key`` unless it already warned; returns True on first.

    ``depth`` is the ``sys._getframe`` hop count from this helper to the
    frame the warning should point at (1 = our direct caller); it feeds
    both the per-site memo key and ``stacklevel``.
    """
    if per_site:
        f = sys._getframe(depth)
        memo = (key, f.f_code.co_filename, f.f_lineno)
    else:
        memo = (key,)
    with _LOCK:
        if memo in _WARNED:
            return False
        _WARNED.add(memo)
    tracer = current_tracer()
    if tracer is not None:
        tracer.event("warn_once", cat="log", key=key,
                     category=category.__name__, message=message)
    warnings.warn(message, category, stacklevel=depth + 1)
    return True


def reset_warn_once(prefix: str | None = None) -> None:
    """Forget warned keys (all, or those starting with ``prefix``) so the
    next occurrence warns again."""
    with _LOCK:
        if prefix is None:
            _WARNED.clear()
            return
        for memo in [m for m in _WARNED if str(m[0]).startswith(prefix)]:
            _WARNED.discard(memo)
