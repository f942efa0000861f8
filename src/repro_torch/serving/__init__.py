"""Slot-managed continuous-batching engine."""

from repro_torch.serving.step_graph import disable_graphs

__all__ = ["disable_graphs"]
