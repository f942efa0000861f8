"""Slot-managed continuous-batching engine."""
