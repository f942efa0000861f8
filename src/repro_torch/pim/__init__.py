"""Analytical performance models for PIM GEMV (paper §VI-A3): the DRAM
timing model (``timing``) and the GenAI end-to-end model (``e2e``).
Plain Python, the same float operations in the same order as
``repro.pim``, so their numbers are the reference's."""
