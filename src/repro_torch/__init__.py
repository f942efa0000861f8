"""PyTorch/CUDA port of the PIMnast serving stack for NVIDIA Hopper.

Mirrors the layout of the JAX package ``repro``: ``configs``, ``kernels``
(planner, dispatcher, backends and the hand-written CUDA GEMV kernels under
``csrc/``), ``models`` and ``serving``.  Imports ``torch``, never ``jax``.
"""
