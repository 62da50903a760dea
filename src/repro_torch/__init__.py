"""PyTorch + CUDA port of ``repro`` (the MMA facility), for an NVIDIA H100.

Mirrors ``src/repro/`` path for path; imports ``torch`` and ``numpy`` and
nothing of ``jax`` or ``repro``.  Entry points run on the card unless the
caller asks for the CPU.
"""
