"""Roofline models of the port's kernels on an H100 (port of
``repro.roofline``)."""
