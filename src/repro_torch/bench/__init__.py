"""Benchmark models of the port (the counterpart of ``benchmarks/models.py``)."""
