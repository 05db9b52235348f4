"""Benchmark scripts of the PyTorch port; run each with ``python -m``."""
