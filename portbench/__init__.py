"""The benchmark of the PyTorch / CUDA port (``repro_torch``).

``run.py`` runs one cell once; everything it needs beyond the port
itself lives in this folder. See ``PERF.md`` at the repository root.
"""
