"""repro_torch — the PyTorch / CUDA port of ``repro`` for NVIDIA Hopper.

Mirrors ``repro``'s layout: the reference for ``repro_torch/x/y.py`` is
``repro/x/y.py``. Imports ``torch`` and numpy, never ``jax`` and nothing
of ``repro``; the framework-free modules it needs (configs, payload,
netmodel and resource monitor, the rpc fabric, the serve scheduler, the
fabric trainer) are kept as copies here.
Hand-written CUDA kernels live in ``csrc/`` and are built on first use
(``kernels/_build.py``).
"""
