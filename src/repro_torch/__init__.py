"""PyTorch/CUDA port of the serving stack, for one NVIDIA H100.

Mirrors the layout of the JAX package ``repro`` (``configs/``,
``models/``, ``kernels/<name>/``, ``serving/``, ``launch/``) and imports
nothing from it.  Hand-written CUDA kernels live in ``csrc/`` and are
built on first use (``kernels/_lib.py``).
"""
