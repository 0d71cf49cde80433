"""PyTorch/CUDA port of the BanaServe reproduction (``src/repro`` is the
JAX reference it is held against).

Mirrors ``repro``'s module layout.  Imports torch and numpy, never jax
and nothing of ``repro``.  The attention kernels of the serving path are
hand-written CUDA for the H100 (``kernels/csrc``), built with nvcc at
first use.
"""
