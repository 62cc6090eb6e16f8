"""PyTorch/CUDA port of the SAM reproduction in ``repro``.

``repro`` (JAX, TPU) stays the reference; this package runs the same
compiled engine on an NVIDIA Hopper GPU with its reduce kernels written by
hand in CUDA C++ (``kernels/csrc``). It imports ``torch`` and numpy only,
never ``jax`` or ``repro``.
"""
