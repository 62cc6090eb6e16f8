"""Front end (copies of the reference's JAX-free modules) and the
PyTorch engine (``coord_ops``, ``torch_backend``)."""
