"""Hand-written Hopper kernels, their plain PyTorch versions, and the SAM
primitive dispatch table (``ops``)."""
