"""Two-term roofline bounds on one NVIDIA H100 (SXM, data-sheet rates).

    compute  t = operations / peak operation rate of their type
    memory   t = bytes moved / HBM bandwidth

A port of ``model_flops`` and ``kernel_roofline`` from
``repro.roofline.analysis``, with the H100's rates in place of the
TPU v5e's. The reference's readers of a compiled JAX artefact
(``analyze_cell``, ``collective_bytes``) have no counterpart here.
Which rate a kernel's operations run at is the caller's choice:
``H100_BF16_FLOPS`` for bfloat16 products on the tensor cores,
``H100_3XTF32_FLOPS`` for float32 products as three TF32 passes (what
keeps float32 tolerances), ``H100_FP32_FLOPS`` for anything else.
"""
from __future__ import annotations

from typing import Dict

H100_HBM_BW = 3.35e12            # bytes/s
H100_BF16_FLOPS = 989e12         # dense bf16 on the tensor cores
H100_TF32_FLOPS = 495e12         # dense TF32 on the tensor cores
H100_3XTF32_FLOPS = H100_TF32_FLOPS / 3
H100_FP32_FLOPS = 67e12          # float32 outside the tensor cores

__all__ = ["H100_HBM_BW", "H100_BF16_FLOPS", "H100_TF32_FLOPS",
           "H100_3XTF32_FLOPS", "H100_FP32_FLOPS", "model_flops",
           "kernel_roofline"]


def model_flops(n_params_active: int, tokens: int, kind: str) -> float:
    """MODEL_FLOPS: 6*N*D for a train step; 2*N*D for inference."""
    factor = 6.0 if kind == "train" else 2.0
    return factor * n_params_active * tokens


def kernel_roofline(flops: float, bytes_moved: float, *,
                    peak_flops: float = H100_BF16_FLOPS,
                    hbm_bw: float = H100_HBM_BW) -> Dict[str, float]:
    """Two-term roofline bound for ONE kernel invocation, from the
    algorithmic counts of its launch shape: the operations it must do and
    the bytes it must move (each input read once, each output written
    once).

    >>> r = kernel_roofline(2e9, 1e6)
    >>> r["bound"], round(r["intensity"])
    ('compute', 2000)
    """
    compute_s = flops / peak_flops
    memory_s = bytes_moved / hbm_bw
    t = max(compute_s, memory_s)
    attainable = flops / t if t > 0 else 0.0
    return {
        "flops": float(flops), "bytes": float(bytes_moved),
        "intensity": (flops / bytes_moved) if bytes_moved
        else float("inf"),
        "t_compute": compute_s, "t_memory": memory_s,
        "bound": "compute" if compute_s >= memory_s else "memory",
        "attainable_flops": attainable,
        "peak_fraction": attainable / peak_flops,
    }
