"""Three-term roofline bounds on NVIDIA H100s (SXM, data-sheet rates).

    compute     t = operations / peak operation rate of their type
    memory      t = bytes moved / HBM bandwidth
    collective  t = wire bytes a device / link rate of the group

A port of ``model_flops``, ``kernel_roofline`` and ``analyze_cell`` from
``repro.roofline.analysis``, with the H100's rates in place of the
TPU v5e's. ``analyze_cell`` reads what ``launch.dryrun.lower_cell``
counted over runs of a step on meta tensors, not a compiled artefact:
FLOPs and bytes from the unplaced run, the collectives from the run
placed on the mesh (``launch.dryrun.CollectiveCounter``, priced in the
reference's ring model). The reference's reader of the optimized HLO
text for bytes (``major_bytes``) has no counterpart. A group inside one
8-GPU node moves its bytes at NVLink 4's 450 GB/s a direction
(``NVLINK_BW``), a group that spans nodes at one 400 Gb/s NIC a GPU,
50 GB/s (``NIC_BW``).
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
H100_HBM_BYTES = 80 * 10 ** 9    # the data sheet's 80 GB of HBM3
NVLINK_BW = 450e9                # NVLink 4, bytes/s a direction
NIC_BW = 50e9                    # one 400 Gb/s NIC a GPU, bytes/s
GPUS_PER_NODE = 8                # an HGX H100 node

__all__ = ["H100_HBM_BW", "H100_BF16_FLOPS", "H100_TF32_FLOPS",
           "H100_3XTF32_FLOPS", "H100_FP32_FLOPS", "H100_HBM_BYTES",
           "NVLINK_BW", "NIC_BW", "GPUS_PER_NODE", "analyze_cell",
           "model_flops", "kernel_roofline"]


def analyze_cell(cost: Dict, meta: Dict) -> Dict:
    """The roofline record of one dry-run cell, from the global counts of
    ``lower_cell``'s step run (``cost``: ``"flops"`` and ``"bytes
    accessed"``) and its ``meta`` (``"n_devices"``, and ``"collectives"``:
    the placed run's ``CollectiveCounter.summary()`` with its seconds, or
    the op that refused placement).

    ``flops_per_device`` and ``bytes_per_device`` are the global counts
    split evenly over the mesh's devices; XLA's figures in the reference
    are those of the partitioned module, which may differ from an even
    split. Compute runs at the bf16 tensor-core rate (the steps compute in
    bfloat16), memory at the HBM rate. ``collective_bytes_per_device`` is
    the wire bytes of one device's collectives and ``t_collective`` their
    time at each group's link rate; both are None, and
    ``collective_detail`` names the op, where the cell could not be
    placed."""
    n_dev = max(int(meta.get("n_devices", 1)), 1)
    flops_dev = float(cost.get("flops", 0.0)) / n_dev
    bytes_dev = float(cost.get("bytes accessed", 0.0)) / n_dev
    t_compute = flops_dev / H100_BF16_FLOPS
    t_memory = bytes_dev / H100_HBM_BW
    coll = meta.get("collectives") or {"refused": "not counted"}
    if "refused" in coll:
        wire, t_coll, detail = None, None, dict(coll)
    else:
        wire, t_coll = float(coll["bytes"]), float(coll["time_s"])
        detail = {k: coll[k] for k in ("bytes_by_op", "counts", "by_axis",
                                       "by_axis_s")}
    terms = {"compute": t_compute, "memory": t_memory}
    if t_coll is not None:
        terms["collective"] = t_coll
    t_step = max(terms.values())
    return {
        "flops_per_device": flops_dev,
        "bytes_per_device": bytes_dev,
        "collective_bytes_per_device": wire,
        "collective_detail": detail,
        "t_compute": t_compute, "t_memory": t_memory,
        "t_collective": t_coll,
        "bottleneck": max(terms, key=terms.get),
        "t_step_bound": t_step,
        "roofline_fraction": (t_compute / t_step) if t_step > 0 else 0.0,
    }


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
