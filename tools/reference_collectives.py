#!/usr/bin/env python3
"""The JAX reference's collective bytes for one dry-run cell, on the CPU.

Usage (on the CPU, where the JAX package is installed):

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/reference_collectives.py

Lowers and compiles the reference's train step (``repro.launch.dryrun
.lower_cell``, remat "dots") of qwen3-0.6b's reduced config at the widths
``tests/test_torch_launch.py``'s closed form uses (d_model 256, head dim
64, d_ff 256; batch 4 x 16 tokens) on a (2, 2) ``jax.sharding.Mesh`` of
four forced host devices, and prints the collectives its partitioned HLO
holds as ``repro.roofline.analysis.analyze_cell`` reads them (wire bytes a
device in the ring model, by op, and the op counts) beside the port's
count of the same cell (``repro_torch.launch.dryrun.lower_cell`` on a
fake process group). XLA chooses its own collectives, so the two are
compared in PERF.md, not asserted. Runs on the CPU only; the card never
runs the reference.
"""
from __future__ import annotations

import dataclasses
import json
import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"


def main() -> int:
    import jax
    import numpy as np
    import torch
    from jax.sharding import Mesh as JaxMesh

    jax.devices()
    from repro.configs import SHAPES as REF_SHAPES
    from repro.configs import get_config as ref_config
    from repro.configs.base import ShapeConfig as RefShape
    from repro.launch import dryrun as ref_dryrun
    from repro.roofline.analysis import analyze_cell as ref_analyze
    from repro_torch.configs import SHAPES, ShapeConfig, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh

    widths = dict(d_model=256, head_dim=64, d_ff=256)
    REF_SHAPES["tiny_train"] = RefShape("tiny_train", 16, 4, "train")
    SHAPES["tiny_train"] = ShapeConfig("tiny_train", 16, 4, "train")
    mesh = JaxMesh(np.asarray(jax.devices()).reshape(2, 2),
                   ("data", "model"))
    _, compiled, meta = ref_dryrun.lower_cell(
        "qwen3-0.6b", "tiny_train", mesh=mesh, cfg_override=dataclasses
        .replace(ref_config("qwen3-0.6b", reduced=True), **widths))
    ref = ref_analyze(compiled, meta)
    devs = np.empty(4, dtype=object)
    devs[:] = [torch.device("meta")] * 4
    _, port = dryrun.lower_cell(
        "qwen3-0.6b", "tiny_train", mesh=Mesh(devs.reshape(2, 2),
                                              ("data", "model")),
        cfg_override=dataclasses.replace(
            get_config("qwen3-0.6b", reduced=True), **widths))
    coll = port["collectives"]
    print(json.dumps({
        "reference": {"bytes": ref["collective_bytes_per_device"],
                      **ref["collective_detail"]},
        "port": {"bytes": coll["bytes"], "bytes_by_op": coll["bytes_by_op"],
                 "counts": coll["counts"]}}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
