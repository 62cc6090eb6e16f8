#!/usr/bin/env python3
"""How far a model's own results move when its row-parallel sums are
reassociated: the noise floor a placed run is held against.

Usage (PYTHONPATH=src; on the CPU, or on the card without ``--device``):

    python3 tools/reassociation_noise.py --arch xlstm-125m \
        [--dtype float32] [--batch 4] [--seq 32] [--parts 2] \
        [--device cpu]

Runs ``--arch`` at full width on one device, plainly, twice from the
same parameters (a fixed seed) and tokens: once as it is, once with
every product by a weight the sharding rules split row-parallel (its
input rows over the model axis: ``wo``, mLSTM's ``w_down``,
``out_proj``) summed as ``--parts`` float32 partial products over equal
slices of its input rows and rounded once to the compute dtype, as a
model axis of ``--parts`` sums them. Prints, relative to the plain run:
the loss of a train step's forward, the largest gradient leaf's error
over its largest magnitude (remat "dots"), and the logits of a (batch,
seq) prefill and two decode steps (float32 caches), each over their
largest magnitude. A placed run cannot be held closer to the plain one
than these.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import Mesh
from repro_torch.models import model as lm
from repro_torch.train.train_step import remat_loss_fn, value_and_grad


def rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def run(cfg, params, toks, device):
    """(loss, gradient leaves, [prefill, decode, decode] logits)."""
    s = toks.shape[1] - 3
    batch = {"tokens": toks[:, :s], "labels": toks[:, 1:s + 1]}
    loss, grads = value_and_grad(remat_loss_fn(cfg, "dots"), params, batch)
    caches = lm.init_caches(cfg, toks.shape[0], s + 2, dtype=torch.float32,
                            device=device)
    logits = []
    for lo, hi in ((0, s), (s, s + 1), (s + 1, s + 2)):
        with torch.no_grad():
            lg, caches = lm.forward(cfg, params, {"tokens": toks[:, lo:hi]},
                                    caches)
        logits.append(lg)
    return loss, lm.tree_leaves(grads), logits


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--parts", type=int, default=2)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    device = torch.device(args.device or "cuda")
    cfg = dataclasses.replace(get_config(args.arch),
                              compute_dtype=args.dtype)
    params = lm.init_params(cfg, torch.Generator(device=device)
                            .manual_seed(0))
    toks = torch.tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (args.batch, args.seq + 3)), device=device)
    rows = row_parallel_shapes(params, args.parts)

    plain = run(cfg, params, toks, device)
    matmul = torch.Tensor.__matmul__

    def reassociated(a, b):
        if b.ndim != 2 or tuple(b.shape) not in rows:
            return matmul(a, b)
        n = b.shape[0] // args.parts
        out = sum(matmul(a[..., i * n:(i + 1) * n].float(),
                         b[i * n:(i + 1) * n].float())
                  for i in range(args.parts))
        return out.to(torch.promote_types(a.dtype, b.dtype))
    torch.Tensor.__matmul__ = reassociated
    try:
        moved = run(cfg, params, toks, device)
    finally:
        torch.Tensor.__matmul__ = matmul
    out = {"arch": args.arch, "dtype": args.dtype, "parts": args.parts,
           "device": str(device), "row_parallel_shapes": sorted(rows),
           "loss": abs(float(moved[0]) - float(plain[0]))
           / abs(float(plain[0])),
           "grad": max(rel(a, b) for a, b in zip(moved[1], plain[1])),
           "logits": [rel(a, b) for a, b in zip(moved[2], plain[2])]}
    print(json.dumps(out))
    return out


def row_parallel_shapes(params, parts: int) -> set:
    """The (rows, columns) of each weight whose spec under the rules, on a
    (1, ``parts``) mesh, splits its input rows over the model axis (the
    embedding's vocabulary split is a lookup, not a product)."""
    devs = np.empty(parts, dtype=object)
    devs[:] = [torch.device("meta")] * parts
    mesh = Mesh(devs.reshape(1, parts), ("data", "model"))
    rows = set()

    def add(path, t):
        spec = sharding.param_spec(sharding.path_str(path), tuple(t.shape),
                                   mesh)
        if t.ndim >= 2 and spec[-2] == "model" and path[-1] != "embed":
            rows.add(tuple(t.shape[-2:]))
    sharding.map_with_path(add, params)
    return rows


if __name__ == "__main__":
    main()
