"""Dry-run of every (architecture x input-shape x mesh) cell, reckoned on
meta tensors.

A port of ``repro.launch.dryrun``. The reference lowers and compiles
each cell's jitted step for the production meshes and reads XLA's
``cost_analysis`` and ``memory_analysis``; the port runs the cell's step
once, eagerly, on the meta tensors of ``launch.specs.input_specs`` (no
allocation, no device), under two counters:

* ``torch.utils.flop_counter.FlopCounterMode``: the FLOPs of the matrix
  products (forward, backward and rematerialized recompute);
* ``ByteCounter``: every op's input and output bytes, the counterpart of
  XLA's "bytes accessed" (views and bare allocations move nothing and
  are left out).

The counts are global, so they do not depend on the mesh: one run serves
both meshes of a cell. Memory per device comes from the port's sharding
rules over the production mesh's shape (``launch.mesh
.make_production_mesh``): each leaf's bytes divided by the product of the
mesh axes its spec names, summed over the step's arguments and, the same
way, over its outputs (outputs with no rule, a train step's metrics and a
serve step's logits, count whole). Temporaries are not reckoned
(``temp_bytes`` is None). Each cell's argument bytes are held against
the H100's 80 GB. Run as::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b \\
        --shape train_4k [--multi-pod] [--remat dots] [--json out.json]

or ``--all`` for every cell on both meshes; no GPU is needed.

``--sam`` switches to the SAM dry-run: every uniform per-tensor level
format drawn from ``autoschedule.FORMAT_CHOICES`` is lowered through
Custard AND executed on the port's engine at the given dims (on the card
unless ``--device cpu``), its result held against a numpy oracle; each
cell also records modeled cycles under every ``simulator.HW_PRESETS``
hardware model::

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --sam "x(i) = B(i,j) * c(j)" --sam-dims i=32,j=32 --json sam.json
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time
import traceback
import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from ..configs import SHAPES, get_config, list_archs, supports_shape
from ..configs.base import ModelConfig, ShapeConfig
from ..distributed.sharding import (batch_shardings, cache_shardings,
                                    params_shardings)
from ..models.model import tree_map
from ..roofline.analysis import H100_HBM_BYTES, analyze_cell, model_flops
from ..train.optimizer import AdamWConfig
from ..train.train_step import (make_prefill_step, make_serve_step,
                                make_train_step)
from .mesh import make_production_mesh
from .specs import input_specs

__all__ = ["ByteCounter", "count_step", "lower_cell", "run_cell",
           "sam_dryrun", "parse_kv", "write_json", "main"]

# ops that allocate without reading or writing an element
_ALLOCATIONS = frozenset({"empty", "empty_strided", "empty_like",
                          "new_empty", "new_empty_strided"})


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


class ByteCounter(TorchDispatchMode):
    """Adds up in ``total`` the bytes of every tensor an op reads or
    writes (its tensor inputs and outputs, each once a call), but for
    views, which alias their input, and bare allocations."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not (func.is_view
                or func.overloadpacket.__name__ in _ALLOCATIONS):
            self.total += sum(t.numel() * t.element_size()
                              for t in _tensors((args, kwargs, out)))
        return out


def count_step(step, *args):
    """(``step(*args)``, its cost): ``"flops"`` from ``FlopCounterMode``,
    ``"bytes accessed"`` from ``ByteCounter``."""
    with FlopCounterMode(display=False) as flops, ByteCounter() as nbytes:
        out = step(*args)
    return out, {"flops": int(flops.get_total_flops()),
                 "bytes accessed": int(nbytes.total)}


@functools.lru_cache(maxsize=4)
def _cell_run(cfg: ModelConfig, shape: ShapeConfig, remat: str,
              n_micro: int, compress_grads: bool):
    """(input specs, step outputs, cost) of one cell's step on meta
    tensors; the mesh plays no part, so both meshes share one run."""
    opt = AdamWConfig()
    specs = input_specs(cfg, shape, opt)
    if shape.kind == "train":
        step = make_train_step(cfg, opt, remat=remat, n_micro=n_micro,
                               compress_grads=compress_grads)
        out, cost = count_step(step, specs["params"], specs["opt_state"],
                               specs["batch"])
    else:
        step = (make_serve_step(cfg) if shape.kind == "decode"
                else make_prefill_step(cfg))
        out, cost = count_step(step, specs["params"], specs["caches"],
                               specs["batch"])
    return specs, out, cost


def _shard_factor(spec, mesh) -> int:
    n = 1
    for axes in spec:
        if axes is not None:
            for a in (axes if isinstance(axes, tuple) else (axes,)):
                n *= mesh.shape[a]
    return n


def _sharded_bytes(tree, specs, mesh) -> int:
    """Per-device bytes of ``tree`` under ``specs`` (a tree of its
    structure holding a spec a leaf; None: every leaf whole)."""
    if isinstance(tree, torch.Tensor):
        n = tree.numel() * tree.element_size()
        return n // (1 if specs is None else _shard_factor(specs, mesh))
    if isinstance(tree, dict):
        return sum(_sharded_bytes(v, None if specs is None else specs[k],
                                  mesh) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return sum(_sharded_bytes(v, None if specs is None else specs[i],
                                  mesh) for i, v in enumerate(tree))
    return 0


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               remat: str = "dots", n_micro: int = 1,
               compress_grads: bool = False, mesh=None, cfg_override=None):
    """Returns (cost, meta) for one cell: ``count_step``'s cost of the
    step's run on meta tensors (global counts) and the record."""
    cfg = cfg_override or get_config(arch)
    shape = SHAPES[shape_name]
    if not supports_shape(cfg, shape_name):
        raise ValueError(f"{arch} skips {shape_name} (full attention; "
                         f"see DESIGN.md §5)")
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    specs, out, cost = _cell_run(cfg, shape, remat, n_micro, compress_grads)
    # batch=1 cells keep the batch whole
    if shape.global_batch == 1:
        b_sh = tree_map(lambda a: (None,) * a.ndim, specs["batch"])
    else:
        b_sh = batch_shardings(mesh, specs["batch"], seq_shard=False)
    if shape.kind == "train":
        args = (specs["params"], specs["opt_state"], specs["batch"])
        arg_sh = (params_shardings(specs["params"], mesh),
                  params_shardings(specs["opt_state"], mesh), b_sh)
        new_params, new_state, metrics = out
        out_sh = (params_shardings(new_params, mesh),
                  params_shardings(new_state, mesh), None)
    else:
        batch_sharded = shape.global_batch > 1
        args = (specs["params"], specs["caches"], specs["batch"])
        arg_sh = (params_shardings(specs["params"], mesh),
                  cache_shardings(mesh, specs["caches"], batch_sharded),
                  b_sh)
        out_sh = (None, cache_shardings(mesh, out[1], batch_sharded))
    arg_bytes = _sharded_bytes(list(args), list(arg_sh), mesh)
    out_bytes = _sharded_bytes(list(out), list(out_sh), mesh)
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    mf = model_flops(cfg.n_active_params(), tokens, shape.kind)
    meta = {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "mesh": dict(mesh.shape), "n_devices": int(mesh.size),
        "remat": remat, "n_micro": n_micro,
        "compress_grads": compress_grads,
        "flops": float(cost["flops"]),
        "bytes_accessed": float(cost["bytes accessed"]),
        "model_flops": mf,
        "useful_flop_ratio": mf / cost["flops"] if cost["flops"] else 0.0,
        "mem_per_device": {
            "argument_bytes": int(arg_bytes),
            "output_bytes": int(out_bytes),
            "temp_bytes": None,          # not reckoned on meta tensors
            "hbm_bytes": H100_HBM_BYTES,
            "fits": bool(arg_bytes <= H100_HBM_BYTES),
        },
    }
    return cost, meta


def run_cell(arch, shape_name, *, multi_pod=False, remat="dots", n_micro=1,
             compress_grads=False, mesh=None):
    t0 = time.time()
    cost, meta = lower_cell(
        arch, shape_name, multi_pod=multi_pod, remat=remat, n_micro=n_micro,
        compress_grads=compress_grads, mesh=mesh)
    meta["count_s"] = time.time() - t0
    meta["roofline"] = analyze_cell(cost, meta)
    mem = meta["mem_per_device"]
    r = meta["roofline"]
    print(f"[dryrun] {arch} x {shape_name} mesh={meta['mesh']} "
          f"counted in {meta['count_s']:.1f}s")
    print(f"  memory per device: arguments {mem['argument_bytes']} bytes "
          f"({mem['argument_bytes'] / H100_HBM_BYTES:.3f} of the H100's "
          f"80 GB{'' if mem['fits'] else ': DOES NOT FIT'}), outputs "
          f"{mem['output_bytes']} bytes, temporaries not reckoned")
    print(f"  cost: flops {meta['flops']:.6e} bytes accessed "
          f"{meta['bytes_accessed']:.6e}; model flops "
          f"{meta['model_flops']:.6e} (useful ratio "
          f"{meta['useful_flop_ratio']:.3f})")
    print(f"  roofline (H100, bf16): compute={r['t_compute']:.3e}s "
          f"memory={r['t_memory']:.3e}s collective=none "
          f"bottleneck={r['bottleneck']}")
    return meta


def parse_kv(text, cast=int) -> dict:
    """``"a=1,b=2"`` -> ``{"a": cast("1"), "b": cast("2")}``."""
    return {k: cast(v) for k, v in
            (item.split("=") for item in text.split(","))} if text else {}


def write_json(path, results) -> None:
    """Write ``results`` to ``path`` through a temporary file, so a crash
    leaves the last complete list."""
    with open(path + ".tmp", "w") as f:
        json.dump(results, f, indent=1)
    os.replace(path + ".tmp", path)


def sam_dryrun(args) -> list:
    """Lower + engine-run every SAM format cell on ``args.device`` (the
    card unless ``"cpu"``), each result held against a numpy oracle;
    modeled cycles per hardware preset ride each record (incremental,
    crash-safe JSON). Returns the records."""
    from ..core.autoschedule import (_format_combos, FORMAT_CHOICES,
                                     resolve_densities, synthetic_operands)
    from ..core.coord_ops import resolve_device
    from ..core.einsum import parse
    from ..core.program import numpy_reference
    from ..core.schedule import Format, Schedule
    from ..core.simulator import HW_PRESETS, simulate_expr
    from ..core.torch_backend import execute_expr
    from ..kernels.ops import launch_counts

    device = resolve_device(args.device)
    dims = parse_kv(args.sam_dims)
    base = Format(parse_kv(args.sam_formats, cast=str))
    assign = parse(args.sam)
    densities = resolve_densities(assign, args.sam_density)
    arrays = synthetic_operands(assign, dims, densities)
    want = numpy_reference(args.sam, arrays)[assign.lhs.tensor]
    sch = Schedule(loop_order=tuple(assign.all_vars))
    results, failures = [], []
    for combo in _format_combos(assign, base, FORMAT_CHOICES):
        fmt = Format({**base.formats, **dict(combo)}, default=base.default)
        cell = {"expr": args.sam, "formats": dict(combo) or "baseline"}
        t0 = time.time()
        try:
            got = execute_expr(assign, fmt, sch, arrays, dims,
                               device=device).to_dense()
            cell["engine_nnz"] = int(np.count_nonzero(got))
            cell["equals_oracle"] = bool(np.array_equal(got, want))
            if not cell["equals_oracle"]:
                raise AssertionError(f"differs from the numpy oracle (max "
                                     f"abs err {np.abs(got - want).max()})")
            cell["cycles"] = {
                hw: int(simulate_expr(assign, fmt, sch, arrays, dims,
                                      hw=cfg).cycles)
                for hw, cfg in sorted(HW_PRESETS.items())}
            cell["compile_s"] = time.time() - t0
            print(f"[sam-dryrun] {cell['formats']}: OK "
                  f"cycles={cell['cycles']}", flush=True)
        except Exception as e:  # noqa: BLE001 - report and continue
            traceback.print_exc()
            cell["error"] = str(e)
            failures.append((cell["formats"], str(e)))
        results.append(cell)
        if args.json:
            write_json(args.json, results)
    if failures:
        print(f"[sam-dryrun] {len(failures)} FAILURES: {failures}")
        sys.exit(1)
    print(f"[sam-dryrun] all {len(results)} format cells OK on {device}")
    print("kernel launches:", json.dumps(launch_counts()))
    return results


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sam", default=None,
                    help="SAM einsum: dry-run every level-format cell")
    ap.add_argument("--sam-dims", default="")
    ap.add_argument("--sam-formats", default="")
    ap.add_argument("--sam-density", type=float, default=0.1)
    ap.add_argument("--device", default=None,
                    help="--sam's device: CUDA unless given (an error "
                         "without a GPU); the LM cells need none")
    ap.add_argument("--arch", choices=list_archs())
    ap.add_argument("--shape", choices=sorted(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--remat", default="dots",
                    choices=["none", "dots", "full"])
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    if args.sam:
        return sam_dryrun(args)

    cells = []
    if args.all:
        for arch in list_archs():
            for shape in SHAPES:
                cells.append((arch, shape))
    else:
        if not (args.arch and args.shape):
            ap.error("need --arch and --shape (or --all)")
        cells = [(args.arch, args.shape)]

    meshes = [False, True] if (args.both_meshes or args.all) \
        else [args.multi_pod]
    results, failures = [], []
    for arch, shape in cells:
        cfg = get_config(arch)
        if not supports_shape(cfg, shape):
            print(f"[dryrun] SKIP {arch} x {shape} (full attention @ 500k, "
                  f"DESIGN.md §5)")
            results.append({"arch": arch, "shape": shape, "skipped": True})
            continue
        for mp in meshes:
            try:
                results.append(run_cell(arch, shape, multi_pod=mp,
                                        remat=args.remat,
                                        n_micro=args.n_micro,
                                        compress_grads=args.compress_grads))
            except Exception as e:  # noqa: BLE001 - report and continue
                traceback.print_exc()
                failures.append((arch, shape, mp, str(e)))
                results.append({"arch": arch, "shape": shape,
                                "multi_pod": mp, "error": str(e)})
            if args.json:  # incremental, crash-safe
                write_json(args.json, results)
    if args.json:
        write_json(args.json, results)
    if failures:
        print(f"[dryrun] {len(failures)} FAILURES:")
        for f_ in failures:
            print("  ", f_)
        sys.exit(1)
    print(f"[dryrun] all {len(results)} cells OK")
    return results


if __name__ == "__main__":
    main()
