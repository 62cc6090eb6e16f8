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
both meshes of a cell. The collectives do: each cell's step runs a
second time for each mesh, placed by the sharding rules as DTensors over
a fake process group of the mesh's size in this process, under
``CollectiveCounter`` (``count_collectives``); ``analysis.analyze_cell``
prices them. Memory per device comes from the port's sharding
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
import re
import sys
import time
import traceback
from typing import Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from ..configs import SHAPES, get_config, list_archs, supports_shape
from ..configs.base import ModelConfig, ShapeConfig
from ..distributed import sharding as shd
from ..distributed.sharding import (batch_shardings, cache_shardings,
                                    map_with_path, params_shardings,
                                    spec_placements)
from ..models.model import tree_map
from ..roofline.analysis import (GPUS_PER_NODE, H100_HBM_BYTES, NIC_BW,
                                 NVLINK_BW, analyze_cell, model_flops)
from ..train.optimizer import AdamWConfig
from ..train.train_step import (make_prefill_step, make_serve_step,
                                make_train_step)
from .mesh import Mesh, make_production_mesh
from .specs import input_specs

__all__ = ["ByteCounter", "CollectiveCounter", "wire_bytes", "count_step",
           "count_collectives", "lower_cell", "run_cell",
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


# the c10d functional collectives, by op name, as the reference's HLO
# names them
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all"}


def wire_bytes(op: str, size: int, g: int) -> float:
    """The bytes one device sends for a collective over ``g`` devices whose
    output holds ``size`` bytes on it, in the ring model of the
    reference's ``collective_bytes``: all-reduce 2·S·(g−1)/g, all-gather
    S_out·(g−1)/g, reduce-scatter S_out·(g−1), all-to-all S·(g−1)/g."""
    if op == "all-reduce":
        return 2.0 * size * (g - 1) / g
    if op == "reduce-scatter":
        return float(size * (g - 1))
    return size * (g - 1) / g


class CollectiveCounter(TorchDispatchMode):
    """Records every ``c10d_functional`` collective that runs under it (the
    ones DTensor issues as it redistributes, implicit ones included) and
    DTensor's own all-to-all on CUDA meshes (``_dtensor.shard_dim_alltoall``):
    in ``records`` a tuple (op, mesh axis, group size, output bytes on this
    process) a call, the axis named from ``device_mesh``'s groups (None
    for a group that is no single mesh axis). Any other ``c10d`` or
    ``_dtensor`` op is recorded unpriced, as ``"c10d.<name>"`` or
    ``"_dtensor.<name>"``. ``summary()`` prices the records with
    ``wire_bytes``."""

    def __init__(self, device_mesh=None):
        super().__init__()
        self.records = []
        self._axes = {}
        if device_mesh is not None:
            for i, name in enumerate(device_mesh.mesh_dim_names or ()):
                self._axes[device_mesh.get_group(i).group_name] = name

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **(kwargs or {}))
        if any(t is DTensor for t in types):
            # let DTensor run and desugar into local ops and collectives,
            # which come back through this mode
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        ns, name = func.namespace, func.overloadpacket.__name__
        if (ns == "_c10d_functional" and name in _COLLECTIVES) or (
                ns == "_dtensor" and name == "shard_dim_alltoall"):
            group = next(a for a in reversed(args) if isinstance(a, str))
            g = torch.distributed.distributed_c10d._resolve_process_group(
                group).size()
            nbytes = sum(t.numel() * t.element_size()
                         for t in _tensors(out))
            self.records.append((_COLLECTIVES.get(name, "all-to-all"),
                                 self._axes.get(group), int(g), int(nbytes)))
        elif ns in ("c10d", "_dtensor"):
            self.records.append((f"{ns}.{name}", None, 0, 0))
        return out

    def summary(self) -> Dict:
        """``{"bytes": the wire bytes a device, "bytes_by_op": {op: wire
        bytes}, "counts": {op: calls}, "by_axis": {"op@axis": {"calls",
        "bytes" (output bytes), "wire"}}}``."""
        total, by_op, counts, by_axis = 0.0, {}, {}, {}
        for op, axis, g, nbytes in self.records:
            wire = wire_bytes(op, nbytes, g) if g else 0.0
            total += wire
            by_op[op] = by_op.get(op, 0.0) + wire
            counts[op] = counts.get(op, 0) + 1
            row = by_axis.setdefault(f"{op}@{axis or f'group of {g}'}",
                                     {"calls": 0, "bytes": 0, "wire": 0.0})
            row["calls"] += 1
            row["bytes"] += nbytes
            row["wire"] += wire
        return {"bytes": total, "bytes_by_op": by_op, "counts": counts,
                "by_axis": by_axis}


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


def _placed_meta(tree, shardings, mesh):
    """``tree``'s meta tensors as DTensors on ``mesh.device_mesh`` by
    ``shardings`` (a tree of specs of ``tree``'s structure), each process's
    shard a meta tensor of its local shape."""
    dm = mesh.device_mesh

    def put(path, t):
        spec = shardings
        for k in path:
            spec = spec[k]
        pl = spec_placements(spec, mesh)
        local = list(t.shape)
        for i, p in enumerate(pl):
            if p.is_shard():
                local[p.dim] //= dm.size(i)
        return DTensor.from_local(
            torch.empty(local, dtype=t.dtype, device="meta"), dm, pl,
            run_check=False, shape=t.shape, stride=t.stride())
    return map_with_path(put, tree)


def _refused_op(exc: Exception) -> str:
    """The op named in a refusal's message (DTensor names the aten op it
    has no rule for), else the message's first line."""
    text = str(exc)
    m = re.search(r"aten\.[A-Za-z0-9_]+(\.[A-Za-z0-9_]+)?", text)
    first = text.strip().splitlines()[0] if text.strip() else ""
    return m.group(0) if m else f"{type(exc).__name__}: {first[:200]}"


def count_collectives(cfg: ModelConfig, shape: ShapeConfig, remat: str,
                      n_micro: int, compress_grads: bool,
                      mesh_shape: Tuple[int, ...],
                      axis_names: Tuple[str, ...]) -> Dict:
    """The collectives of one cell's step placed on a mesh of
    ``mesh_shape``: the step run again on meta tensors placed as DTensors
    by the sharding rules over a ``"fake"`` process group of that many
    ranks in this process (its collectives move nothing), the activation
    policy on, under ``CollectiveCounter``. The ``DeviceMesh`` is a CUDA
    one (no device is touched) where torch is built for CUDA; a CPU-only
    build takes a CPU mesh, on which DTensor turns its own all-to-alls
    into an all-gather and a local chunk (the MoE dispatch issues its
    all-to-all itself, counted as one on both).
    Returns the summary with the seconds at each group's link rate
    (``"time_s"``, ``"by_axis_s"``), or ``{"refused": op, "error":
    message}`` where the placed step fails."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    n = int(np.prod(mesh_shape))
    if dist.is_initialized():
        return {"refused": "init_process_group",
                "error": "a process group is already initialized"}
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    old_policy = shd._ACT_POLICY
    try:
        # a CUDA mesh, as on the cards, where torch is built for CUDA
        # (DTensor's collectives depend on the device type: a CPU mesh
        # gathers where a CUDA one exchanges all to all, and a CPU-only
        # build cannot propagate some ops' shardings on a CUDA mesh)
        dm = init_device_mesh(
            "cuda" if torch.backends.cuda.is_built() else "cpu", mesh_shape,
            mesh_dim_names=axis_names)
        devs = np.empty(n, dtype=object)
        devs[:] = [torch.device("meta")] * n
        mesh = Mesh(devs.reshape(mesh_shape), axis_names, dm)
        shd.set_activation_policy(mesh)
        opt = AdamWConfig()
        specs = input_specs(cfg, shape, opt)
        batch = specs["batch"]
        b_sh = (tree_map(lambda a: (None,) * a.ndim, batch)
                if shape.global_batch == 1 else batch_shardings(mesh, batch))
        args = [_placed_meta(specs["params"], params_shardings(
            specs["params"], mesh), mesh)]
        if shape.kind == "train":
            step = make_train_step(cfg, opt, remat=remat, n_micro=n_micro,
                                   compress_grads=compress_grads)
            args.append(_placed_meta(specs["opt_state"], params_shardings(
                specs["opt_state"], mesh), mesh))
        else:
            step = (make_serve_step(cfg) if shape.kind == "decode"
                    else make_prefill_step(cfg))
            args.append(_placed_meta(specs["caches"], cache_shardings(
                mesh, specs["caches"], shape.global_batch > 1), mesh))
        args.append(_placed_meta(batch, b_sh, mesh))
        counter = CollectiveCounter(dm)
        try:
            with counter:
                step(*args)
        except Exception as e:  # noqa: BLE001 - the cell records it
            return {"refused": _refused_op(e), "error": str(e)[:2000]}
        out = counter.summary()
        out["time_s"], out["by_axis_s"] = _collective_time(
            out["by_axis"], dict(zip(axis_names, mesh_shape)))
        return out
    finally:
        shd._ACT_POLICY = old_policy
        dist.destroy_process_group()


def _node_local(mesh_shape: Dict[str, int], axis: str,
                per_node: int = GPUS_PER_NODE) -> bool:
    """Whether every group of the mesh axis ``axis`` lies inside one node
    of ``per_node`` GPUs, ranks numbered row-major over the mesh."""
    names = list(mesh_shape)
    ranks = np.arange(int(np.prod(list(mesh_shape.values())))).reshape(
        tuple(mesh_shape.values()))
    groups = np.moveaxis(ranks, names.index(axis), -1).reshape(
        -1, mesh_shape[axis])
    return bool((groups.min(1) // per_node == groups.max(1)
                 // per_node).all())


def _collective_time(by_axis: Dict, mesh_shape: Dict[str, int]):
    """(seconds, {"op@axis": seconds}): each row's wire bytes over NVLink's
    rate where its axis' groups lie inside one node, else over the NIC's."""
    rows = {}
    for key, row in by_axis.items():
        axis = key.split("@", 1)[1]
        inside = axis in mesh_shape and _node_local(mesh_shape, axis)
        rows[key] = row["wire"] / (NVLINK_BW if inside else NIC_BW)
    return sum(rows.values()), rows


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
               compress_grads: bool = False, mesh=None, cfg_override=None,
               collectives: bool = True):
    """Returns (cost, meta) for one cell: ``count_step``'s cost of the
    step's run on meta tensors (global counts) and the record; with
    ``collectives``, ``meta["collectives"]`` holds the step's collectives
    placed on ``mesh``'s shape (``count_collectives``)."""
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
    if collectives:
        meta["collectives"] = count_collectives(
            cfg, shape, remat, n_micro, compress_grads,
            tuple(mesh.devices.shape), tuple(mesh.axis_names))
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
    coll = (f"{r['t_collective']:.3e}s "
            f"({r['collective_bytes_per_device']:.6e} bytes a device)"
            if r["t_collective"] is not None else
            f"none ({r['collective_detail'].get('refused', 'not counted')})")
    print(f"  roofline (H100, bf16): compute={r['t_compute']:.3e}s "
          f"memory={r['t_memory']:.3e}s collective={coll} "
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
