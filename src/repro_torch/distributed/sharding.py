"""Sharding rules: DP/FSDP over (pod, data), TP/EP over model.

Rules are path+shape based so every architecture family shares one policy:

  * 2D projection weights (D_in, D_out): FSDP on the input axis over
    (pod, data), tensor-parallel on the output axis over model — column
    parallel for up/qkv projections, row parallel (reversed) for
    down/output projections (``_ROW_PARALLEL`` suffixes).
  * MoE expert stacks (E, D, F): expert-parallel — E over model.
  * Embeddings (V, D): vocab over model, d_model over (pod, data).
  * Per-layer stacks have a leading L axis: spec gets None prefixed.
  * Norms / small vectors: replicated.

Batch specs shard the global batch over (pod, data). The same rules drive
both meshes: (data, model) single-pod and (pod, data, model) multi-pod.

A port of ``repro.distributed.sharding``'s rules as pure functions of a
mesh's ``shape`` and ``axis_names`` (``launch.mesh.Mesh``, or any object
with those two). A spec is a tuple with one entry a dim: None, an axis
name, or a tuple of names, normalized as ``PartitionSpec`` holds them (a
tuple of one name is that name, an empty tuple None). A path is the keys
from the root joined by ``/``. ``place`` puts a tree on a mesh of one
device; placing by the specs over several devices, the activation policy
(``set_activation_policy``/``shard_activation``) and the grouped
expert-parallel dispatch wait for lanes over several devices (ROADMAP.md,
still to port #5): on one device they would change nothing.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np

from ..launch.mesh import Mesh
from ..models.model import tree_map

__all__ = ["data_axes", "path_str", "param_spec", "params_shardings",
           "batch_spec", "batch_shardings", "cache_spec", "cache_shardings",
           "map_with_path", "place"]

# parameter-name suffixes that are ROW parallel (contract model-sharded dim)
_ROW_PARALLEL = ("wo", "w_down", "out_proj")
# names that carry a leading expert axis
_EXPERT = ("w_gate", "w_up", "w_down")
_REPLICATE_SMALL = 2 ** 16
_MULTI_DEVICE = ("placement over several devices is still to port "
                 "(ROADMAP.md, #5)")

Spec = Tuple[Any, ...]


def _spec(*entries) -> Spec:
    """A spec normalized as ``PartitionSpec`` holds its entries."""
    out = []
    for e in entries:
        if isinstance(e, tuple):
            e = None if not e else (e[0] if len(e) == 1 else e)
        out.append(e)
    return tuple(out)


def data_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The mesh's data-parallel group: its ``pod`` and ``data`` axes."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def path_str(path) -> str:
    """A tree path (dict keys and list indices from the root) as text."""
    return "/".join(str(k) for k in path)


def map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over the leaves of nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def _fit_spec(spec: Spec, shape: Tuple[int, ...], mesh: Mesh) -> Spec:
    """Drop sharding on any dim the mesh axes do not divide."""
    out = []
    for dim, axes in enumerate(spec):
        if axes is None or dim >= len(shape):
            out.append(None)
            continue
        axes_t = axes if isinstance(axes, tuple) else (axes,)
        size = int(np.prod([mesh.shape[a] for a in axes_t]))
        out.append(axes if shape[dim] % size == 0 else None)
    return _spec(*out)


def param_spec(path: str, shape: Tuple[int, ...], mesh: Mesh,
               stacked: bool = True, fsdp: bool = True) -> Spec:
    """The spec of one parameter."""
    return _fit_spec(_param_spec(path, tuple(shape), mesh, stacked, fsdp),
                     tuple(shape), mesh)


def _param_spec(path: str, shape: Tuple[int, ...], mesh: Mesh,
                stacked: bool = True, fsdp: bool = True) -> Spec:
    daxes = data_axes(mesh)
    name = path.split("/")[-1]
    in_moe = "/moe/" in path or path.endswith(tuple(
        "moe/" + e for e in _EXPERT))
    nd = len(shape)
    # stacked leaves have a leading layer axis
    lead: Tuple[Optional[Any], ...] = ()
    core = shape
    if stacked and nd >= 2 and ("layers" in path or "mamba_layers" in path
                                or "mlstm_layers" in path):
        lead = (None,)
        core = shape[1:]
        nd -= 1

    if int(np.prod(shape)) < _REPLICATE_SMALL or nd == 1:
        return _spec(*(lead + (None,) * nd))

    if in_moe and nd == 3 and name in _EXPERT:
        # (E, D, F): expert-parallel on E only, never on the contraction
        # dims; when E divides model x data, spread experts across both
        for cand in (_spec(("model",) + daxes), _spec(("model", "data")),
                     _spec("model")):
            if _fit_spec(cand, core[:1], mesh) == cand:
                return _spec(*(lead + cand + (None, None)))
        return _spec(*(lead + (None, None, None)))
    if name == "embed":
        # vocab-parallel preferred; fall back for non-divisible vocabs
        for cand in (_spec("model", daxes if fsdp else None),
                     _spec(None, "model"), _spec(None, daxes)):
            if _fit_spec(cand, shape, mesh) == cand:
                return _spec(*(lead + cand))
        return _spec(*(lead + (None, None)))
    if name == "lm_head":
        return _spec(*(lead + (daxes if fsdp else None, "model")))
    if nd == 2:
        if name in _ROW_PARALLEL:
            return _spec(*(lead + ("model", daxes if fsdp else None)))
        return _spec(*(lead + (daxes if fsdp else None, "model")))
    return _spec(*(lead + (None,) * nd))


def params_shardings(params, mesh: Mesh, fsdp: bool = True):
    """The spec of every parameter, as a tree of ``params``' structure."""
    return map_with_path(lambda path, leaf: param_spec(
        path_str(path), tuple(leaf.shape), mesh, fsdp=fsdp), params)


def batch_spec(mesh: Mesh, ndim: int, seq_shard: bool = False) -> Spec:
    """Batch arrays: leading axis over (pod, data). ``seq_shard`` shards
    axis 1 (sequence) over the data group instead — used for long-context
    decode where global_batch=1 (KV/sequence parallelism)."""
    daxes = data_axes(mesh)
    if seq_shard:
        return _spec(None, daxes, *([None] * (ndim - 2)))
    return _spec(daxes, *([None] * (ndim - 1)))


def batch_shardings(mesh: Mesh, batch, seq_shard: bool = False):
    return tree_map(lambda a: batch_spec(mesh, a.ndim, seq_shard), batch)


_STACKED_CACHE_SEGS = ("layers", "dense_layers", "mlstm", "mamba")


def cache_spec(mesh: Mesh, path: str, shape: Tuple[int, ...],
               batch_sharded: bool) -> Spec:
    """KV/state caches: batch over (pod,data) when batch is shardable,
    otherwise shard the sequence axis (long_500k); heads stay replicated.
    Stacked caches carry a leading L axis (replicated)."""
    shape = tuple(shape)
    daxes = data_axes(mesh)
    segs = path.split("/")
    name = segs[-1]
    lead: Tuple = ()
    core = shape
    if any(s in _STACKED_CACHE_SEGS for s in segs[:-1]):
        lead = (None,)
        core = shape[1:]
    nd = len(core)
    if name == "pos":
        spec = _spec(*(lead + ((daxes,) if batch_sharded and nd else
                               (None,) * nd)))
    elif batch_sharded:
        # batch over (pod, data); the sequence axis of KV-shaped caches
        # additionally shards over model
        if nd >= 3:
            spec = _spec(*(lead + (daxes, "model") + (None,) * (nd - 2)))
        else:
            spec = _spec(*(lead + (daxes,) + (None,) * (nd - 1)))
    elif nd >= 2:
        # batch=1: shard the sequence axis (KV/sequence parallelism)
        spec = _spec(*(lead + (None, daxes) + (None,) * (nd - 2)))
    else:
        spec = _spec(*(lead + (None,) * nd))
    return _fit_spec(spec, shape, mesh)


def cache_shardings(mesh: Mesh, caches, batch_sharded: bool = True):
    return map_with_path(lambda path, leaf: cache_spec(
        mesh, path_str(path), tuple(leaf.shape), batch_sharded), caches)


def place(tree, mesh: Mesh):
    """``tree``'s tensors on ``mesh``: its device, for a mesh of one
    device; ``NotImplementedError`` for more."""
    if mesh.size != 1:
        raise NotImplementedError(f"a mesh of {mesh.size} devices: "
                                  f"{_MULTI_DEVICE}")
    dev = mesh.devices.reshape(-1)[0]
    return tree_map(lambda t: t.to(dev), tree)
