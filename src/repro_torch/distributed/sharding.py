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
from the root joined by ``/``.

Placement is PyTorch's SPMD counterpart of ``jax.device_put(tree,
NamedSharding)``: one process a device under ``torch.distributed``, the
mesh's ``DeviceMesh`` over the process group, and each leaf a
``DTensor`` whose placements follow its spec (``spec_placements``: for
each mesh axis ``Shard(d)`` where the axis names tensor dim ``d``,
``Replicate()`` elsewhere). ``place`` does that on every mesh that
carries a process group, one of size 1 included, and moves plain tensors
on a mesh of one device without one. The model gathers placed
parameters where it uses them, a layer at a time. The transformer
layers' projections (MLA's and zamba2's shared block's included), the
SSM stacks' (mamba2's, mLSTM's) and the head and embedding are gathered
over the data group only (``gathered_over_data``, FSDP's all-gather):
each keeps its ``Shard`` on the ``model`` axis, so the products are
split as the reference's XLA partitions them (column-parallel
``wq``/``wk``/``wv``, MLA's ``wq_b``/``wkv_b``, ``w_gate``/``w_up`` and
head, row-parallel ``wo``, ``w_down`` and ``out_proj``, a
vocab-parallel embedding), and activations are sharded over the batch
and, between a column- and a row-parallel product, over the model axis.
Four leaves pack segments of unequal width along the split axis
(mamba2's ``in_proj`` and ``conv_w``, mLSTM's ``w_up`` and ``w_if``): a
contiguous model shard of them is not whole heads, so each shard takes
the columns of its own heads (``packed_columns``) through
``packed_product`` or, where the product runs per shard, from the
weight made whole over the model axis. A MoE block is gathered by
``gathered_but_experts``: its expert stacks not at all, so each card
keeps the experts of its ``Shard`` on the E axes (``expert_axes``:
model, and the data axes where E divides them) and the dispatch moves
the tokens to them, its router and shared experts over the data group
only. sLSTM's leaves, which the rules replicate but for its recurrent
``r``, are made whole (``gathered``, as ZeRO-3 does). The logits keep
their vocabulary split over the model axis into a vocab-parallel loss,
and a placed cache keeps its sequence split over it: a decode step reads
it there (``cache_read_path``), its collectives over the model axis
issued through ``ModelAxis``. The activation policy
(``set_activation_policy``, ``data_group_size``,
``shard_activation``) is the reference's: ``shard_activation``
redistributes a DTensor to its fitted spec's placements, and is the
identity on a plain tensor or without a policy. The model code mixes a
DTensor with the plain tensors it builds (positions, masks) inside
``spmd_region``, which takes them as replicated.
"""
from __future__ import annotations

import contextlib
from typing import Any, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import (implicit_replication,
                                                   local_map)

from ..launch.mesh import Mesh

__all__ = ["data_axes", "path_str", "param_spec", "params_shardings",
           "batch_spec", "batch_shardings", "cache_spec", "cache_shardings",
           "map_with_path", "spec_placements", "place", "gathered",
           "gathered_over_data", "gathered_but_experts", "expert_axes",
           "model_sharded", "model_coordinate",
           "whole_over_model", "reduced", "model_input", "over_model",
           "packed_columns", "packed_ranges", "pick_columns",
           "packed_path", "packed_product", "cache_read_path", "ModelAxis",
           "split_rows", "sum_over_model",
           "gather_over_model",
           "per_shard_grads",
           "full_tensors",
           "spmd_region", "set_activation_policy", "data_group_size",
           "shard_activation"]

# parameter-name suffixes that are ROW parallel (contract model-sharded dim)
_ROW_PARALLEL = ("wo", "w_down", "out_proj")
# names that carry a leading expert axis
_EXPERT = ("w_gate", "w_up", "w_down")
_REPLICATE_SMALL = 2 ** 16
_LAUNCH = ("placing on a mesh of {n} devices takes one process a device "
           "under torch.distributed: launch with `python -m "
           "torch.distributed.run --standalone --nproc-per-node {n} -m "
           "repro_torch.launch.train ...` and build the mesh with "
           "launch.mesh.make_host_mesh")

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
    return map_with_path(lambda _, a: batch_spec(mesh, a.ndim, seq_shard),
                         batch)


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


def spec_placements(spec: Spec, mesh: Mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh``, one a mesh axis:
    ``Shard(d)`` where the axis appears in tensor dim ``d``'s entry (a
    tuple of axes on one dim shards that dim over each of them),
    ``Replicate()`` where it appears in none, and on an axis of size 1
    (one shard is the whole, and DTensor propagates a replicated layout
    through every op; a sharded one it refuses through some reshapes)."""
    out = []
    for axis in mesh.axis_names:
        p = Replicate()
        for d, e in enumerate(spec):
            if mesh.shape[axis] > 1 and (
                    e == axis or (isinstance(e, tuple) and axis in e)):
                p = Shard(d)
        out.append(p)
    return out


def _mesh_device(mesh: Mesh) -> torch.device:
    return mesh.devices.reshape(-1)[0]


def _check_placeable(mesh: Mesh) -> None:
    if mesh.device_mesh is None and (
            mesh.size != 1 or _mesh_device(mesh).type == "meta"):
        raise ValueError(_LAUNCH.format(n=mesh.size))


def _local_device(dm) -> torch.device:
    """This process's device of the ``DeviceMesh`` ``dm``."""
    if dm.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(dm.device_type)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def place(tree, mesh: Mesh, shardings=None):
    """``tree``'s tensors on ``mesh`` by ``shardings`` (a tree of specs of
    ``tree``'s structure; ``params_shardings(tree, mesh)`` by default):
    each leaf a DTensor with its spec's placements where the mesh carries
    a process group's ``DeviceMesh`` (at any size; every process passes
    the same values, and each keeps its shards), the one device's plain
    tensors on a mesh of one device without one. ``ValueError`` for meta
    devices or a mesh of several devices without a process group."""
    _check_placeable(mesh)
    dm = mesh.device_mesh
    if dm is None:
        dev = _mesh_device(mesh)
        return map_with_path(lambda _, t: t.to(dev), tree)
    if shardings is None:
        shardings = params_shardings(tree, mesh)
    local = _local_device(dm)

    def put(path, t):
        if isinstance(t, DTensor):
            t = t.full_tensor()
        return distribute_tensor(t.detach().to(local), dm, spec_placements(
            _at(shardings, path), mesh))
    return map_with_path(put, tree)


def gathered(tree):
    """``tree`` with each DTensor leaf replicated on every mesh axis (an
    all-gather of its shards; its gradient goes back to the shards as a
    reduce-scatter); plain leaves as they are."""
    return map_with_path(lambda _, t: t.redistribute(
        t.device_mesh, [Replicate()] * t.device_mesh.ndim)
        if isinstance(t, DTensor) else t, tree)


def _replicated_on(t, axes):
    """A DTensor ``t`` replicated on the mesh axes named in ``axes``, its
    other placements kept; a plain tensor as it is."""
    if not isinstance(t, DTensor):
        return t
    names = t.device_mesh.mesh_dim_names or ()
    pl = [Replicate() if n in axes else p
          for n, p in zip(names, t.placements)]
    return t if tuple(pl) == tuple(t.placements) else t.redistribute(
        t.device_mesh, pl)


def gathered_over_data(tree):
    """``tree`` with each DTensor leaf replicated on the ``pod`` and
    ``data`` axes only (FSDP's all-gather; the gradient goes back as a
    reduce-scatter over the data group), its ``Shard`` on ``model`` kept;
    plain leaves as they are."""
    return map_with_path(lambda _, t: _replicated_on(t, ("pod", "data")),
                         tree)


def expert_axes(spec: Spec) -> Tuple[str, ...]:
    """The mesh axes that split the E axis of an expert stack (``(E, D,
    F)``, or ``(L, E, D, F)`` stacked) whose spec is ``spec``, in the
    spec's order; () where the experts are whole. The rules' one answer
    for the experts' placements and the dispatch buffers' alike."""
    e = spec[-3] if len(spec) >= 3 else None
    return () if e is None else (e if isinstance(e, tuple) else (e,))


def _expert_stack(path, t) -> bool:
    """Whether the leaf at ``path`` of a MoE block is a stack of routed
    experts (not a shared expert's matrix)."""
    return (bool(path) and str(path[-1]) in _EXPERT and t.ndim == 3
            and "shared" not in map(str, path))


def gathered_but_experts(tree):
    """A MoE block's placed parameters where they are used: its expert
    stacks as they are (each card keeps its ``Shard`` of the experts on
    every mesh axis, the data axes' included: the dispatch moves the
    tokens to them), every other leaf (the router, the shared experts)
    gathered over the data group only (``gathered_over_data``)."""
    return map_with_path(lambda path, t: t if _expert_stack(path, t)
                         else _replicated_on(t, ("pod", "data")), tree)


def whole_over_model(t):
    """A DTensor ``t`` replicated on the ``model`` axis as well (an
    all-gather over it where ``t`` is sharded there); a plain tensor as it
    is."""
    return _replicated_on(t, ("model",))


def _model_dim(t):
    names = t.device_mesh.mesh_dim_names or ()
    return names.index("model") if "model" in names else None


def model_sharded(t, dim: int) -> bool:
    """Whether ``t`` is a DTensor split on tensor dim ``dim`` over a
    ``model`` axis of more than one device."""
    if not isinstance(t, DTensor):
        return False
    i = _model_dim(t)
    if i is None or t.device_mesh.size(i) == 1:
        return False
    p = t.placements[i]
    return p.is_shard() and p.dim in (dim, dim + t.ndim)


def model_coordinate(t) -> Tuple[int, int]:
    """(this process's index on the ``model`` axis of DTensor ``t``'s mesh,
    the axis' size)."""
    i = _model_dim(t)
    return t.device_mesh.get_local_rank(i), t.device_mesh.size(i)


def _all_reduce(x, op: str, group_name: str):
    """``x`` reduced elementwise by ``op`` over one process group."""
    ops = torch.ops._c10d_functional
    return ops.wait_tensor(ops.all_reduce(x.contiguous(), op, group_name))


def _all_gather(x, dim: int, group_name: str, size: int):
    """The shards ``x`` of one process group of ``size`` concatenated
    along ``dim`` in rank order."""
    ops = torch.ops._c10d_functional
    return ops.wait_tensor(ops.all_gather_into_tensor(
        x.movedim(dim, 0).contiguous(), size, group_name)).movedim(0, dim)


class _SumOverGroup(torch.autograd.Function):
    """The all-reduce (sum) of a local tensor over one process group, whose
    backward is the identity: each shard's partial term receives the whole
    gradient of the sum (Megatron's ``g``; DTensor's own redistribution
    would hand back a partial gradient and gather the activations of the
    next product to use it)."""

    @staticmethod
    def forward(ctx, x, group_name):
        return _all_reduce(x, "sum", group_name)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _AllSum(torch.autograd.Function):
    """The all-reduce (sum) of a local tensor over one process group whose
    backward all-reduces the gradient too: every shard uses the sum, so
    each shard's term gets the sum of their gradients."""

    @staticmethod
    def forward(ctx, x, group_name):
        ctx.group_name = group_name
        return _all_reduce(x, "sum", group_name)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, "sum", ctx.group_name), None


class _GatherOverGroup(torch.autograd.Function):
    """The all-gather of a local tensor's shards along ``dim`` over one
    process group of ``size``, in rank order; its backward is the
    reduce-scatter (sum) of the gradient back to the shards."""

    @staticmethod
    def forward(ctx, x, dim, group_name, size):
        ctx.args = (dim, group_name, size)
        return _all_gather(x, dim, group_name, size)

    @staticmethod
    def backward(ctx, grad):
        dim, group_name, size = ctx.args
        ops = torch.ops._c10d_functional
        return ops.wait_tensor(ops.reduce_scatter_tensor(
            grad.movedim(dim, 0).contiguous(), "sum", size,
            group_name)).movedim(0, dim), None, None, None


def gather_over_model(local, device_mesh, dim: int):
    """The local shard ``local`` of a tensor split on ``dim`` over the
    ``model`` axis of ``device_mesh`` made whole (inside ``local_map``):
    one all-gather, and a reduce-scatter of the gradient on its way back.
    Unlike ``whole_over_model`` before a ``local_map``, the gradient leaves
    with its ``Partial`` sums on the data axes intact, so FSDP's
    reduce-scatter over them follows (DTensor would all-reduce the whole
    gradient over the data axes first)."""
    i = device_mesh.mesh_dim_names.index("model")
    return _GatherOverGroup.apply(local, dim, device_mesh.get_group(i)
                                  .group_name, device_mesh.size(i))


def sum_over_model(local, device_mesh):
    """The sum of the local tensor ``local`` over the ``model`` axis of
    ``device_mesh`` (inside ``local_map``): one all-reduce, and one more
    of the gradient on its way back."""
    i = device_mesh.mesh_dim_names.index("model")
    return _AllSum.apply(local, device_mesh.get_group(i).group_name)


def reduced(t):
    """A DTensor ``t`` with each ``Partial`` placement (the sum a
    row-parallel or vocab-parallel product leaves over the model axis)
    made ``Replicate``: one all-reduce a partial mesh axis, whose gradient
    passes back unreduced; a plain tensor as it is."""
    if not isinstance(t, DTensor) or not any(p.is_partial()
                                             for p in t.placements):
        return t
    mesh = t.device_mesh
    out_pl = [Replicate() if p.is_partial() else p for p in t.placements]
    local = t.to_local(grad_placements=out_pl)
    for i, p in enumerate(t.placements):
        if p.is_partial():
            local = _SumOverGroup.apply(local, mesh.get_group(i).group_name)
    return DTensor.from_local(local, mesh, out_pl, run_check=False,
                              shape=t.shape, stride=t.stride())


def model_input(t):
    """Megatron's ``f`` at the input of column-parallel products: the
    identity on DTensor ``t``, whose gradient (the products' input
    gradients, a partial sum over the model axis) is all-reduced in
    ``t``'s dtype on its way back; a plain tensor as it is."""
    if not isinstance(t, DTensor) or _model_dim(t) is None:
        return t
    return DTensor.from_local(t.to_local(grad_placements=t.placements),
                              t.device_mesh, t.placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def over_model(t, placement) -> list:
    """DTensor ``t``'s placements with the ``model`` axis' replaced by
    ``placement``."""
    i = _model_dim(t)
    return [placement if j == i else p for j, p in enumerate(t.placements)]


def packed_ranges(widths, heads, rank: int, size: int) -> list:
    """The column ranges ``[(lo, hi), ...]`` of a packed leaf that model
    shard ``rank`` of ``size`` needs for its own heads. The leaf packs
    segments of ``widths`` side by side; ``heads[i]`` is the number of
    heads segment ``i`` is cut into (the shard takes heads ``rank·h/size``
    to ``(rank+1)·h/size``), or None for a segment every shard needs
    whole (mamba2's ``B`` and ``C``, read by every head of their group,
    and mLSTM's ``xi``, the input of the column-parallel ``wq``/``wk``/
    ``wv``). Adjacent ranges are merged."""
    out, start = [], 0
    for w, h in zip(widths, heads):
        if h is None:
            lo, hi = start, start + w
        else:
            if h % size or w % h:
                raise ValueError(f"a segment of {w} columns in {h} heads "
                                 f"does not split over {size} shards")
            per = w // size
            lo, hi = start + rank * per, start + (rank + 1) * per
        if out and out[-1][1] == lo:
            out[-1] = (out[-1][0], hi)
        else:
            out.append((lo, hi))
        start += w
    return out


def packed_columns(widths, heads, rank: int, size: int) -> np.ndarray:
    """The column indices of ``packed_ranges``, in order."""
    return np.concatenate([np.arange(lo, hi) for lo, hi in packed_ranges(
        widths, heads, rank, size)])


def pick_columns(t, ranges):
    """``t``'s last-dim columns in ``ranges`` (``packed_ranges``), side by
    side."""
    if len(ranges) == 1 and ranges[0] == (0, t.shape[-1]):
        return t
    return torch.cat([t[..., lo:hi] for lo, hi in ranges], dim=-1)


def packed_path(d_in: int, tokens: int, weight_itemsize: int,
                act_itemsize: int) -> str:
    """Which all-gather over the model axis ``packed_product`` takes:
    ``"weight"``, the packed (``d_in``, columns) weight made whole, where
    that moves no more bytes than ``"activation"``, the product's output
    of ``tokens`` rows (this data shard's) over the same columns. Both
    gather every column and both gradients go back as a reduce-scatter of
    the same size, so the rule is ``d_in · weight_itemsize <= tokens ·
    act_itemsize``: the weight at a train step's tokens, the activation
    at a decode step's."""
    return ("weight" if d_in * weight_itemsize <= tokens * act_itemsize
            else "activation")


def cache_read_path(cache_bytes: int, step_bytes: int) -> str:
    """Which way a step reads a placed cache whose sequence is split over
    the model axis (the rules' ``cache_spec``). ``"sequence"``: each card
    writes the step's new rows that fall in its own sequence range and
    scores the step's queries, every head's, against its own rows; the
    float32 partial results (a head's output, row max and sum) are merged
    over the model axis by log-sum-exp. ``"cache"``: the cache moves to
    the heads' placements for the step and back. ``step_bytes`` are what
    the sequence read moves on one data shard (the step's queries, whole
    over the heads, and their partial results), ``cache_bytes`` the cache
    the other path would move there (K and V, or MLA's latents, whole
    over the model axis). The queries grow with the step's tokens and the
    cache with its length, so the rule is ``step_bytes < cache_bytes``:
    the sequence at a decode step, the cache at a prefill that fills an
    empty cache of its prompt's length."""
    return "sequence" if step_bytes < cache_bytes else "cache"


class ModelAxis:
    """The collectives a per-shard computation (the function of a
    ``local_map``) issues over the ``model`` axis of ``device_mesh`` at a
    decode step: no gradient flows through them (a train step carries no
    cache). ``rank`` and ``size`` are this process's place on the axis;
    ``gather(x, dim)`` concatenates the shards along ``dim`` in rank
    order, ``amax``/``sum`` reduce elementwise, and ``to_owners(x)`` sends
    ``x[j]`` (a leading dim of ``size``) to rank ``j``, returning at
    ``[i]`` what rank ``i`` sent here."""

    def __init__(self, device_mesh):
        i = device_mesh.mesh_dim_names.index("model")
        self.rank = device_mesh.get_local_rank(i)
        self.size = device_mesh.size(i)
        self.group = device_mesh.get_group(i).group_name

    def gather(self, x, dim: int):
        return _all_gather(x, dim, self.group, self.size)

    def amax(self, x):
        return _all_reduce(x, "max", self.group)

    def sum(self, x):
        return _all_reduce(x, "sum", self.group)

    def to_owners(self, x):
        ops = torch.ops._c10d_functional
        n = [1] * self.size
        return ops.wait_tensor(ops.all_to_all_single(x.contiguous(), n, n,
                                                     self.group))


def split_rows(t, split: bool) -> list:
    """For each mesh axis of DTensor ``t`` (a per-shard computation's rows),
    whether the shards along it compute different things: a data axis
    where ``t`` is split, the model axis where the heads are."""
    names = t.device_mesh.mesh_dim_names or ()
    return [(split if n == "model" else p.is_shard())
            for n, p in zip(names, t.placements)]


def per_shard_grads(t, differs) -> tuple:
    """The gradient placements of DTensor ``t`` read by a per-shard
    computation (``local_map``) that differs along the mesh axes flagged
    in ``differs`` (``split_rows``): a ``Partial`` sum where ``t`` is
    replicated on such an axis (each shard's gradient covers its own rows
    or heads), ``t``'s placement elsewhere."""
    return tuple(Partial() if d and p.is_replicate() else p
                 for d, p in zip(differs, t.placements))


def packed_product(x, w, widths, heads, split: bool, compute_dtype):
    """``x @ w`` for a packed weight ``w`` (``packed_ranges``' segments
    along its columns), each model shard holding the columns of its own
    heads: a DTensor split on its last dim over the model axis whose
    local shard is ``x``'s rows times those columns (a segment every
    shard needs appears on each). Without ``split``, or on plain tensors,
    every column on every shard (``w`` made whole over the model axis).

    Split, the columns come by the path ``packed_path`` picks from the
    shapes, each an all-gather over the model axis where ``w`` is split
    on it: the weight path makes ``w`` whole on each shard
    (``gather_over_model``: its gradient a reduce-scatter over the model
    axis, then FSDP's over the data axes), picks the columns and
    multiplies locally; the activation path runs the column-parallel
    product as the rules place ``w``, gathers its output and picks the
    columns (its gradient a reduce-scatter of the output's). Either way a column that several
    shards use gets the sum of their gradients, and ``x``'s gradient is
    all-reduced in its dtype (``model_input``)."""
    cd = compute_dtype
    if not isinstance(x, DTensor) or not split:
        return x @ whole_over_model(w).to(cd)
    rank, size = model_coordinate(x)
    ranges = packed_ranges(widths, heads, rank, size)
    d_in = x.shape[-1]
    path = "weight"
    if model_sharded(w, w.ndim - 1):
        path = packed_path(d_in, x.to_local().numel() // d_in,
                           w.element_size(), cd.itemsize)
    x = model_input(x)
    differs = split_rows(x, True)
    out_pl = tuple(over_model(x, Shard(x.ndim - 1)))
    if path == "weight":
        mesh = x.device_mesh
        dim = w.ndim - 1
        gather = model_sharded(w, dim)
        w = _replicated_on(w, ("pod", "data"))

        def local(xl, wl):
            if gather:
                wl = gather_over_model(wl, mesh, dim)
            return xl @ pick_columns(wl, ranges).to(cd)
        return local_map(
            local, out_placements=(out_pl,),
            in_placements=(x.placements, w.placements),
            in_grad_placements=(per_shard_grads(x, differs),
                                per_shard_grads(w, differs)),
            device_mesh=mesh)(x, w)
    full = whole_over_model(x @ w.to(cd))
    return local_map(
        lambda yl: pick_columns(yl, ranges), out_placements=(out_pl,),
        in_placements=(full.placements,),
        in_grad_placements=(per_shard_grads(full, differs),),
        device_mesh=x.device_mesh)(full)


def full_tensors(tree):
    """``tree`` with each DTensor leaf whole on every process (a
    collective: every process of the mesh calls it); plain leaves as they
    are."""
    return map_with_path(lambda _, t: t.full_tensor()
                         if isinstance(t, DTensor) else t, tree)


def _has_dtensor(tree) -> bool:
    if isinstance(tree, dict):
        return any(_has_dtensor(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_has_dtensor(v) for v in tree)
    return isinstance(tree, DTensor)


def spmd_region(tree):
    """Where ``tree`` holds a DTensor, a context in which a plain tensor
    that meets a DTensor in an op is taken as replicated on its mesh (the
    model's positions, masks and constants, which every process builds
    alike); else no context. Regions nest: ``implicit_replication`` turns
    the switch off when it exits, so only the outermost region enters it
    (a checkpointed layer's recompute in the backward pass runs after the
    forward's region has closed, inside the train step's)."""
    if not _has_dtensor(tree) or DTensor._op_dispatcher \
            ._allow_implicit_replication:
        return contextlib.nullcontext()
    return implicit_replication()


# ---------------------------------------------------------------------------
# activation sharding constraints (set by launchers, identity in plain
# tests)
# ---------------------------------------------------------------------------
_ACT_POLICY: Optional[dict] = None


def set_activation_policy(mesh: Optional[Mesh], *,
                          batch_axes: Optional[Tuple[str, ...]] = None,
                          model_axis: Optional[str] = "model",
                          seq_axis: Optional[str] = None) -> None:
    """Install the activation-sharding policy used by ``shard_activation``.

    ``batch_axes`` default to the mesh's (pod, data) group. ``seq_axis``
    shards the sequence dimension instead (long-context batch=1 cells).
    Pass ``mesh=None`` to clear.
    """
    global _ACT_POLICY
    if mesh is None:
        _ACT_POLICY = None
        return
    _ACT_POLICY = {
        "mesh": mesh,
        "batch": batch_axes if batch_axes is not None else data_axes(mesh),
        "model": model_axis if model_axis in mesh.axis_names else None,
        "seq": seq_axis,
    }


def data_group_size() -> int:
    """Number of shards in the (pod, data) group under the active policy."""
    if _ACT_POLICY is None:
        return 1
    mesh = _ACT_POLICY["mesh"]
    g = 1
    for a in _ACT_POLICY["batch"] or ():
        g *= dict(mesh.shape).get(a, 1)
    return g


def redistribute_to(x, spec: Spec):
    """A DTensor ``x`` redistributed to ``spec`` fitted to its shape on the
    policy's mesh; the identity on a plain tensor or without a policy."""
    if _ACT_POLICY is None or not isinstance(x, DTensor):
        return x
    mesh = _ACT_POLICY["mesh"]
    fitted = _fit_spec(_spec(*spec), tuple(x.shape), mesh)
    return x.redistribute(x.device_mesh, spec_placements(fitted, mesh))


def shard_activation(x, kind: str = "btd"):
    """Constraint hook called from model code. kinds:
    ``btd`` (batch, seq, d_model) — batch over (pod,data);
    ``logits`` — batch over (pod,data), vocab over model."""
    if _ACT_POLICY is None or not isinstance(x, DTensor):
        return x
    pol = _ACT_POLICY
    nd = x.ndim
    if pol["seq"] and nd >= 2:
        spec = (None, pol["batch"], *([None] * (nd - 2)))
    elif kind == "logits":
        spec = (pol["batch"], *([None] * (nd - 2)), pol["model"])
    else:
        spec = (pol["batch"], *([None] * (nd - 1)))
    return redistribute_to(x, spec)
