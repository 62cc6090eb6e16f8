"""Elastic scaling: re-lay-out a training state onto a different mesh.

The sharding rules (sharding.py) are pure functions of (mesh, parameter
path and shape), so resharding is: rebuild the mesh, recompute every
leaf's spec, and put the state onto it. Divisibility is validated (a
16-way TP dim cannot move to a 12-way axis), and ``shrink_mesh``
proposes the mesh that remains after losing hosts.

A port of ``repro.distributed.elastic``. ``reshard`` goes through each
leaf whole (``sharding.full_tensors``, a collective over the old mesh's
process group) to the new mesh's placements (``sharding.place``), after
``validate_mesh_for``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..launch.mesh import Mesh
from .sharding import full_tensors, map_with_path, params_shardings, place

__all__ = ["validate_mesh_for", "reshard", "shrink_mesh"]


def _keystr(path) -> str:
    """A path as ``jax.tree_util.keystr`` writes it: ``['a'][0]``."""
    return "".join(f"[{k!r}]" for k in path)


def validate_mesh_for(params, mesh: Mesh) -> list:
    """Returns a list of (path, shape, axis) divisibility violations."""
    problems = []
    shardings = params_shardings(params, mesh)

    def check(path, leaf):
        spec = shardings
        for k in path:
            spec = spec[k]
        shape = tuple(leaf.shape)
        for dim, axes in enumerate(spec):
            if axes is None:
                continue
            axes_t = axes if isinstance(axes, tuple) else (axes,)
            size = int(np.prod([mesh.shape[a] for a in axes_t]))
            if dim < len(shape) and shape[dim] % size != 0:
                problems.append((_keystr(path), shape, axes))

    map_with_path(check, params)
    return problems


def reshard(state, new_mesh: Mesh):
    """Re-lay-out ``state`` onto ``new_mesh``: every leaf whole, then
    placed by ``new_mesh``'s specs."""
    problems = validate_mesh_for(state, new_mesh)
    if problems:
        raise ValueError(f"mesh {dict(new_mesh.shape)} incompatible: "
                         f"{problems[:3]} (+{max(0, len(problems)-3)} more)")
    return place(full_tensors(state), new_mesh)


def shrink_mesh(mesh: Mesh, failed_hosts: int, devices_per_host: int
                ) -> Tuple[Optional[Mesh], int]:
    """Propose a replacement mesh after losing ``failed_hosts`` hosts:
    keep the model axis (TP topology is rigid), shrink the data axis."""
    axes = dict(mesh.shape)
    model = axes.get("model", 1)
    lost = failed_hosts * devices_per_host
    total = mesh.devices.size - lost
    data = total // (model * axes.get("pod", 1))
    if data < 1:
        return None, 0
    new_shape = tuple(v for v in ((axes.get("pod"), "pod"),
                                  (data, "data"), (model, "model"))
                      if v[0] is not None)
    names = tuple(n for _, n in new_shape)
    dims = tuple(d for d, _ in new_shape)
    devs = np.asarray(mesh.devices).reshape(-1)[: int(np.prod(dims))]
    return Mesh(devs.reshape(dims), names), data
