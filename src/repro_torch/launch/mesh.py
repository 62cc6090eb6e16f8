"""The host mesh: a grid of torch devices with named axes.

The port's counterpart of the reference's ``launch/mesh.py``, which builds a
``jax.sharding.Mesh``. A ``Mesh`` here is the shape, the axis names, the
array of devices and, under ``torch.distributed``, the
``DeviceMesh`` over the process group (one process a device, as
``python -m torch.distributed.run`` launches them) that placement
(``distributed.sharding.place``) puts DTensors on. ``make_host_mesh``
gives the reference's ``(n // model_parallel, model_parallel)`` shape
over the process group's ``n`` processes, or one device without a
process group; ``make_local_mesh`` every device of one kind in this
process, which the distributed tile driver's workers share out.
``make_production_mesh`` gives the production meshes' shapes and axis
names over meta devices, for the dry-run's per-device reckoning; the
sharding rules read only ``shape`` and ``axis_names``, and placing a tree
on such a mesh raises.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core import coord_ops as co


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: an object array of ``torch.device`` whose axes are
    named by ``axis_names``, one name an axis; ``device_mesh``: the
    ``torch.distributed`` ``DeviceMesh`` of the same shape and names over
    the process group, or None in one process."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]
    device_mesh: Any = None

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-D devices with axis "
                             f"names {self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order (as ``jax``'s ``Mesh.shape``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


def _device_array(devs) -> np.ndarray:
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return arr


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single-pod: 16x16 = 256 devices (data x model). Multi-pod:
    2x16x16 = 512 (pod x data x model); the pod axis extends the DP/FSDP
    group. Every device is ``torch.device("meta")``: the mesh carries the
    shape and the axis names, and nothing can be placed on it."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    return Mesh(_device_array([torch.device("meta")] * n).reshape(shape),
                axes)


def _kind(device) -> str:
    kind = torch.device("cuda" if device is None else device).type
    if kind == "cuda" and torch.cuda.device_count() == 0:
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' for a mesh over the CPU")
    return kind


def make_host_mesh(model_parallel: int = 1, *, device=None) -> Mesh:
    """The ``(data, model)`` mesh ``(n // model_parallel,
    model_parallel)`` over the ``n`` processes of the ``torch.distributed``
    process group, with its ``DeviceMesh`` (process ``r`` at row-major
    position ``r``; each process on ``cuda:LOCAL_RANK``, or the CPU), or
    over this process's one device (``n`` = 1) without a process group:
    CUDA by default (an error without a GPU, as the port's entry points
    raise rather than fall back to the CPU), or the CPU for
    ``device="cpu"``. ``ValueError`` when ``model_parallel`` does not
    divide ``n``."""
    kind = _kind(device)
    grouped = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if grouped else 1
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"--model-parallel {model_parallel} must divide "
                         f"the {n} process(es) of the mesh")
    shape = (n // model_parallel, model_parallel)
    if not grouped:
        return Mesh(_device_array([co.resolve_device(device)]).reshape(shape),
                    ("data", "model"))
    from torch.distributed.device_mesh import init_device_mesh
    dm = init_device_mesh(kind, shape, mesh_dim_names=("data", "model"))
    n_local = torch.cuda.device_count() if kind == "cuda" else 0
    devs = [torch.device(kind, r % n_local) if n_local else
            torch.device(kind) for r in range(n)]
    return Mesh(_device_array(devs).reshape(shape), ("data", "model"), dm)


def make_local_mesh(*, device=None) -> Mesh:
    """A ``(data, model)`` mesh over this process's devices of one kind,
    every device on the data axis (model axis 1): every CUDA device by
    default (an error without a GPU), or the CPU for ``device="cpu"``.
    No process group: the distributed tile driver shares its workers out
    over these devices."""
    kind = _kind(device)
    if kind == "cuda":
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [torch.device(kind)]
    return Mesh(_device_array(devs).reshape(len(devs), 1), ("data", "model"))
