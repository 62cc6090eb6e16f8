"""The host mesh: a grid of torch devices with named axes.

The port's counterpart of the reference's ``launch/mesh.py``, which builds a
``jax.sharding.Mesh``. A ``Mesh`` here is the shape, the axis names and
the array of devices, which is all the distributed tile driver reads.
Building one touches no device state beyond counting the CUDA devices.
``make_production_mesh`` gives the production meshes' shapes and axis
names over meta devices, for the dry-run's per-device reckoning; the
sharding rules read only ``shape`` and ``axis_names``, and placing a tree
on such a mesh raises (``distributed.sharding.place``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: an object array of ``torch.device`` whose axes are
    named by ``axis_names``, one name an axis."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]

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


def make_host_mesh(*, device=None) -> Mesh:
    """A ``(data, model)`` mesh over the present devices of one kind, every
    device on the data axis (model axis 1): every CUDA device by default
    (an error without a GPU, as the port's entry points raise rather than
    fall back to the CPU), or the CPU for ``device="cpu"``."""
    kind = torch.device("cuda" if device is None else device).type
    if kind == "cuda":
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' for a mesh over the CPU")
        devs = [torch.device("cuda", i) for i in range(n)]
    else:
        devs = [torch.device(kind)]
    return Mesh(_device_array(devs).reshape(len(devs), 1), ("data", "model"))
