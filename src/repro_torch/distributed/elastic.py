"""Elastic scaling: a replacement mesh after losing hosts.

Only ``shrink_mesh`` of the reference's ``distributed/elastic.py`` is
ported here, for the distributed tile driver; resharding a training state
comes with the dense LM stack (ROADMAP.md, still to port #8).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..launch.mesh import Mesh


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
