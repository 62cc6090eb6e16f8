"""Sharding rules of the port: the data-parallel axes of a mesh.

Only ``data_axes`` of the reference's ``distributed/sharding.py`` is
ported here, for the distributed tile driver; the parameter and batch
rules come with the dense LM stack (ROADMAP.md, still to port #8).
"""
from __future__ import annotations

from typing import Tuple

from ..launch.mesh import Mesh


def data_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The mesh's data-parallel group: its ``pod`` and ``data`` axes."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)
