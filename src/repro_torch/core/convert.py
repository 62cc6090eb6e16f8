"""Carry stored tensors across from plain arrays into the port's FiberTree.

SAM has no weights: its state is the operand storage. ``tree_from_arrays``
takes a fibertree spelled out as plain Python and numpy (per level: its
format, dimension, and whichever of ``seg``/``crd``/``words`` the format
stores) and returns the port's ``FiberTree`` with exactly those arrays.
A caller holding a tree from another implementation unpacks it into this
form, so the two never import each other and both see the same bytes,
``s``, ``h`` and ``m`` storage included.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np

from .fibertree import _FORMAT_ABBREV, FiberTree, Level


def tree_from_arrays(shape: Sequence[int], levels: Sequence[Mapping],
                     vals, mode_order: Optional[Sequence[int]] = None
                     ) -> FiberTree:
    """Build a ``FiberTree`` from per-level arrays.

    Args:
        shape: the tensor's extents in storage order.
        levels: one mapping per level with ``format`` (a name like
            ``"compressed"`` or a letter like ``"c"``), ``dim``, and the
            arrays the format stores: ``seg``/``crd`` for compressed,
            singleton and hashed levels, ``words`` for bitmap and
            bitvector levels, nothing for dense ones. Missing or None
            entries stay None.
        vals: the leaf value array (kept as float64, like every tree the
            front end builds).
        mode_order: storage order of the modes (identity by default).

    >>> t = tree_from_arrays((2, 3), [
    ...     {"format": "d", "dim": 2},
    ...     {"format": "c", "dim": 3, "seg": [0, 1, 3], "crd": [2, 0, 1]}],
    ...     [5.0, 1.0, 2.0])
    >>> t.to_dense().tolist()
    [[0.0, 0.0, 5.0], [1.0, 2.0, 0.0]]
    """
    out = []
    for lv in levels:
        def arr(name, dtype):
            a = lv.get(name)
            return None if a is None else np.asarray(a, dtype=dtype)
        out.append(Level(format=_FORMAT_ABBREV[lv["format"]],
                         dim=int(lv["dim"]), seg=arr("seg", np.int64),
                         crd=arr("crd", np.int64),
                         words=arr("words", np.uint64)))
    return FiberTree(shape=tuple(int(d) for d in shape), levels=out,
                     vals=np.asarray(vals, dtype=np.float64),
                     mode_order=None if mode_order is None
                     else tuple(int(m) for m in mode_order))
