"""Custard's format and scheduling languages (paper §5, TACO input APIs).

``Format`` assigns each tensor a per-level storage format string (one char
per mode: d/c/b/s/h/m; see ``fibertree.LEVEL_SPECS`` for the capability
matrix). ``Schedule`` carries the dataflow (index-variable) order
and the §4 optimizations: iterate-locate, coordinate skipping, bitvector
iteration, iteration splitting, and parallelization.

``build_inputs`` constructs concordant fibertrees for a scheduled
expression from dense numpy arrays: each tensor is stored with its modes
ordered by the loop order (e.g. the outer-product SpM*SpM schedule stores B
column-major), which is exactly the paper's assumption that formats are
chosen to match the dataflow.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, Optional, Sequence, Tuple

import numpy as np

from .einsum import Assignment
from .fibertree import FiberTree


@dataclasses.dataclass
class Format:
    """Per-tensor level-format strings: one character per storage mode —
    ``d`` (dense), ``c`` (compressed), ``b`` (bitvector), ``s``
    (singleton/COO), ``h`` (hashed), ``m`` (bitmap). Tensors without
    an explicit entry use ``default`` at every level.

    >>> fmt = Format({"B": "dc"})          # CSR-like: dense rows, compressed cols
    >>> fmt.of("B", 2)
    'dc'
    >>> fmt.of("C", 2)                     # falls back to all-compressed (DCSR)
    'cc'
    """

    formats: Dict[str, str] = dataclasses.field(default_factory=dict)
    default: str = "c"

    def of(self, tensor: str, order: int) -> str:
        """The format string of ``tensor`` with ``order`` storage modes."""
        return self.formats.get(tensor, self.default * order)


@dataclasses.dataclass
class Schedule:
    """The dataflow schedule of one lowered expression.

    ``loop_order`` is the index-variable (dataflow) order, outer to inner;
    the §4 optimizations ride along: ``locate`` (iterate-locate per
    (tensor, var)), ``skip`` (§4.2 coordinate skipping), ``bitvector``
    (§4.3), ``split`` (§4.1 iteration splitting, ``{var: factor}``) and
    ``parallelize`` (§4.4 lane duplication, ``{var: lanes}``, one var).
    ``tile`` (``{var: n_tiles}``) is the out-of-core knob: the variable's
    coordinate space partitions into ``n`` tiles that stream SEQUENTIALLY
    through one compiled per-tile engine, bounding peak device allocation
    (docs/TILING.md; DESIGN.md §7). Instead of hand-picking, pass the
    string ``"auto"`` where a Schedule is expected (``custard.lower``,
    ``torch_backend.compile_expr``) to let the autoscheduler search the
    space — see docs/SCHEDULING.md.

    >>> sch = Schedule(loop_order=("i", "k", "j"), split={"k": 4},
    ...                parallelize={"k": 4})
    >>> sch.tensor_path(("k", "j"))        # storage order is concordant
    ('k', 'j')
    """

    loop_order: Sequence[str]
    locate: FrozenSet[Tuple[str, str]] = frozenset()      # (tensor, var)
    skip: FrozenSet[str] = frozenset()                     # vars w/ galloping
    bitvector: FrozenSet[str] = frozenset()                # vars iterated as bv
    split: Dict[str, int] = dataclasses.field(default_factory=dict)
    # §4.4 lane duplication over one variable's coordinate space (applied
    # to the split-outer half when the variable is also split)
    parallelize: Dict[str, int] = dataclasses.field(default_factory=dict)
    reduce_empty: Optional[str] = None                     # override zero/remove
    # out-of-core tiling: {var: n_tiles}; tiles execute sequentially
    # through the tiled driver (the reference's TiledExpr), never inside one
    # lowered graph — custard.lower rejects schedules that still carry it
    tile: Dict[str, int] = dataclasses.field(default_factory=dict)

    def tensor_path(self, access_vars: Sequence[str]) -> Tuple[str, ...]:
        """The tensor's level order under this schedule (concordant)."""
        pos = {v: i for i, v in enumerate(self.loop_order)}
        return tuple(sorted(access_vars, key=lambda v: pos[v]))


def schedule_to_dict(schedule: Schedule) -> dict:
    """JSON-serializable form of a ``Schedule`` (the persistent schedule
    cache's on-disk record; see DESIGN.md §5).

    >>> d = schedule_to_dict(Schedule(loop_order=("i", "k", "j"),
    ...                               split={"k": 4}, parallelize={"k": 4},
    ...                               tile={"j": 2}))
    >>> d["loop_order"], d["split"], d["parallelize"], d["tile"]
    (['i', 'k', 'j'], {'k': 4}, {'k': 4}, {'j': 2})
    """
    return {
        "loop_order": list(schedule.loop_order),
        "locate": sorted([t, v] for t, v in schedule.locate),
        "skip": sorted(schedule.skip),
        "bitvector": sorted(schedule.bitvector),
        "split": {k: int(v) for k, v in schedule.split.items()},
        "parallelize": {k: int(v) for k, v in schedule.parallelize.items()},
        "reduce_empty": schedule.reduce_empty,
        "tile": {k: int(v) for k, v in schedule.tile.items()},
    }


def schedule_from_dict(d: dict) -> Schedule:
    """Inverse of ``schedule_to_dict``.

    >>> s = Schedule(loop_order=("i", "j"), skip=frozenset({"j"}),
    ...              tile={"i": 4})
    >>> schedule_from_dict(schedule_to_dict(s)) == s
    True
    """
    return Schedule(
        loop_order=tuple(d["loop_order"]),
        locate=frozenset((t, v) for t, v in d.get("locate", [])),
        skip=frozenset(d.get("skip", [])),
        bitvector=frozenset(d.get("bitvector", [])),
        split={k: int(v) for k, v in d.get("split", {}).items()},
        parallelize={k: int(v)
                     for k, v in d.get("parallelize", {}).items()},
        reduce_empty=d.get("reduce_empty"),
        tile={k: int(v) for k, v in d.get("tile", {}).items()})


def split_schedule(schedule: Schedule) -> Schedule:
    """Rewrite a schedule's split vars ``v`` into ``(vo, vi)`` (§4.1).

    Every schedule field referring to a split variable is renamed:
    skip/bitvector apply to both halves, locate moves to the inner level,
    and ``parallelize`` follows the OUTER level (the §4.4 combination:
    split a variable, then duplicate the subgraph across its chunks).
    """
    if not schedule.split:
        return schedule
    order = []
    for v in schedule.loop_order:
        if v in schedule.split:
            order += [f"{v}o", f"{v}i"]
        else:
            order.append(v)
    return dataclasses.replace(
        schedule, loop_order=tuple(order), split={},
        bitvector=frozenset(
            {f"{v}i" if v in schedule.split else v for v in schedule.bitvector}
            | {f"{v}o" for v in schedule.bitvector if v in schedule.split}),
        skip=frozenset({f"{v}i" if v in schedule.split else v
                        for v in schedule.skip}
                       | {f"{v}o" for v in schedule.skip if v in schedule.split}),
        locate=frozenset((t, f"{v}i" if v in schedule.split else v)
                         for t, v in schedule.locate),
        parallelize={(f"{v}o" if v in schedule.split else v): n
                     for v, n in schedule.parallelize.items()})


def apply_split(assign_text: str, schedule: Schedule) -> Tuple[str, Schedule]:
    """Rewrite ``v`` into ``(v_o, v_i)`` in an expression + schedule (§4.1).

    Returns the rewritten expression text and schedule. The corresponding
    data transformation happens in ``build_inputs`` (dimension reshaped to
    (split, dim // split)).
    """
    if not schedule.split:
        return assign_text, schedule
    text = assign_text
    import re
    for v in schedule.split:
        text = re.sub(rf"\b{v}\b(?![A-Za-z_0-9])", f"{v}o,{v}i", text)
    return text, split_schedule(schedule)


def split_assignment(assign: Assignment, split: Dict[str, int]) -> Assignment:
    """Structural counterpart of ``apply_split``: rewrite every access's
    split vars ``v`` into the adjacent pair ``(vo, vi)``."""
    from .einsum import Term

    def rew(acc):
        vs = tuple(w for v in acc.vars
                   for w in ((f"{v}o", f"{v}i") if v in split else (v,)))
        return dataclasses.replace(acc, vars=vs)

    return Assignment(
        lhs=rew(assign.lhs),
        terms=tuple(Term(t.sign, tuple(rew(f) for f in t.factors))
                    for t in assign.terms))


def split_dims(dims: Dict[str, int], split: Dict[str, int]) -> Dict[str, int]:
    """Post-split index extents: ``vo`` spans the chunks, ``vi`` one chunk."""
    out = {}
    for v, d in dims.items():
        if v in split:
            out[f"{v}o"] = split[v]
            out[f"{v}i"] = -(-d // split[v])
        else:
            out[v] = d
    return out


def split_format(assign: Assignment, fmt: Format, schedule: Schedule
                 ) -> Format:
    """Expand explicit per-tensor format strings for split levels.

    A split variable's storage level becomes two adjacent levels (``vo``
    inside ``vi``); its format character is duplicated. Entries whose length
    already matches the post-split order are left untouched (callers that
    pre-applied the split keep working)."""
    if not schedule.split:
        return fmt
    out = dict(fmt.formats)
    accs = [assign.lhs] + [f for t in assign.terms for f in t.factors]
    for acc in accs:
        s = out.get(acc.tensor)
        if s is None or len(s) != len(acc.vars):
            continue
        path = schedule.tensor_path(acc.vars)
        out[acc.tensor] = "".join(
            c * (2 if v in schedule.split else 1)
            for v, c in zip(path, s))
    return Format(out, default=fmt.default)


def build_inputs(assign: Assignment, fmt: Format, schedule: Schedule,
                 arrays: Dict[str, np.ndarray],
                 split_of: Optional[Dict[str, int]] = None
                 ) -> Dict[str, FiberTree]:
    """Construct concordant FiberTrees for every input tensor."""
    out: Dict[str, FiberTree] = {}
    split_of = split_of or {}
    for term in assign.terms:
        for acc in term.factors:
            if acc.tensor in out:
                continue
            arr = np.asarray(arrays[acc.tensor], dtype=np.float64)
            # split vars: adjacent (vo, vi) pairs reshape the original axis
            # into (factor, dim/factor) chunks; each loop step consumes ONE
            # output axis (the vi half is its own iteration), so the cursor
            # always advances by one
            ax = 0
            for v in acc.vars:
                if (v.endswith("o") and v[:-1] in split_of
                        and ax < arr.ndim):
                    arr = split_dense(arr, ax, split_of[v[:-1]])
                ax += 1
            path = schedule.tensor_path(acc.vars)
            mode_order = tuple(acc.vars.index(v) for v in path)
            out[acc.tensor] = FiberTree.from_dense(
                arr, fmt.of(acc.tensor, arr.ndim), mode_order=mode_order)
    return out


def split_dense(arr: np.ndarray, axis: int, factor: int) -> np.ndarray:
    """Reshape one axis into (factor, dim/factor) chunks (§4.1 splitting)."""
    d = arr.shape[axis]
    pad = (-d) % factor
    if pad:
        widths = [(0, 0)] * arr.ndim
        widths[axis] = (0, pad)
        arr = np.pad(arr, widths)
    new_shape = (arr.shape[:axis] + (factor, (d + pad) // factor)
                 + arr.shape[axis + 1:])
    return arr.reshape(new_shape)


def unsplit_result(arr: np.ndarray, lhs_vars: Sequence[str],
                   split_of: Dict[str, int], dims: Dict[str, int]
                   ) -> np.ndarray:
    """Undo ``split_dense`` on a result array: merge each (vo, vi) axis pair
    back into the original axis and trim the split padding.

    ``arr`` axes follow ``lhs_vars`` (the ORIGINAL lhs order) with split
    vars occupying two adjacent axes."""
    arr = np.asarray(arr)
    ax = 0
    for v in lhs_vars:
        if v in split_of:
            merged = arr.shape[ax] * arr.shape[ax + 1]
            arr = arr.reshape(arr.shape[:ax] + (merged,)
                              + arr.shape[ax + 2:])
            arr = arr[(slice(None),) * ax + (slice(0, dims[v]),)]
        ax += 1
    return arr
