"""How many pieces one planned tile runs in, so that it keeps its budget.

``tiling`` plans tiles with the reference's estimate, which counts 16
bytes a scan-stream element and 13 a result entry. The port holds more a
stream element on the card (capacities bucketed to powers of two, int64
keys), so a tile that the estimate fits into the budget can peak well
above it. ``TiledExpr`` therefore runs each tile in ``L`` pieces: the
tile's schedule with its outermost loop variable parallelized into ``L``
lanes (``Schedule.parallelize``), which ``CompiledExpr`` runs one after
another on one plan. A lane's dead references give its scans length 0
outside its chunk, so every stream below the outermost level shrinks by
about ``L``; the lanes' partials merge in the plan's one keyed reduce.
The plan (``tile_of``, ``n_tiles``, ``tile_bytes``) stays the
reference's: the pieces are how the port executes a tile, not a new plan.

``piece_count`` decides ``L`` from the stream elements the reference
estimate models and the port's bytes a stream element, before the tile's
first device allocation.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

from ..kernels.ops import SEGMENT_DENSE_BOUND
from . import coord_ops as co
from . import tiling
from .einsum import Assignment, parse
from .schedule import Format, Schedule

# Bytes a row of a plan's largest stream capacity at the peak of a call,
# by the dtypes the engine allocates there (the collapse of the innermost
# stream into the keyed reduce, whose kernel stages nothing):
#   the innermost scan's crd and segment ids (int32, 4 + 4) and validity
#   (bool, 1)                                                      9
#   the multiply's two operand value streams (float32, 4 + 4)      8
#   the multiply's validity mask (bool)                            1
#   the collapse's int64 key (8) and validity mask (bool, 1)       9
#                                                                 --
#                                                                 27
STREAM_ROW_BYTES = 27
# A stream's capacity is the next power of two above 1.25 times its need
# (``torch_backend._bucket_cap``), so at most 2.5 times the need: the
# port's bytes a modelled stream element are a row's bytes times 2.5.
BUCKET_HEADROOM = 2.5
# Bytes a result entry of the tile while its pieces merge (these do not
# shrink with the pieces): the lanes' partials concatenated (int64 key,
# float32 value, bool: 13) and the merge's compaction (an int64 source
# index, the gathered key and value, and its output of 13), each at up to
# 2.5 times the entries: (13 + 8 + 12 + 13) * 2.5 = 115.
RESULT_ENTRY_BYTES = (13 + 8 + 12 + 13) * BUCKET_HEADROOM
# Bytes a key of a dense key space reduced on the card: the float32
# [sum, count] workspace (8), and the compaction's running count and the
# slot numbers it gathers the keys from (int64, 8 + 8).
KEY_SPACE_BYTES = 24
# Up to ``coord_ops.DENSE_REDUCE_BOUND`` keys the keyed reduce runs on
# ``scatter_workspace``, which reads staged rows: an int32 slot (4), the
# negated mask it is built with (bool, 1) and [a, b, hit] in float32 (12).
STAGING_ROW_BYTES = 17
# Beyond ``ops.SEGMENT_DENSE_BOUND`` keys the collapse sorts its stream
# instead, and a sort holds about 46 bytes a row of the capacity besides
# the stream (keys, sorted keys, permutation and the sort's own buffers;
# measured on the H100, PERF.md, PR 17).
SORT_ROW_BYTES = 46


def call_parts(assign, fmt: Format, schedule: Schedule,
               dims: Dict[str, int], *,
               densities: Optional[Dict[str, float]] = None
               ) -> Tuple[float, float, float]:
    """The three parts of ``tiling.estimate_call_bytes`` for one call:
    ``(operand bytes, scan-stream elements, result entries)``, with
    ``operand + 16 * stream + 13 * result`` its estimate (before rounding
    up). The same walk over the same density model, kept apart so the
    port can weigh each part by its own bytes."""
    assign = parse(assign) if isinstance(assign, str) else assign
    dens = tiling._densities(assign, densities)
    fills = tiling._level_fills(assign, fmt, dens)
    pos = {v: i for i, v in enumerate(schedule.loop_order)}
    operand = 0.0
    seen = set()
    for term in assign.terms:
        for acc in term.factors:
            if acc.tensor in seen:
                continue
            seen.add(acc.tensor)
            path = tuple(sorted(acc.vars, key=lambda v: pos.get(v, 0)))
            s = fmt.of(acc.tensor, len(acc.vars))
            cnt, fill = 1.0, fills[acc.tensor]
            for v, ch in zip(path, s):
                operand += 4 * (cnt + 1)                    # seg (int32)
                cnt *= dims[v] * (fill if ch in "cbshm" else 1.0)
                cnt = max(cnt, 1.0)
                operand += 4 * cnt                          # crd (int32)
            operand += 4 * cnt                              # vals (f32)
    result_vars = set(assign.lhs.vars)
    stream = result = 0.0
    for term in assign.terms:
        scope = [v for v in schedule.loop_order
                 if v in term.vars or v in result_vars]
        count = 1.0
        for v in scope:
            flens, fprob = [], 1.0
            for f in term.factors:
                if v not in f.vars:
                    continue
                s = fmt.of(f.tensor, len(f.vars))
                path = tuple(sorted(f.vars, key=lambda w: pos.get(w, 0)))
                ch = s[path.index(v)] if path.index(v) < len(s) else "c"
                fill = fills[f.tensor] if ch in "cbshm" else 1.0
                flens.append(max(dims[v] * fill, 1.0))
                fprob *= fill
            if flens:
                stream += count * sum(flens)
                count *= max(dims[v] * fprob, 1e-9)
            else:                                           # broadcast var
                stream += count * dims[v]
                count *= dims[v]
        result += count
    return operand, stream, result


def piece_count(stream_elements: float, element_bytes: float,
                budget: Optional[int], fixed_bytes: float = 0.0) -> int:
    """The pieces one call runs in so that its peak keeps ``budget``.

    A call of ``stream_elements`` (the reference estimate's scan-stream
    elements) holds ``element_bytes`` a stream element on the card (a
    row's bytes times ``BUCKET_HEADROOM``: 27 * 2.5 = 67.5 where the
    keyed reduce stages nothing) and ``fixed_bytes`` that pieces do not
    shrink. ``L`` pieces each hold ``1/L`` of the streams, so ``L`` is
    the least count with
    ``element_bytes * stream_elements / L + fixed_bytes <= budget``. No
    budget, or a call that fits, gives 1. Where ``fixed_bytes`` alone
    leaves less than a tenth of the budget, the streams get that tenth:
    pieces cannot shrink the rest.

    >>> piece_count(1e6, 67.5, None), piece_count(1e6, 67.5, 10 ** 9)
    (1, 1)
    >>> piece_count(1e8, 67.5, 4 * 2 ** 30, fixed_bytes=2 ** 30)
    3
    """
    need = element_bytes * float(stream_elements)
    if budget is None or need + fixed_bytes <= budget:
        return 1
    room = max(budget - fixed_bytes, budget / 10)
    return max(1, math.ceil(need / room))


def tile_pieces(assign: Assignment, fmt: Format, schedule: Schedule,
                dims: Dict[str, int], budget: Optional[int], *,
                densities: Optional[Dict[str, float]] = None) -> int:
    """The pieces one tile of extents ``dims`` runs in under ``budget``
    (1 without one). The fixed bytes are the tile's operands (up to twice
    the estimate's, for the input buckets), its result while the pieces
    merge (``RESULT_ENTRY_BYTES`` an entry, at most one entry a key of the
    result space) and a dense key space's workspace. A stream row holds
    ``STREAM_ROW_BYTES``, and more where the keyed reduce stages its input
    (``scatter_workspace``) or sorts (a key space too large for a
    workspace). At most one piece a coordinate of the variable the pieces
    split; 1 where the schedule already splits or parallelizes (the pieces
    would be lanes of lanes)."""
    if (budget is None or schedule.split or schedule.parallelize
            or not schedule.loop_order):
        return 1
    operand, stream, result = call_parts(assign, fmt, schedule, dims,
                                         densities=densities)
    space = math.prod(dims[v] for v in assign.lhs.vars)
    fixed = 2 * operand + RESULT_ENTRY_BYTES * min(result, space)
    if space <= SEGMENT_DENSE_BOUND:
        fixed += KEY_SPACE_BYTES * space
    pieces = piece_count(stream, row_bytes(space) * BUCKET_HEADROOM, budget,
                         fixed_bytes=fixed)
    return min(pieces, dims[schedule.loop_order[0]])


def row_bytes(key_space: int) -> int:
    """The port's bytes a row of a call's largest stream capacity when its
    result has ``key_space`` keys: ``STREAM_ROW_BYTES``, plus the staged
    rows of ``scatter_workspace`` up to ``coord_ops.DENSE_REDUCE_BOUND``
    keys, or a sort's bytes beyond ``ops.SEGMENT_DENSE_BOUND``."""
    if key_space <= co.DENSE_REDUCE_BOUND:
        return STREAM_ROW_BYTES + STAGING_ROW_BYTES
    if key_space <= SEGMENT_DENSE_BOUND:
        return STREAM_ROW_BYTES
    return STREAM_ROW_BYTES + SORT_ROW_BYTES


def piece_schedule(schedule: Schedule, pieces: int) -> Schedule:
    """The schedule a tile runs in ``pieces``: its outermost loop variable
    parallelized into that many lanes (unchanged for 1)."""
    if pieces <= 1:
        return schedule
    return dataclasses.replace(
        schedule, parallelize={schedule.loop_order[0]: pieces})
