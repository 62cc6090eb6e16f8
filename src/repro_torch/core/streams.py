"""SAM stream model (paper §3.2).

A SAM stream is a sequence of tokens carrying one fibertree level:

* data tokens   — coordinates (int), references (int), or values (float),
* stop tokens   — ``S_n``: hierarchical fiber boundaries,
* empty token   — ``N``: a hole produced by union merging,
* done token    — ``D``: end of stream.

Wire encoding (matches every example in the paper, e.g. Fig. 1d / Fig. 7):
``S_n`` separates two depth-(n+1) groups; the stream ends with the
highest-level stop ``S_{d-1}`` followed by ``D``. E.g. the nested values
``((1),(2,3),(4,5))`` serialize (in arrival order) to
``1 S0 2 3 S0 4 5 S1 D``. Consecutive stops encode empty fibers:
``[[1],[],[2]]`` is ``1 S0 S0 2 S1 D``.

Two equivalent representations are provided:

* **token lists** (the paper's wire-level view) — used for the stream
  analysis benchmarks (Fig. 14) and golden tests, and
* **nested lists** (the "variable-length nested list" view from §3.2) —
  used by the functional simulator, because recursion over fibers is the
  natural way to express per-level block semantics.

``tokens_to_nested``/``nested_to_tokens`` are inverse bijections on
normalized streams (empty *groups* normalize to a chain of empty fibers,
e.g. ``[[]]`` — exactly what the wire encoding can express).
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Sequence, Union


class _Singleton:
    _name = "?"

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return self._name

    def __deepcopy__(self, memo):  # singletons stay singletons
        return self

    def __copy__(self):
        return self


class Done(_Singleton):
    """End-of-stream token ``D``."""

    _name = "D"


class Empty(_Singleton):
    """Empty token ``N`` emitted by unioners for missing operands."""

    _name = "N"


D = Done()
N = Empty()


@dataclasses.dataclass(frozen=True)
class Stop:
    """Hierarchical stop token ``S_n``."""

    level: int

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"S{self.level}"


Token = Union[int, float, Stop, Done, Empty]
Nested = Union[int, float, None, List[Any]]

# ---------------------------------------------------------------------------
# Stream type tags (wire kinds in SAM graphs)
# ---------------------------------------------------------------------------
CRD = "crd"      # coordinate stream
REF = "ref"      # reference stream
VAL = "val"      # value stream
BV = "bv"        # bitvector stream (packed words; §4.3)


def is_control(tok: Token) -> bool:
    return isinstance(tok, (Stop, Done, Empty))


def nested_depth(x: Nested) -> int:
    """Nesting depth: scalars are 0, fibers 1, fibers-of-fibers 2, ..."""
    if not isinstance(x, list):
        return 0
    return 1 + max((nested_depth(c) for c in x), default=0)


# ---------------------------------------------------------------------------
# token list <-> nested list
# ---------------------------------------------------------------------------

def tokens_to_nested(tokens: Sequence[Token], depth: int | None = None) -> Nested:
    """Parse a token stream into its nested-list view.

    ``depth`` may be given explicitly for streams whose stops do not reveal
    the full depth (e.g. an all-empty deep stream); otherwise it is inferred
    from the highest stop level.
    """
    if not tokens or not isinstance(tokens[-1], Done):
        raise ValueError("stream must be terminated by D")
    body = tokens[:-1]
    if depth is None:
        depth = 0
        for t in body:
            if isinstance(t, Stop):
                depth = max(depth, t.level + 1)
    if depth == 0:
        if not body:
            return []
        if len(body) != 1:
            raise ValueError("depth-0 stream must carry exactly one token")
        t = body[0]
        return None if isinstance(t, Empty) else t

    root: List[Any] = []
    stack: List[List[Any]] = [root]

    def open_to_leaf() -> None:
        while len(stack) < depth:
            new: List[Any] = []
            stack[-1].append(new)
            stack.append(new)

    for t in body:
        if isinstance(t, Stop):
            open_to_leaf()  # consecutive stops => empty fiber chain
            k = min(t.level + 1, len(stack) - 1)
            if k:
                del stack[len(stack) - k:]
        elif isinstance(t, Empty):
            open_to_leaf()
            stack[-1].append(None)
        else:
            open_to_leaf()
            stack[-1].append(t)
    return root


def nested_to_tokens(nested: Nested) -> List[Token]:
    """Serialize a nested-list view back into a token stream.

    Separator semantics: ``S_{k}`` between adjacent depth-(k+1) siblings,
    with a final ``S_{d-1}`` terminator before ``D`` (matching the paper's
    stream figures).
    """
    if not isinstance(nested, list):  # scalar stream
        return [N if nested is None else nested, D]

    out: List[Token] = []
    d = nested_depth(nested)

    def emit(node: Nested, node_depth: int) -> None:
        if node_depth <= 1:  # a fiber of leaves
            for leaf in node:  # type: ignore[union-attr]
                out.append(N if leaf is None else leaf)
            return
        assert isinstance(node, list)
        for i, child in enumerate(node):
            emit(child if isinstance(child, list) else [child], node_depth - 1)
            if i != len(node) - 1:
                out.append(Stop(node_depth - 2))

    emit(nested, d)
    out.append(Stop(d - 1))
    out.append(D)
    return out


def normalize(nested: Nested, depth: int | None = None) -> Nested:
    """Normalize empty groups into empty-fiber chains (wire-expressible form).

    ``[[ ]]`` at depth 3 becomes ``[[[]]]`` etc. Leaves are untouched.
    """
    if depth is None:
        depth = nested_depth(nested)
    if depth <= 1 or not isinstance(nested, list):
        return nested
    if not nested:
        # empty group: materialize a single empty fiber chain below
        inner: Nested = []
        for _ in range(depth - 2):
            inner = [inner]
        return [inner] if depth > 1 else inner
    return [normalize(c, depth - 1) for c in nested]


def token_type_counts(tokens: Sequence[Token]) -> dict:
    """Breakdown used by the Fig. 14 stream-analysis benchmark."""
    counts = {"data": 0, "stop": 0, "done": 0, "empty": 0}
    for t in tokens:
        if isinstance(t, Stop):
            counts["stop"] += 1
        elif isinstance(t, Done):
            counts["done"] += 1
        elif isinstance(t, Empty):
            counts["empty"] += 1
        else:
            counts["data"] += 1
    return counts


# ---------------------------------------------------------------------------
# nested-list utilities shared by the simulator blocks
# ---------------------------------------------------------------------------

def map_fibers(fn, *streams: Nested, depth: int):
    """Apply ``fn`` to aligned sub-structures ``depth`` levels down.

    All streams must share outer structure (same sibling counts) above
    ``depth``; SAM graphs guarantee this by construction.
    """
    if depth == 0:
        return fn(*streams)
    lens = {len(s) for s in streams}
    if len(lens) != 1:
        raise ValueError(f"misaligned outer structure: lengths {lens}")
    return [map_fibers(fn, *subs, depth=depth - 1) for subs in zip(*streams)]


def count_leaves(x: Nested) -> int:
    if not isinstance(x, list):
        return 1
    return sum(count_leaves(c) for c in x)


def count_tokens(x: Nested) -> int:
    """Number of wire tokens the nested view serializes to (incl. stops+D)."""
    return len(nested_to_tokens(x))


def flatten(x: Nested, out=None) -> list:
    if out is None:
        out = []
    if isinstance(x, list):
        for c in x:
            flatten(c, out)
    else:
        out.append(x)
    return out
