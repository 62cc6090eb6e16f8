"""Fibertree tensor data model (paper §3.1) with per-level storage formats.

A tensor is a coordinate tree: each level holds the coordinates of one
dimension; only children with nonzero sub-trees are stored. Levels are
independently assigned a storage format, described by a pluggable
``LevelSpec`` (the level-format interface of the Format Abstraction line
of work): a set of capability flags — ``full`` / ``ordered`` / ``unique``
/ ``appendable`` — plus the access methods each format supports
(``iterate`` / ``locate`` / ``insert``). The compiler consults ONLY the
flags (never the format name), so adding a format is adding a spec:

* ``dense`` (d)      — uncompressed: stores only the dimension size; every
                       coordinate is implicitly present (Fig. 3 left).
* ``compressed`` (c) — (seg, crd) arrays: segment ``[seg[r], seg[r+1])`` of
                       the coordinate array is the fiber at parent reference
                       ``r`` (Fig. 1c: DCSR when every level is compressed).
* ``bitvector`` (b)  — packed words; a set bit marks a nonempty sub-tree
                       (§4.3). Simulator-only: schedules must opt in via
                       ``Schedule.bitvector`` and the engine refuses it.
* ``singleton`` (s)  — COO-style level: one stored entry per child path,
                       duplicates across siblings NOT merged (``unique`` is
                       False). An all-``s`` tensor is classic COO.
* ``hashed`` (h)     — per-fiber open-addressed table: O(1) ``locate``, but
                       iteration yields coordinates in slot order, NOT
                       ascending (``ordered`` is False) — downstream merges
                       need an in-stream sort conversion node.
* ``bitmap`` (m)     — packed words like ``b``, but a first-class level the
                       scheduler may pick freely: scanners co-iterate it
                       word-at-a-time automatically and the engine converts
                       it on ingest.

The in-memory layout feeds the SAM level scanners; ``from_dense``/
``to_dense`` are the golden converters used throughout the tests, and
``FiberTree.convert`` re-lays a tensor under new level formats
bit-identically.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

DENSE = "dense"
COMPRESSED = "compressed"
BITVECTOR = "bitvector"
SINGLETON = "singleton"
HASHED = "hashed"
BITMAP = "bitmap"

_FORMAT_ABBREV = {"d": DENSE, "c": COMPRESSED, "b": BITVECTOR,
                  "s": SINGLETON, "h": HASHED, "m": BITMAP,
                  DENSE: DENSE, COMPRESSED: COMPRESSED, BITVECTOR: BITVECTOR,
                  SINGLETON: SINGLETON, HASHED: HASHED, BITMAP: BITMAP}

_ABBREV_OF = {DENSE: "d", COMPRESSED: "c", BITVECTOR: "b",
              SINGLETON: "s", HASHED: "h", BITMAP: "m"}

BV_WIDTH = 64  # bits per bitvector/bitmap word (paper's Fig. 13 uses b=64)


@dataclasses.dataclass(frozen=True)
class LevelSpec:
    """Capability flags + access methods of one level format.

    The flags are the level-format interface: lowering, scheduling
    legality, and the engine's ingest path branch on these — never on the
    format name — so a new format is fully described by its spec.

    * ``full``       — every coordinate in ``[0, dim)`` is implicitly
                       present (no stored coordinates).
    * ``ordered``    — ``Level.fiber`` yields ascending coordinates. An
                       unordered level needs a sort conversion node before
                       any co-iterating merge.
    * ``unique``     — at most one stored entry per (fiber, coordinate);
                       non-unique levels may fork a coordinate into several
                       sub-trees (COO duplicates) and need a tree
                       conversion before scanning.
    * ``appendable`` — the assembly path (level writers / ``from_coords``)
                       can build it.
    * ``iterate`` / ``locate`` / ``insert`` — supported access methods;
      ``locate`` admits ``Schedule.locate`` pairing and random probes.

    >>> spec_of("h").ordered, spec_of("h").locate
    (False, True)
    >>> spec_of("s").unique, spec_of("c").unique
    (False, True)
    """

    name: str
    abbrev: str
    full: bool
    ordered: bool
    unique: bool
    appendable: bool
    iterate: bool = True
    locate: bool = False
    insert: bool = False


LEVEL_SPECS = {
    DENSE: LevelSpec(DENSE, "d", full=True, ordered=True, unique=True,
                     appendable=True, locate=True, insert=True),
    COMPRESSED: LevelSpec(COMPRESSED, "c", full=False, ordered=True,
                          unique=True, appendable=True, locate=True,
                          insert=True),
    BITVECTOR: LevelSpec(BITVECTOR, "b", full=False, ordered=True,
                         unique=True, appendable=True, locate=True),
    SINGLETON: LevelSpec(SINGLETON, "s", full=False, ordered=True,
                         unique=False, appendable=True, insert=True),
    HASHED: LevelSpec(HASHED, "h", full=False, ordered=False, unique=True,
                      appendable=True, locate=True, insert=True),
    BITMAP: LevelSpec(BITMAP, "m", full=False, ordered=True, unique=True,
                      appendable=True, locate=True, insert=True),
}


def spec_of(fmt: str) -> LevelSpec:
    """Level spec for a format name or one-letter abbreviation."""
    return LEVEL_SPECS[_FORMAT_ABBREV[fmt]]


def _hash_order(crds: np.ndarray) -> np.ndarray:
    """Iteration order of a hashed fiber: ascending open-addressed slot.

    The modeled table has ``nslots`` = smallest power of two >=
    2*len(crds); coordinate ``c`` hashes to slot ``(c * 11) % nslots``
    with linear probing, inserted in ascending-coordinate order. The
    fiber iterates in ascending SLOT order — deterministic, but generally
    not ascending in coordinates (that is the whole point of the ``h``
    spec's ``ordered=False`` flag).

    >>> _hash_order(np.array([1, 2, 7])).tolist()   # slots 3, 6, 5
    [0, 2, 1]
    """
    n = len(crds)
    if n <= 1:
        return np.arange(n)
    nslots = 1
    while nslots < 2 * n:
        nslots *= 2
    slots: dict = {}
    for i in np.argsort(crds, kind="stable"):
        s = (int(crds[i]) * 11) % nslots
        while s in slots:
            s = (s + 1) % nslots
        slots[s] = int(i)
    return np.asarray([slots[s] for s in sorted(slots)], dtype=np.int64)


@dataclasses.dataclass
class Level:
    """One fibertree level in memory."""

    format: str
    dim: int                      # dense dimension size of this level
    seg: Optional[np.ndarray] = None   # compressed: segment starts, len P+1
    crd: Optional[np.ndarray] = None   # compressed: coordinates
    words: Optional[np.ndarray] = None  # bitvector: packed uint64 words (P, W)

    @property
    def spec(self) -> LevelSpec:
        return LEVEL_SPECS[self.format]

    @property
    def nnz(self) -> int:
        if self.format in (COMPRESSED, SINGLETON, HASHED):
            return int(len(self.crd))
        if self.format in (BITVECTOR, BITMAP):
            return int(sum(bin(int(w)).count("1") for w in self.words.ravel()))
        raise ValueError("dense levels have implicit coordinates")

    def fiber(self, ref: int) -> Tuple[np.ndarray, np.ndarray]:
        """(coords, child_refs) of the fiber at parent reference ``ref``.

        Coordinates come out in the format's ITERATION order: ascending
        for every ``ordered`` format, hash-slot order for ``hashed``
        (child refs still address the canonical sorted storage, so
        descendant levels are independent of the iteration order).
        """
        if self.format == DENSE:
            crds = np.arange(self.dim)
            return crds, ref * self.dim + crds
        if self.format in (COMPRESSED, SINGLETON):
            lo, hi = int(self.seg[ref]), int(self.seg[ref + 1])
            return self.crd[lo:hi], np.arange(lo, hi)
        if self.format == HASHED:
            lo, hi = int(self.seg[ref]), int(self.seg[ref + 1])
            order = _hash_order(self.crd[lo:hi])
            return self.crd[lo:hi][order], lo + order
        if self.format in (BITVECTOR, BITMAP):
            row = self.words[ref]
            crds, refs = [], []
            base = int(np.sum([bin(int(w)).count("1")
                               for r in range(ref) for w in self.words[r]]))
            count = base
            for wi, w in enumerate(row):
                w = int(w)
                for b in range(BV_WIDTH):
                    if w >> b & 1:
                        crds.append(wi * BV_WIDTH + b)
                        refs.append(count)
                        count += 1
            return np.asarray(crds, dtype=np.int64), np.asarray(refs, dtype=np.int64)
        raise ValueError(self.format)

    def sorted_fiber(self, ref: int) -> Tuple[np.ndarray, np.ndarray]:
        """Fiber in CANONICAL ascending-coordinate order (locator view).

        Identical to ``fiber`` for ordered formats; for ``hashed`` it reads
        the sorted backing storage directly, which is what an O(1) table
        probe keys on.
        """
        if self.format == HASHED:
            lo, hi = int(self.seg[ref]), int(self.seg[ref + 1])
            return self.crd[lo:hi], np.arange(lo, hi)
        return self.fiber(ref)

    def num_fibers(self) -> int:
        if self.format in (COMPRESSED, SINGLETON, HASHED):
            return len(self.seg) - 1
        if self.format in (BITVECTOR, BITMAP):
            return len(self.words)
        raise ValueError("dense levels have implicit fibers")


@dataclasses.dataclass
class FiberTree:
    """A sparse tensor: a stack of levels plus the leaf value array."""

    shape: Tuple[int, ...]
    levels: List[Level]
    vals: np.ndarray
    mode_order: Tuple[int, ...] = None  # storage order of modes (default id)

    def __post_init__(self):
        if self.mode_order is None:
            self.mode_order = tuple(range(len(self.shape)))

    @property
    def order(self) -> int:
        return len(self.shape)

    @property
    def nnz(self) -> int:
        return int(len(self.vals))

    @property
    def format_str(self) -> str:
        return "".join(_ABBREV_OF[lv.format] for lv in self.levels)

    # -- constructors -------------------------------------------------------
    @staticmethod
    def from_dense(arr: np.ndarray, formats: str | Sequence[str],
                   mode_order: Sequence[int] | None = None) -> "FiberTree":
        """Build a fibertree from a dense array.

        ``formats`` is one letter per level, e.g. ``"dc"`` (CSR), ``"cc"``
        (DCSR), ``"ss"`` (COO), ``"dm"`` (dense-over-bitmap), applied in
        ``mode_order`` (storage order; default row-major identity).
        """
        arr = np.asarray(arr)
        if arr.ndim == 0:
            return FiberTree(shape=(), levels=[],
                             vals=arr.reshape(1).astype(np.float64))
        if mode_order is not None:
            arr = np.transpose(arr, mode_order)
        else:
            mode_order = tuple(range(arr.ndim))
        fmts = [_FORMAT_ABBREV[f] for f in formats]
        if len(fmts) != arr.ndim:
            raise ValueError(f"{len(fmts)} formats for order-{arr.ndim} tensor")

        coords = np.argwhere(arr != 0)          # (nnz, d) sorted row-major
        vals = arr[tuple(coords.T)] if len(coords) else np.zeros(0)
        return FiberTree._from_sorted_coords(
            tuple(arr.shape), coords, np.asarray(vals, dtype=np.float64),
            fmts, tuple(mode_order))

    @staticmethod
    def from_coords(shape: Sequence[int], coords: np.ndarray, vals: np.ndarray,
                    formats: str | Sequence[str]) -> "FiberTree":
        """Build from (nnz, d) coordinates (need not be sorted).

        Duplicate full coordinates are representable only when some level
        is non-``unique`` (a COO fork); with all-unique level formats they
        are rejected with a ``ValueError``.
        """
        coords = np.asarray(coords).reshape(-1, len(shape))
        vals = np.asarray(vals, dtype=np.float64)
        key = np.lexsort(coords.T[::-1])
        coords, vals = coords[key], vals[key]
        fmts = [_FORMAT_ABBREV[f] for f in formats]
        return FiberTree._from_sorted_coords(tuple(shape), coords, vals, fmts,
                                             tuple(range(len(shape))))

    @staticmethod
    def _from_sorted_coords(shape, coords, vals, fmts, mode_order) -> "FiberTree":
        d = len(shape)
        levels: List[Level] = []
        nnz = len(coords)
        if nnz > 1 and d:
            dup = bool(np.any(np.all(coords[1:] == coords[:-1], axis=1)))
            if dup and all(LEVEL_SPECS[f].unique for f in fmts):
                raise ValueError(
                    "duplicate coordinates rejected by unique level formats "
                    f"{[_ABBREV_OF[f] for f in fmts]}; use a non-unique "
                    "level (singleton 's') to keep duplicates")

        # Parent fiber id of each nonzero at each level: group rows by the
        # coordinate prefix. Dense levels densify the prefix space.
        # We iterate top-down, tracking the set of fibers (unique prefixes).
        parent_ids = np.zeros(nnz, dtype=np.int64)   # fiber index per nonzero
        num_parents = 1
        for lvl in range(d):
            fmt = fmts[lvl]
            dim = shape[lvl]
            c = coords[:, lvl] if nnz else np.zeros(0, dtype=np.int64)
            if fmt == DENSE:
                levels.append(Level(format=DENSE, dim=dim))
                parent_ids = parent_ids * dim + c
                num_parents = num_parents * dim
            elif fmt in (COMPRESSED, HASHED):
                # fibers keyed by (parent_id); storage sorted within — a
                # hashed level keeps canonical sorted backing storage and
                # applies its slot order at iteration time (``fiber``)
                seg = np.zeros(num_parents + 1, dtype=np.int64)
                if nnz:
                    # unique (parent, coord) pairs are the stored entries
                    pair_key = parent_ids * (dim + 1) + c
                    uniq, inv = np.unique(pair_key, return_inverse=True)
                    up = uniq // (dim + 1)
                    uc = uniq % (dim + 1)
                    counts = np.bincount(up, minlength=num_parents)
                    seg[1:] = np.cumsum(counts)
                    levels.append(Level(format=fmt, dim=dim,
                                        seg=seg, crd=uc.astype(np.int64)))
                    parent_ids = inv.astype(np.int64)
                    num_parents = len(uniq)
                else:
                    levels.append(Level(format=fmt, dim=dim, seg=seg,
                                        crd=np.zeros(0, dtype=np.int64)))
                    num_parents = 0
            elif fmt == SINGLETON:
                # COO level: one entry per nonzero path, duplicates across
                # siblings kept (non-unique). Rows are sorted, so entries
                # stay in (parent, coordinate) order.
                seg = np.zeros(num_parents + 1, dtype=np.int64)
                if nnz:
                    counts = np.bincount(parent_ids, minlength=num_parents)
                    seg[1:] = np.cumsum(counts)
                    levels.append(Level(format=SINGLETON, dim=dim, seg=seg,
                                        crd=c.astype(np.int64)))
                    parent_ids = np.arange(nnz, dtype=np.int64)
                    num_parents = nnz
                else:
                    levels.append(Level(format=SINGLETON, dim=dim, seg=seg,
                                        crd=np.zeros(0, dtype=np.int64)))
                    num_parents = 0
            elif fmt in (BITVECTOR, BITMAP):
                nwords = -(-dim // BV_WIDTH)
                words = np.zeros((num_parents, nwords), dtype=np.uint64)
                if nnz:
                    pair_key = parent_ids * (dim + 1) + c
                    uniq, inv = np.unique(pair_key, return_inverse=True)
                    up = (uniq // (dim + 1)).astype(np.int64)
                    uc = (uniq % (dim + 1)).astype(np.int64)
                    for p, cc in zip(up, uc):
                        words[p, cc // BV_WIDTH] |= np.uint64(1 << (cc % BV_WIDTH))
                    levels.append(Level(format=fmt, dim=dim, words=words))
                    parent_ids = inv.astype(np.int64)
                    num_parents = len(uniq)
                else:
                    levels.append(Level(format=fmt, dim=dim, words=words))
                    num_parents = 0
            else:
                raise ValueError(fmt)

        # Leaf values: one per surviving (deepest-level) position. For dense
        # trailing levels the value array is densified with explicit zeros.
        if all(f != DENSE for f in fmts):
            out_vals = vals
        else:
            out_vals = np.zeros(max(num_parents, 0))
            if nnz:
                out_vals[parent_ids] = vals
        return FiberTree(shape=tuple(shape), levels=levels, vals=out_vals,
                         mode_order=mode_order)

    # -- conversions ---------------------------------------------------------
    def to_dense(self) -> np.ndarray:
        """Expand back to a dense array in the ORIGINAL (pre-mode-order) axes."""
        if self.order == 0:
            return np.asarray(self.vals[0])
        out = np.zeros(tuple(self.shape))
        for coord, v in self.items():
            out[coord] += v
        inv = np.argsort(self.mode_order)
        # self.shape is in storage order; undo the transpose
        return np.transpose(out, inv)

    def convert(self, formats: str | Sequence[str],
                merge_duplicates: bool = False) -> "FiberTree":
        """Re-lay this tensor under new level formats, bit-identically.

        Stored positions and their float64 values are carried over exactly
        (a round trip like c→s(COO)→c reproduces the original arrays bit
        for bit). ``merge_duplicates`` sums values at equal coordinates —
        the non-unique → unique direction; without it, duplicates from a
        singleton source are rejected by unique targets (``from_coords``
        semantics).

        >>> t = FiberTree.from_dense(np.array([[1., 0.], [2., 3.]]), "cc")
        >>> coo = t.convert("ss")
        >>> back = coo.convert("cc")
        >>> bool((back.levels[1].crd == t.levels[1].crd).all())
        True
        """
        if self.order == 0:
            return FiberTree(shape=(), levels=[], vals=self.vals.copy())
        fmts = [_FORMAT_ABBREV[f] for f in formats]
        if len(fmts) != self.order:
            raise ValueError(f"{len(fmts)} formats for order-{self.order}")
        coords, vals = [], []
        for cpath, v in self.items():
            coords.append(cpath)
            vals.append(v)
        coords = np.asarray(coords, dtype=np.int64).reshape(-1, self.order)
        vals = np.asarray(vals, dtype=np.float64)
        key = np.lexsort(coords.T[::-1])
        coords, vals = coords[key], vals[key]
        if merge_duplicates and len(coords) > 1:
            same = np.all(coords[1:] == coords[:-1], axis=1)
            group = np.concatenate([[0], np.cumsum(~same)])
            keep = np.concatenate([[True], ~same])
            merged_vals = np.bincount(group, weights=vals)
            coords, vals = coords[keep], merged_vals
        return FiberTree._from_sorted_coords(self.shape, coords, vals, fmts,
                                             self.mode_order)

    def items(self):
        """Yield ((c0, c1, ...), value) for every stored position.

        Iteration follows each level's native order (hash-slot order for
        hashed levels); duplicates of non-unique levels appear once per
        stored path.
        """
        def rec(lvl: int, ref: int, prefix: tuple):
            if lvl == self.order:
                yield prefix, float(self.vals[ref])
                return
            crds, refs = self.levels[lvl].fiber(ref)
            for c, r in zip(crds, refs):
                yield from rec(lvl + 1, int(r), prefix + (int(c),))
        yield from rec(0, 0, ())

    def root_fibers(self) -> int:
        return 1


def canonical_formats(ft: FiberTree) -> str:
    """Engine-native target formats: dense stays dense, the rest compress."""
    return "".join("d" if lv.format == DENSE else "c" for lv in ft.levels)


def canonical_tree(ft: FiberTree) -> FiberTree:
    """Canonicalize a tree to engine-native d/c levels.

    Trees that are already all-d/c pass through untouched. Unique levels
    (hashed, bitmap, bitvector) convert per-level via
    ``coord_ops.convert_level`` WITHOUT touching the value array (their
    storage is already in canonical child order, so the result is
    bit-identical). Trees with non-unique (singleton) levels need a whole
    -tree rebuild: duplicates at equal coordinates merge by summation,
    matching ``to_dense`` semantics.
    """
    if all(lv.format in (DENSE, COMPRESSED) for lv in ft.levels):
        return ft
    tgt = canonical_formats(ft)
    if any(not lv.spec.unique for lv in ft.levels):
        return ft.convert(tgt, merge_duplicates=True)
    from . import coord_ops as co
    levels: List[Level] = []
    num_parents = 1
    for lv in ft.levels:
        nl = co.convert_level(lv, num_parents)
        levels.append(nl)
        num_parents = (num_parents * nl.dim if nl.format == DENSE
                       else len(nl.crd))
    return FiberTree(shape=ft.shape, levels=levels, vals=ft.vals,
                     mode_order=ft.mode_order)
