"""Block-format (``b``) contraction bridge onto the BSR kernels.

The counterpart of ``repro.core.bsr_bridge``. The compiled streaming
engine serves ``d``/``c`` level formats; tensors declared all-``b`` store
sparsity at BLOCK granularity, the hierarchical split the paper applies to
fit finite memories (§4.1). ``torch_backend.compile_expr`` recognizes the
three canonical block-sparse contractions here and routes them to a
``BsrEngine`` instead of refusing:

* **SpMM**: ``x(i,k) = B(i,j) * C(j,k)`` with ``B`` all-``b``. ``B``
  blockifies to BCSR and every surviving block multiplies the dense
  right-hand side (``kernels/spmm_bsr.py``).
* **SDDMM**: ``X(i,j) = M(i,j) * A(i,k) * C(j,k)`` with ``M`` all-``b``.
  The dense product is computed ONLY at ``M``'s nonzero blocks
  (``kernels/sddmm_bsr.py``), then scaled elementwise by the mask block
  values.
* **Attention**: ``O(i,d) = M(i,j) * Q(i,e) * K(j,e) * V(j,d)`` with
  ``M`` all-``b``: the SDDMM -> softmax -> SpMM pipeline fused into
  ``kernels/bsr_attention.py``. ``M``'s nonzero BLOCKS gate which
  (q, kv) block pairs are visited (block values do not scale scores), the
  sampled scores pass through a ``1/sqrt(e)``-scaled streaming softmax per
  query row, and rows whose every block is masked produce zeros. Masking
  is block-granular.

Either dense factor may list its indices in the transposed order (e.g.
``C(k,j)``); the bridge re-arranges host-side. The block size is the
largest power-of-two divisor common to the blocked extents (capped at
128), so any extents work; degenerate 1x1 blocks recover element-granular
COO.

The pattern half (``bsr_pattern``, ``_blockify``, ``_mask_block_size``,
``_kv_index``) and the dtype-preserving numpy fallbacks are copies of the
reference's, so both packages blockify the same operands into the same
arrays. **Dtype discipline**, as in the reference: the kernels accumulate
in float32, so only float32 operands take the kernel path, on the
engine's device; every other dtype (float64 above all) runs the numpy
fallback in the operands' own dtype, and attention with ``E != Dv`` falls
back too. Each fallback counts in ``stats["fallback_calls"]``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops as kops
from ..kernels.bsr_attention import bsr_flash_attention
from ..kernels.sddmm_bsr import sddmm_bsr
from ..kernels.spmm_bsr import spmm_bsr
from . import coord_ops as co
from .einsum import Access, Assignment
from .fibertree import FiberTree
from .schedule import Format

# the kernels accumulate in f32; only these operand dtypes stay bit-exact
# through the kernel path, everything else computes on the numpy fallback
# in its own dtype
_KERNEL_DTYPES = (np.float32,)


def _is_block(fmt: Format, acc: Access) -> bool:
    levels = fmt.of(acc.tensor, len(acc.vars)) or ""
    return len(acc.vars) == 2 and levels == "b" * len(acc.vars)


def _pow2_divisor(n: int, cap: int) -> int:
    """Largest power of two dividing ``n``, at most ``cap`` (>= 1)."""
    n = int(n)
    d = n & -n if n else 1
    return max(1, min(d, cap))


@dataclasses.dataclass(frozen=True)
class BsrPattern:
    """A recognized block-sparse contraction (see module docstring)."""
    kind: str                    # "spmm" | "sddmm" | "attention"
    sparse: str                  # the all-``b`` operand
    dense: Tuple[str, ...]       # dense operand(s), kernel argument order
    transposed: Tuple[bool, ...]  # per dense operand: stored transposed?
    red_var: str                 # the contracted index variable (for
    #                              attention: the score contraction ``e``)


def bsr_pattern(assign: Assignment, fmt: Format) -> Optional[BsrPattern]:
    """Match ``assign`` against the bridged block-sparse contractions.

    Returns a ``BsrPattern`` when the expression is a single positive
    product term in SpMM, SDDMM, or block-attention shape with exactly
    one rank-2 all-``b`` factor (every other operand ``d``/``c``); None
    otherwise — callers fall back to their normal handling.
    """
    if len(assign.terms) != 1 or assign.terms[0].sign != 1:
        return None
    term = assign.terms[0]
    if len(assign.lhs.vars) != 2:
        return None
    sparse = [f for f in term.factors if _is_block(fmt, f)]
    rest = [f for f in term.factors if not _is_block(fmt, f)]
    if len(sparse) != 1:
        return None
    for f in rest:
        if set(fmt.of(f.tensor, len(f.vars)) or "") - set("dc"):
            return None
    s = sparse[0]
    red = [v for v in term.vars if v not in assign.lhs.vars]
    ri, rj = assign.lhs.vars

    if len(red) == 1:
        k = red[0]
        if len(term.factors) == 2 and len(rest) == 1:
            # SpMM: x(i,k) = B(i,j) * C(j,k) — B block-sparse over the
            # output rows × contraction, C dense over contraction × cols
            d = rest[0]
            if s.vars == (ri, k) and set(d.vars) == {k, rj}:
                return BsrPattern("spmm", s.tensor, (d.tensor,),
                                  (d.vars != (k, rj),), k)
            return None

        if len(term.factors) == 3 and len(rest) == 2:
            # SDDMM: X(i,j) = M(i,j) * A(i,k) * C(j,k) — M samples the
            # output blocks, A carries the output rows, C the cols
            if s.vars != (ri, rj):
                return None
            a = [f for f in rest if ri in f.vars and k in f.vars]
            c = [f for f in rest if rj in f.vars and k in f.vars]
            if len(a) != 1 or len(c) != 1:
                return None
            return BsrPattern("sddmm", s.tensor,
                              (a[0].tensor, c[0].tensor),
                              (a[0].vars != (ri, k), c[0].vars != (rj, k)),
                              k)
        return None

    if len(red) == 2 and len(term.factors) == 4 and len(rest) == 3:
        # attention: O(i,d) = M(i,j) * Q(i,e) * K(j,e) * V(j,d) — M's
        # blocks gate which (q block, kv block) pairs the fused
        # SDDMM→softmax→SpMM kernel visits (module docstring)
        if len(set(s.vars)) != 2 or ri not in s.vars:
            return None
        j = s.vars[1] if s.vars[0] == ri else s.vars[0]
        if s.vars != (ri, j) or j not in red:
            return None
        (e,) = [v for v in red if v != j]
        q = [f for f in rest if set(f.vars) == {ri, e}]
        kk = [f for f in rest if set(f.vars) == {j, e}]
        v = [f for f in rest if set(f.vars) == {j, rj}]
        if len(q) != 1 or len(kk) != 1 or len(v) != 1:
            return None
        return BsrPattern(
            "attention", s.tensor,
            (q[0].tensor, kk[0].tensor, v[0].tensor),
            (q[0].vars != (ri, e), kk[0].vars != (j, e),
             v[0].vars != (j, rj)), e)
    return None


def _blockify(m: np.ndarray, bs: int
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(rows, cols, blocks) of the nonzero ``bs × bs`` blocks of ``m``."""
    nr, nc = m.shape[0] // bs, m.shape[1] // bs
    tiles = m.reshape(nr, bs, nc, bs).transpose(0, 2, 1, 3)
    mask = np.any(tiles != 0, axis=(2, 3))
    rows, cols = np.nonzero(mask)
    return rows, cols, np.ascontiguousarray(tiles[rows, cols])


def _mask_block_size(sp: np.ndarray, cap: int = 128) -> int:
    """Largest power-of-two block size at which the attention mask is
    block-UNIFORM (every tile all-zero or all-nonzero). Unlike
    SpMM/SDDMM — where block values ride along and any covering works —
    the attention mask GATES whole blocks, so a coarser-than-uniform
    blocking would silently admit masked positions."""
    bs = _pow2_divisor(np.gcd(sp.shape[0], sp.shape[1]), cap)
    nz = sp != 0
    while bs > 1:
        t = nz.reshape(sp.shape[0] // bs, bs, sp.shape[1] // bs, bs)
        per_tile = t.sum(axis=(1, 3))
        if np.all((per_tile == 0) | (per_tile == bs * bs)):
            break
        bs //= 2
    return bs


def _kv_index(rows: np.ndarray, cols: np.ndarray, n_qblk: int,
              n_kvblk: int) -> np.ndarray:
    """Block mask COO -> padded per-q-block kv slot map (the
    ``bsr_flash_attention`` BCSR layout; pad slots carry the out-of-range
    sentinel ``n_kvblk``, which masks the whole slot)."""
    counts = np.bincount(rows, minlength=n_qblk)
    max_kv = max(int(counts.max(initial=0)), 1)
    idx = np.full((n_qblk, max_kv), n_kvblk, dtype=np.int32)
    order = np.argsort(rows, kind="stable")
    row_start = np.zeros(n_qblk, dtype=np.int64)
    row_start[1:] = np.cumsum(counts)[:-1]
    slot = np.arange(len(rows)) - row_start[rows[order]]
    idx[rows[order], slot] = cols[order]
    return idx


# -- dtype-preserving numpy fallbacks (non-f32 operands) ---------------------

def _spmm_numpy(rows, cols, blocks, c, n_brow: int, bs: int) -> np.ndarray:
    """Blockified SpMM in the operands' own dtype."""
    dt = np.result_type(blocks.dtype, c.dtype)
    n = c.shape[1]
    out = np.zeros((n_brow, bs, n), dt)
    if len(rows):
        cb = np.ascontiguousarray(c).reshape(c.shape[0] // bs, bs, n)
        contrib = np.einsum("nij,njk->nik", blocks.astype(dt),
                            cb[cols].astype(dt))
        np.add.at(out, rows, contrib)
    return out.reshape(n_brow * bs, n)


def _sddmm_numpy(rows, cols, a, c, bs: int) -> np.ndarray:
    """Sampled block products ``A_blk @ C_blk^T`` in the own dtype."""
    dt = np.result_type(a.dtype, c.dtype)
    ab = np.ascontiguousarray(a).reshape(a.shape[0] // bs, bs, a.shape[1])
    cb = np.ascontiguousarray(c).reshape(c.shape[0] // bs, bs, c.shape[1])
    if not len(rows):
        return np.zeros((0, bs, bs), dt)
    return np.einsum("nik,njk->nij", ab[rows].astype(dt),
                     cb[cols].astype(dt))


def _attention_numpy(q, k, v, rows, cols, bs: int, scale: float
                     ) -> np.ndarray:
    """Block-masked softmax attention in the operands' own dtype, with
    the kernel's conventions: masked scores at -inf, fully-masked query
    rows produce zeros."""
    dt = np.result_type(q.dtype, k.dtype, v.dtype)
    n_qblk, n_kvblk = q.shape[0] // bs, k.shape[0] // bs
    allow = np.zeros((n_qblk, n_kvblk), bool)
    allow[rows, cols] = True
    allow = np.repeat(np.repeat(allow, bs, axis=0), bs, axis=1)
    scores = (q.astype(dt) @ k.astype(dt).T) * dt.type(scale)
    scores = np.where(allow, scores, -np.inf)
    m = np.max(scores, axis=1, keepdims=True)
    m = np.where(np.isfinite(m), m, 0.0)              # all-masked rows
    p = np.where(allow, np.exp(scores - m), 0.0)
    l = np.sum(p, axis=1, keepdims=True)
    out = p @ v.astype(dt)
    return np.divide(out, l, out=np.zeros_like(out), where=l > 0)


class BsrEngine:
    """Executes one bridged block-sparse contraction (see ``bsr_pattern``).

    The operands are blockified on the host, uploaded to ``device`` (CUDA
    by default) and run through the kernel; the result comes back in ONE
    host transfer and is assembled with ``FiberTree.from_dense`` in the
    LHS format, so downstream consumers see exactly what the streaming
    engine would return for the same dense result. Operand dtypes are
    PRESERVED: float32 runs the kernels, anything else the blockified
    numpy fallback in its own dtype (module docstring). On a CPU device
    the kernels' wrappers run their plain PyTorch versions.
    """

    def __init__(self, assign: Assignment, fmt: Format,
                 dims: Dict[str, int], pattern: BsrPattern, *,
                 device=None):
        self.device = co.resolve_device(device)
        self.assign = assign
        self.fmt = fmt
        self.dims = dict(dims)
        self.pattern = pattern
        lhs = assign.lhs
        self._out_fmt = fmt.of(lhs.tensor, len(lhs.vars)) or ""
        # API parity with CompiledExpr for the serving paths: block
        # contractions have no parallel lanes to shard
        self._shard_lanes = False
        self.stats = {"calls": 0, "batch_calls": 0, "nnz_blocks": 0,
                      "kernel": pattern.kind, "block_size": 0,
                      "fallback_calls": 0}

    # -- execution -------------------------------------------------------
    def _dense_operand(self, arrays, idx: int) -> np.ndarray:
        m = np.asarray(arrays[self.pattern.dense[idx]])
        return np.ascontiguousarray(m.T) if self.pattern.transposed[idx] \
            else m

    def _use_kernel(self, *operands: np.ndarray) -> bool:
        """Kernel path iff every operand is bit-exact through the f32
        accumulators; otherwise the dtype-preserving fallback."""
        return all(o.dtype in _KERNEL_DTYPES for o in operands)

    def _up(self, a: np.ndarray) -> torch.Tensor:
        """Upload one host operand to the engine's device."""
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    @staticmethod
    def _down(t: torch.Tensor) -> np.ndarray:
        """The call's one device-to-host transfer: the result."""
        return t.cpu().numpy()

    def __call__(self, arrays: Dict[str, np.ndarray]) -> FiberTree:
        self.stats["calls"] += 1
        p = self.pattern
        sp = np.asarray(arrays[p.sparse])
        bs = (_mask_block_size(sp) if p.kind == "attention"
              else _pow2_divisor(np.gcd(sp.shape[0], sp.shape[1]), 128))
        rows, cols, blocks = _blockify(sp, bs)
        if p.kind == "spmm":
            c = self._dense_operand(arrays, 0)           # (K, N)
            if self._use_kernel(sp, c):
                bm, ci, bp = kops.bsr_from_block_coords(
                    rows, cols, blocks, sp.shape[0] // bs)
                out = self._down(spmm_bsr(self._up(bm), self._up(ci),
                                          self._up(bp), self._up(c)))
            else:
                self.stats["fallback_calls"] += 1
                out = _spmm_numpy(rows, cols, blocks, c,
                                  sp.shape[0] // bs, bs)
        elif p.kind == "sddmm":
            a = self._dense_operand(arrays, 0)           # (M, K)
            c = self._dense_operand(arrays, 1)           # (N, K)
            nr, nc = sp.shape[0] // bs, sp.shape[1] // bs
            if self._use_kernel(sp, a, c):
                r_t = self._up(rows.astype(np.int32))
                c_t = self._up(cols.astype(np.int32))
                sampled = sddmm_bsr(r_t, c_t, self._up(a), self._up(c), bs)
                # SDDMM scales the sampled dense product by the mask
                # values, and the tiles are laid out on the device
                tiles = torch.zeros((nr, nc, bs, bs), dtype=sampled.dtype,
                                    device=self.device)
                tiles[r_t.long(), c_t.long()] = sampled * self._up(blocks)
                out = self._down(tiles.permute(0, 2, 1, 3).reshape(sp.shape))
            else:
                self.stats["fallback_calls"] += 1
                sampled = _sddmm_numpy(rows, cols, a, c, bs) * blocks
                tiles = np.zeros((nr, nc, bs, bs), sampled.dtype)
                tiles[rows, cols] = sampled
                out = tiles.transpose(0, 2, 1, 3).reshape(sp.shape)
        else:                                            # attention
            q = self._dense_operand(arrays, 0)           # (Sq, E)
            k = self._dense_operand(arrays, 1)           # (Skv, E)
            v = self._dense_operand(arrays, 2)           # (Skv, Dv)
            # the fused kernel streams one head-dim-wide accumulator, so
            # it needs E == Dv; mismatched extents fall back like dtypes
            if self._use_kernel(sp, q, k, v) and q.shape[1] == v.shape[1]:
                kv_idx = _kv_index(rows, cols, sp.shape[0] // bs,
                                   sp.shape[1] // bs)
                # scale=None: the kernel's default is this same 1/sqrt(E)
                out = self._down(bsr_flash_attention(
                    self._up(q)[None], self._up(k)[None], self._up(v)[None],
                    self._up(kv_idx), bq=bs, bkv=bs)[0])
            else:
                self.stats["fallback_calls"] += 1
                scale = 1.0 / float(q.shape[1]) ** 0.5
                out = _attention_numpy(q, k, v, rows, cols, bs, scale)
        self.stats["nnz_blocks"] = int(len(rows))
        self.stats["block_size"] = int(bs)
        return FiberTree.from_dense(out, self._out_fmt)

    def execute(self, arrays: Dict[str, np.ndarray]) -> FiberTree:
        """Alias of ``__call__`` (API parity with ``CompiledExpr``)."""
        return self(arrays)

    def execute_batch(self, arrays_list: Sequence[Dict[str, np.ndarray]]
                      ) -> List[FiberTree]:
        self.stats["batch_calls"] += 1
        return [self(a) for a in arrays_list]

    execute_many = execute_batch
