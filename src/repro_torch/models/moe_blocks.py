"""MoE model blocks expressed as multi-stage SAM programs.

The paper's central expressiveness claim — SAM graphs carry whole
scheduled sparse-tensor-algebra workloads — applied to the MoE layer of
``models/moe.py``: token routing becomes a *sparse dispatch* where the
top-k one-hot gate ``G`` is a compressed rank-3 tensor and the whole
``dispatch -> expert GEMM -> combine`` pipeline lowers through
``parse_program``/``compile_program``:

    Y(e,c,d) = G(e,c,t) * X(t,d)       # dispatch: gather tokens per slot
    H(e,c,f) = Y(e,c,d) * Wu(e,d,f)    # per-expert up projection
    Z(e,c,g) = H(e,c,f) * Wd(e,f,g)    # per-expert down projection
    O(t,g)   = S(t,e,c) * Z(e,c,g)     # combine: weighted scatter back

``e`` indexes experts, ``c`` capacity slots, ``t`` tokens, ``d``/``g``
d_model and ``f`` d_ff. With expert-major schedules the first three
stages fuse into ONE cascade (``FusionDecision.fused`` for Y and H):
the dispatch's and up-projection's outputs are never materialized — the
per-expert weight's dense expert level co-iterates with the
intermediate's outer mode, which DESIGN.md §6's dense-intersect
pass-through admits. The combine stage always materializes: it
re-orders from expert-major (e,c) to token-major t, a genuine transpose
barrier.

Capacity-drop semantics (DESIGN.md §12): each expert owns ``capacity``
slots; a token routed to a full expert is dropped from that expert
(``G``/``S`` simply have no entry), matching ``moe_sam_dispatch``'s
finite-memory crop. With ``capacity >= max expert load`` nothing drops
and the block is bit-identical to the dense one-hot reference on
integer data.

``MoEBlock`` runs the full SwiGLU layer (gate + up + silu + down) as
three compiled SAM programs with the single non-algebraic op (silu)
applied host-side between them.

A copy of ``repro.models.moe_blocks`` for the PyTorch port: the program
texts, formats, schedules, ``routing_tensors`` and the numpy oracles are
unchanged; ``compile_moe_block`` and ``MoEBlock`` compile on the port's
``compile_program`` and take ``device=`` (CUDA unless the caller names
one; an error without a GPU).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core.torch_backend import CompiledProgram, compile_program
from ..core.schedule import Format, Schedule
from . import moe

__all__ = [
    "MOE_PROGRAM", "moe_formats", "moe_schedules", "moe_dims",
    "routing_tensors", "moe_linear_reference", "moe_swiglu_reference",
    "compile_moe_block", "MoEBlock",
]

# the linear 4-stage chain (conformance + fused-vs-staged benchmarks)
MOE_PROGRAM = ("Y(e,c,d) = G(e,c,t) * X(t,d); "
               "H(e,c,f) = Y(e,c,d) * Wu(e,d,f); "
               "Z(e,c,g) = H(e,c,f) * Wd(e,f,g); "
               "O(t,g) = S(t,e,c) * Z(e,c,g)")

# SwiGLU split into three programs: the elementwise silu between the up
# and down projections is not tensor algebra, so the layer runs as
# dispatch+gate / dispatch+up (each a fused 2-stage cascade) and
# down+combine, with the activation applied on the host in between.
GATE_PROGRAM = ("Y(e,c,d) = G(e,c,t) * X(t,d); "
                "Hg(e,c,f) = Y(e,c,d) * Wg(e,d,f)")
UP_PROGRAM = ("Y(e,c,d) = G(e,c,t) * X(t,d); "
              "Hu(e,c,f) = Y(e,c,d) * Wu(e,d,f)")
DOWN_PROGRAM = ("Z(e,c,g) = A(e,c,f) * Wd(e,f,g); "
                "O(t,g) = S(t,e,c) * Z(e,c,g)")


def moe_formats() -> Format:
    """Per-tensor formats: routing tensors and intermediates compressed
    (fusion requires all-'c' intermediates), weights/activations dense."""
    return Format({"G": "ccc", "S": "ccc", "X": "dd", "A": "ddd",
                   "Wg": "ddd", "Wu": "ddd", "Wd": "ddd",
                   "Y": "ccc", "Hg": "ccc", "Hu": "ccc", "H": "ccc",
                   "Z": "ccc", "O": "dd"})


def moe_schedules() -> Dict[str, Schedule]:
    """Expert-major loop orders. The producer emits (e,c,...) and every
    fused consumer iterates the intermediate's modes in that order —
    the mode-order condition of DESIGN.md §6."""
    return {"Y": Schedule(loop_order=("e", "c", "t", "d")),
            "Hg": Schedule(loop_order=("e", "c", "d", "f")),
            "Hu": Schedule(loop_order=("e", "c", "d", "f")),
            "H": Schedule(loop_order=("e", "c", "d", "f")),
            "Z": Schedule(loop_order=("e", "c", "f", "g")),
            "O": Schedule(loop_order=("t", "e", "c", "g"))}


def moe_dims(n_experts: int, capacity: int, n_tokens: int,
             d_model: int, d_ff: int) -> Dict[str, int]:
    return {"e": n_experts, "c": capacity, "t": n_tokens,
            "d": d_model, "f": d_ff, "g": d_model}


def routing_tensors(weights, ids, n_experts: int, capacity: int
                    ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Build the sparse dispatch/combine tensors from top-k routing.

    Args:
        weights: (T, k) normalized routing weights (``route_topk``).
        ids: (T, k) int expert assignments.
        n_experts: number of experts E.
        capacity: slots per expert C; overflow tokens are dropped.

    Returns:
        ``(G, S, n_dropped)`` — ``G`` (E, C, T) one-hot dispatch,
        ``S`` (T, E, C) combine weights, and the number of (token,
        expert) pairs dropped by the capacity crop. Slots fill in token
        order, matching ``moe_sam_dispatch``'s stable sort.
    """
    w = np.asarray(weights, dtype=np.float64)
    ids = np.asarray(ids, dtype=np.int64)
    n_tokens, k = ids.shape
    G = np.zeros((n_experts, capacity, n_tokens))
    S = np.zeros((n_tokens, n_experts, capacity))
    fill = np.zeros(n_experts, dtype=np.int64)
    dropped = 0
    for t in range(n_tokens):
        for j in range(k):
            e = int(ids[t, j])
            if fill[e] >= capacity:
                dropped += 1
                continue
            c = int(fill[e])
            fill[e] += 1
            G[e, c, t] = 1.0
            S[t, e, c] = w[t, j]
    return G, S, dropped


def moe_linear_reference(G, S, X, Wu, Wd) -> Dict[str, np.ndarray]:
    """Dense numpy oracle of ``MOE_PROGRAM`` (every stage's result).
    Capacity drops are inherent to ``G``/``S``, so the oracle and the
    SAM program agree exactly for any capacity."""
    Y = np.einsum("ect,td->ecd", G, X)
    H = np.einsum("ecd,edf->ecf", Y, Wu)
    Z = np.einsum("ecf,efg->ecg", H, Wd)
    O = np.einsum("tec,ecg->tg", S, Z)
    return {"Y": Y, "H": H, "Z": Z, "O": O}


def _silu(x: np.ndarray) -> np.ndarray:
    return x / (1.0 + np.exp(-x))


def moe_swiglu_reference(p: dict, x, G, S) -> np.ndarray:
    """Dense SwiGLU oracle applying the same keep-mask as ``G``/``S`` —
    equals ``moe_dense_dispatch`` (f32 compute) whenever nothing drops."""
    xe = np.einsum("ect,td->ecd", G, np.asarray(x, dtype=np.float64))
    g = np.einsum("ecd,edf->ecf", xe, np.asarray(p["w_gate"], np.float64))
    u = np.einsum("ecd,edf->ecf", xe, np.asarray(p["w_up"], np.float64))
    h = _silu(g) * u
    y = np.einsum("ecf,efd->ecd", h, np.asarray(p["w_down"], np.float64))
    return np.einsum("tec,ecg->tg", S, y)


def compile_moe_block(n_experts: int, capacity: int, n_tokens: int,
                      d_model: int, d_ff: int, *, fuse: bool = True,
                      use_kernels: bool = True,
                      mem_budget=None, device=None) -> CompiledProgram:
    """Compile the linear 4-stage MoE chain (``MOE_PROGRAM``) for one
    shape. With ``fuse=True`` the dispatch and both projections run as
    one cascade; ``fuse=False`` is the staged comparison baseline.

    >>> import numpy as np
    >>> cp = compile_moe_block(2, 2, 4, 3, 3, device="cpu")
    >>> [d.fused for d in cp.decisions]    # Y, H fuse; combine is a barrier
    [True, True, False]
    >>> G, S, n = routing_tensors(np.full((4, 1), 1.0),
    ...                           np.array([[0], [1], [0], [1]]), 2, 2)
    >>> X = np.arange(12.).reshape(4, 3)
    >>> W = np.stack([np.eye(3)] * 2)
    >>> out = cp({"G": G, "S": S, "X": X, "Wu": W, "Wd": W})
    >>> np.array_equal(out["O"].to_dense(), X)   # identity experts
    True
    """
    return compile_program(MOE_PROGRAM, moe_formats(), moe_schedules(),
                           moe_dims(n_experts, capacity, n_tokens,
                                    d_model, d_ff),
                           fuse=fuse, use_kernels=use_kernels,
                           mem_budget=mem_budget, device=device)


class MoEBlock:
    """The full SwiGLU MoE layer as three compiled SAM programs.

    ``dispatch+gate`` and ``dispatch+up`` each compile to a fused
    2-stage cascade; silu runs host-side (not tensor algebra); the
    ``down+combine`` program materializes its handoff (token-major
    re-order). Programs compile once per shape and hit the process-wide
    compiled cache across instances.
    """

    def __init__(self, n_experts: int, capacity: int, n_tokens: int,
                 d_model: int, d_ff: int, *, use_kernels: bool = True,
                 fuse: bool = True, device=None):
        self.n_experts, self.capacity = n_experts, capacity
        self.n_tokens = n_tokens
        fmt, sch = moe_formats(), moe_schedules()
        dims = moe_dims(n_experts, capacity, n_tokens, d_model, d_ff)
        kw = {"fuse": fuse, "use_kernels": use_kernels, "device": device}
        self.gate = compile_program(GATE_PROGRAM, fmt, sch, dims, **kw)
        self.up = compile_program(UP_PROGRAM, fmt, sch, dims, **kw)
        self.down = compile_program(DOWN_PROGRAM, fmt, sch, dims, **kw)
        self.device = self.gate.device
        self.last_dropped: Optional[int] = None

    def __call__(self, p: dict, x, *, k: int) -> np.ndarray:
        """Route ``x`` (T, D) with ``p['router']`` (on the block's device)
        and run the layer. Returns the (T, D) output as float64 numpy."""
        x = np.asarray(x, dtype=np.float64)
        w, ids = moe.route_topk(
            torch.as_tensor(np.asarray(p["router"], np.float32),
                            device=self.device),
            torch.as_tensor(x.astype(np.float32), device=self.device), k)
        G, S, self.last_dropped = routing_tensors(
            w.cpu().numpy(), ids.cpu().numpy(), self.n_experts,
            self.capacity)
        hg = self.gate({"G": G, "X": x,
                        "Wg": np.asarray(p["w_gate"], np.float64)})
        hu = self.up({"G": G, "X": x,
                      "Wu": np.asarray(p["w_up"], np.float64)})
        a = _silu(hg["Hg"].to_dense()) * hu["Hu"].to_dense()
        out = self.down({"A": a, "S": S,
                         "Wd": np.asarray(p["w_down"], np.float64)})
        return out["O"].to_dense()
