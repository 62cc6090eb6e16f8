"""Pruned-transformer inference on the SAM engine, end to end.

The first workload where every subsystem fires on one model:

* **FFN** — magnitude-pruned ``W1``/``W2`` stored compressed; the up and
  down projections lower through ``compile_program`` with ``"auto"``
  schedules (the autoscheduler picks loop orders from the density hint)
  and hit the process-wide compiled cache, so layer 2 onward reuses
  layer 1's executables. The ReLU between them is not tensor algebra
  and runs between the programs (same split as ``models/moe_blocks.py``'s
  silu).
* **Attention** — a block-sparse causal sliding-window mask gates each
  head's ``O(i,d) = M(i,j) * Q(i,e) * K(j,e) * V(j,d)`` request, which
  ``SamServer`` admits through the ``core/bsr_bridge.py`` attention
  pattern (DESIGN.md §12) and executes on the fused streaming-softmax
  CUDA kernel (``bsr_attention``). Heads share one request key, so the
  serving loop coalesces them into a single batched dispatch.
* **Projections** — Q/K/V/O and the RMS norms are torch ops on the
  model's device in float32; the ReLU applies to the host array the down
  program consumes, as in the reference.

The model takes any registered ``ModelConfig`` (``qwen3_0_6b``'s or
``llama3_2_3b``'s ``REDUCED`` shapes are the tested entry points) and a
target FFN density. It runs inference shapes, it is not a checkpoint
loader: weights are randomly initialized then pruned, positions carry
no RoPE, and norms are plain RMS — the point is the dataflow, which is
exactly a pruned decoder block's.

A port of ``repro.models.pruned_transformer``: the same weights from the
same seed (numpy's ``default_rng``), so ``layers`` equal the reference's
bit for bit, and ``reference()`` is the same float64 numpy oracle. The
engine, the programs and the server are the port's, on ``device`` (CUDA
unless the caller names one; an error without a GPU).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core import coord_ops as co
from ..core.torch_backend import compile_program
from ..core.schedule import Format
from ..core.serving import FakeClock, Request, SamServer

__all__ = ["PrunedTransformer", "prune_magnitude", "block_causal_mask",
           "ATTN_EXPR"]

ATTN_EXPR = "O(i,d) = M(i,j) * Q(i,e) * K(j,e) * V(j,d)"
ATTN_FMT = Format({"M": "bb", "Q": "dd", "K": "dd", "V": "dd", "O": "dd"})

UP_PROGRAM = "H(t,f) = X(t,d) * W1(d,f)"
DOWN_PROGRAM = "O(t,g) = A(t,f) * W2(f,g)"
FFN_FMT = Format({"X": "dd", "W1": "dc", "A": "dd", "W2": "dc",
                  "H": "dd", "O": "dd"})


def prune_magnitude(w: np.ndarray, density: float) -> np.ndarray:
    """Keep the largest-|w| fraction ``density`` of entries, zero the rest."""
    if density >= 1.0:
        return w
    k = max(1, int(round(w.size * density)))
    thresh = np.partition(np.abs(w).ravel(), w.size - k)[w.size - k]
    return np.where(np.abs(w) >= thresh, w, 0.0)


def block_causal_mask(seq_len: int, block: int,
                      window_blocks: Optional[int] = None) -> np.ndarray:
    """(S, S) 0/1 mask, block-uniform at ``block`` granularity: causal at
    block level, optionally limited to a sliding window of
    ``window_blocks`` query-side blocks. Block-uniformity is what the
    bridge's attention admission requires (masked positions must align
    with whole blocks — DESIGN.md §12)."""
    nb = seq_len // block
    q = np.arange(nb)[:, None]
    kv = np.arange(nb)[None, :]
    keep = kv <= q
    if window_blocks is not None:
        keep &= (q - kv) < window_blocks
    return np.kron(keep, np.ones((block, block))).astype(np.float32)


def _rms(x: np.ndarray) -> np.ndarray:
    return x / np.sqrt(np.mean(x * x, axis=-1, keepdims=True) + 1e-6)


def _rms_torch(x: torch.Tensor) -> torch.Tensor:
    return x / torch.sqrt(torch.mean(x * x, dim=-1, keepdim=True) + 1e-6)


class PrunedTransformer:
    """Run ``cfg.n_layers`` pruned decoder blocks on the SAM engine.

    Args:
        cfg: a ``ModelConfig`` (use a ``REDUCED`` variant; ``d_model``,
            ``n_heads``, ``n_kv_heads``, ``head_dim``, ``d_ff`` and
            ``n_layers`` are read).
        seq_len: token count per forward; must divide by ``block``.
        block: attention mask block size.
        window_blocks: sliding-window width in blocks (None = full causal).
        ffn_density: fraction of FFN weights kept by magnitude pruning.
        seed: parameter init seed.
        use_kernels: forwarded to ``compile_program``.
        device: where the projections, the programs and the server run:
            CUDA by default, an error without a GPU; ``"cpu"`` for the
            plain PyTorch versions.
    """

    def __init__(self, cfg: ModelConfig, *, seq_len: int = 32,
                 block: int = 8, window_blocks: Optional[int] = 2,
                 ffn_density: float = 0.5, seed: int = 0,
                 use_kernels: bool = True, device=None):
        if seq_len % block:
            raise ValueError("seq_len must be a multiple of block")
        if cfg.head_dim is None:
            raise ValueError("cfg.head_dim is required")
        self.cfg, self.seq_len, self.block = cfg, seq_len, block
        self.device = co.resolve_device(device)
        self.mask = block_causal_mask(seq_len, block, window_blocks)
        rng = np.random.default_rng(seed)
        d, hd = cfg.d_model, cfg.head_dim
        nh, nkv, ff = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff

        def init(*shape):
            return (rng.standard_normal(shape) / np.sqrt(shape[0])
                    ).astype(np.float32)

        self.layers = [{
            "wq": init(d, nh * hd), "wk": init(d, nkv * hd),
            "wv": init(d, nkv * hd), "wo": init(nh * hd, d),
            "w1": prune_magnitude(init(d, ff), ffn_density),
            "w2": prune_magnitude(init(ff, d), ffn_density),
        } for _ in range(cfg.n_layers)]
        self._proj = [{k: torch.as_tensor(p[k], device=self.device)
                       for k in ("wq", "wk", "wv", "wo")}
                      for p in self.layers]

        dims = {"t": seq_len, "d": d, "f": ff, "g": d}
        sp = {"W1": ffn_density, "W2": ffn_density}
        kw = {"sparsity": sp, "use_kernels": use_kernels,
              "device": self.device}
        self.ffn_up = compile_program(UP_PROGRAM, FFN_FMT, "auto", dims, **kw)
        self.ffn_down = compile_program(DOWN_PROGRAM, FFN_FMT, "auto", dims,
                                        **kw)
        self.server = SamServer(sync=True, clock=FakeClock(),
                                max_batch=cfg.n_heads, device=self.device)

    # -- blocks ------------------------------------------------------------
    def _attention(self, p: Dict[str, torch.Tensor], x: torch.Tensor
                   ) -> torch.Tensor:
        cfg, s = self.cfg, self.seq_len
        hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
        q = (x @ p["wq"]).reshape(s, nh, hd).cpu().numpy()
        k = (x @ p["wk"]).reshape(s, nkv, hd).cpu().numpy()
        v = (x @ p["wv"]).reshape(s, nkv, hd).cpu().numpy()
        group = nh // nkv
        handles = [self.server.submit(Request(
            ATTN_EXPR,
            {"M": self.mask, "Q": np.ascontiguousarray(q[:, h]),
             "K": np.ascontiguousarray(k[:, h // group]),
             "V": np.ascontiguousarray(v[:, h // group])},
            formats=ATTN_FMT)) for h in range(nh)]
        self.server.flush()
        out = np.stack([h.result().to_dense() for h in handles], axis=1)
        return self._on_device(out.reshape(s, nh * hd)) @ p["wo"]

    def _ffn(self, p: Dict[str, np.ndarray], x: torch.Tensor
             ) -> torch.Tensor:
        h = self.ffn_up({"X": x.cpu().numpy(), "W1": p["w1"]})["H"]
        a = np.maximum(h.to_dense(), 0.0)
        o = self.ffn_down({"A": a, "W2": p["w2"]})["O"]
        return self._on_device(o.to_dense())

    def _on_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    # -- forward -----------------------------------------------------------
    def __call__(self, x: np.ndarray) -> np.ndarray:
        """x: (seq_len, d_model) float32 -> (seq_len, d_model) float32."""
        x = self._on_device(np.asarray(x, dtype=np.float32))
        for p, proj in zip(self.layers, self._proj):
            x = x + self._attention(proj, _rms_torch(x))
            x = x + self._ffn(p, _rms_torch(x))
        return x.cpu().numpy()

    def reference(self, x: np.ndarray) -> np.ndarray:
        """Dense numpy oracle of the same computation (same pruned
        weights, same block mask) for conformance checks."""
        x = np.asarray(x, dtype=np.float64)
        cfg, s = self.cfg, self.seq_len
        hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
        group = nh // nkv
        for p in self.layers:
            xn = _rms(x)
            q = (xn @ p["wq"]).reshape(s, nh, hd)
            k = (xn @ p["wk"]).reshape(s, nkv, hd)
            v = (xn @ p["wv"]).reshape(s, nkv, hd)
            outs = []
            for h in range(nh):
                sc = q[:, h] @ k[:, h // group].T / np.sqrt(hd)
                sc = np.where(self.mask > 0, sc, -np.inf)
                w = np.exp(sc - sc.max(axis=1, keepdims=True))
                w = w / w.sum(axis=1, keepdims=True)
                outs.append(w @ v[:, h // group])
            x = x + np.stack(outs, 1).reshape(s, nh * hd) @ p["wo"]
            xn = _rms(x)
            x = x + np.maximum(xn @ p["w1"], 0.0) @ p["w2"]
        return x

    def stats(self) -> Dict[str, object]:
        return {"server": self.server.stats(),
                "ffn_up_calls": self.ffn_up.stats["calls"],
                "ffn_down_calls": self.ffn_down.stats["calls"]}

    def close(self) -> None:
        self.server.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
