#!/usr/bin/env python3
"""How far the sequence read of a placed cache moves from the plain read
in bfloat16 compute: the readings that ``BF16_TOL`` in
``tests/test_torch_sequence_read.py`` is set from.

Usage (PYTHONPATH=src; on the CPU, a few seconds):

    python3 tools/sequence_read_bf16.py [--seeds 5]

The sequence read (``attention.sequence_read``, ``mla.mla_sequence_read``)
keeps its probabilities, and MLA its folded queries, in float32 up to
the merge of the shards' partials; the plain read (``attention._core``,
``mla._core``), as the reference, rounds the probabilities (and MLA's
``c_kv · wkv_b``) to the compute dtype. For the test file's cases (split
heads, 6 heads over 4 shards, MQA, GQA, one and three new tokens; MLA
with the heads split and whole), each on M threads standing for the
model axis, with inputs drawn in float32 from ``--seeds`` seeds and cast
to bfloat16, prints as JSON the largest relative difference (over the
output's largest magnitude) of the sequence read against the plain
read, and of each against the float32 plain read.
"""
from __future__ import annotations

import argparse
import json
import threading

import torch

from repro_torch.models import attention as A
from repro_torch.models import mla as MLA

B, MAX_SEQ, HD = 2, 16, 8
POS = torch.tensor([5, 9], dtype=torch.int32)
R, ROPE, NOPE, V = 16, 8, 12, 8
BF = torch.bfloat16
# (query heads, KV heads, shards, owners, features), as the test file's
ATTENTION = [(4, 2, 2, True, {}), (8, 4, 4, True, {"qk_norm": True}),
             (6, 2, 4, False, {"window": 5}),
             (4, 1, 2, True, {"prefix_len": 7}),
             (8, 1, 4, True, {"soft_cap": 2.0}),
             (8, 2, 4, True, {"window": 6, "soft_cap": 3.0})]
MLA_CASES = [(2, True), (4, True), (4, False)]


class ThreadAxis:
    """``sharding.ModelAxis``'s collectives between threads, one a
    shard."""

    def __init__(self, rank, size, board):
        self.rank, self.size, self.board = rank, size, board

    def _all(self, x):
        slots, barrier = self.board
        slots[self.rank] = x
        barrier.wait()
        got = list(slots)
        barrier.wait()
        return got

    def gather(self, x, dim):
        return torch.cat(self._all(x), dim=dim)

    def amax(self, x):
        return torch.stack(self._all(x)).amax(0)

    def sum(self, x):
        return torch.stack(self._all(x)).sum(0)

    def to_owners(self, x):
        return torch.stack([t[self.rank] for t in self._all(x)])


def on_shards(size, fn):
    board = ([None] * size, threading.Barrier(size, timeout=60))
    out = [None] * size
    threads = [threading.Thread(target=lambda r=r: out.__setitem__(
        r, fn(ThreadAxis(r, size, board)))) for r in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max())


def cols(t, rank, size):
    n = t.shape[-1] // size
    return t[..., rank * n:(rank + 1) * n]


def rows(t, rank, size):
    n = t.shape[1] // size
    return t[:, rank * n:(rank + 1) * n]


def attention_gaps(seed, heads, n_kv, size, owners, feat, s):
    g = torch.Generator().manual_seed(seed * 1000 + heads * 100
                                      + size * 10 + s)
    q = torch.randn(B, s, heads * HD, generator=g)
    k = torch.randn(B, s, n_kv * HD, generator=g)
    v = torch.randn(B, s, n_kv * HD, generator=g)
    cache = {"k": torch.randn(B, MAX_SEQ, n_kv, HD, generator=g),
             "v": torch.randn(B, MAX_SEQ, n_kv, HD, generator=g),
             "pos": POS}
    norms = ([1.0 + 0.1 * torch.randn(HD, generator=g) for _ in range(2)]
             if feat.get("qk_norm") else [])
    kw = dict(head_dim=HD, rope_theta=10000.0, window=feat.get("window"),
              prefix_len=feat.get("prefix_len"), soft_cap=feat.get("soft_cap"))
    qb, kb, vb = q.to(BF), k.to(BF), v.to(BF)
    nb = [n.to(BF) for n in norms]
    cb = {n: (t.to(BF) if t.is_floating_point() else t)
          for n, t in cache.items()}
    # the float32 read of the same bfloat16-rounded inputs
    truth, _ = A._core(qb.float(), kb.float(), vb.float(),
                       *[n.float() for n in nb], group=heads // n_kv,
                       cache={n: (t.float() if t.is_floating_point() else t)
                              for n, t in cb.items()},
                       cd=torch.float32, **kw)
    plain, _ = A._core(qb, kb, vb, *nb, group=heads // n_kv, cache=cb,
                       cd=BF, **kw)
    gathered = (True, n_kv % size == 0 or not owners,
                n_kv % size == 0 or not owners)

    def shard(axis):
        r = axis.rank
        parts = [cols(t, r, size) if gt else t
                 for t, gt in zip((qb, kb, vb), gathered)]
        return A.sequence_read(
            *parts, rows(cb["k"], r, size), rows(cb["v"], r, size), POS,
            *nb, axis=axis, gathered=gathered, owners=owners,
            out_split=True, cd=BF, **kw)[0]
    read = torch.cat(on_shards(size, shard), dim=-1)
    return rel(read, plain), rel(read, truth), rel(plain, truth)


def mla_gaps(seed, size, owners):
    heads, s = 8, 2
    g = torch.Generator().manual_seed(seed * 1000 + size * 10 + owners)
    draw = [(B, s, heads * (NOPE + ROPE)), (R, heads * (NOPE + V)),
            (B, s, R), (B, s, ROPE), (B, MAX_SEQ, R), (B, MAX_SEQ, ROPE)]
    q, w, c_new, kr_new, c_cache, kr_cache = (
        torch.randn(*shape, generator=g) for shape in draw)
    q, w, c_new, kr_new, c_cache, kr_cache = (
        t.to(BF) for t in (q, w / R ** 0.5, c_new, kr_new, c_cache,
                           kr_cache))
    c_all = A.write_rows(c_cache, c_new, POS)
    kr_all = A.write_rows(kr_cache, kr_new, POS)
    kw = dict(qk_nope_dim=NOPE, v_head_dim=V, rope_dim=ROPE,
              rope_theta=10000.0)
    steps = torch.arange(s, dtype=torch.int32)
    plain = MLA._core(q, c_all @ w, kr_all[..., None, :], POS, steps=steps,
                      cd=BF, **kw)
    truth = MLA._core(q.float(), c_all.float() @ w.float(),
                      kr_all.float()[..., None, :], POS, steps=steps,
                      cd=torch.float32, **kw)

    def shard(axis):
        r = axis.rank
        hq, hw = ((cols(q, r, size), cols(w, r, size)) if owners
                  else (q, w))
        return MLA.mla_sequence_read(
            hq, c_new, kr_new, rows(c_cache, r, size),
            rows(kr_cache, r, size), POS, hw, axis=axis, owners=owners,
            cd=BF, **kw)[0]
    got = on_shards(size, shard)
    read = torch.cat(got, dim=-1) if owners else got[0]
    return rel(read, plain), rel(read, truth), rel(plain, truth)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=5)
    args = ap.parse_args(argv)
    out = {}
    for name, gaps in (
            ("attention", [attention_gaps(seed, *case, s)
                           for seed in range(args.seeds)
                           for case in ATTENTION for s in (1, 3)]),
            ("mla", [mla_gaps(seed, *case) for seed in range(args.seeds)
                     for case in MLA_CASES])):
        out[name] = {"cases": len(gaps),
                     "read_vs_plain": max(g[0] for g in gaps),
                     "read_vs_float32": max(g[1] for g in gaps),
                     "plain_vs_float32": max(g[2] for g in gaps)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
