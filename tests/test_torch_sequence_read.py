"""The sequence read of a placed cache and the vocab-parallel loss, on M
simulated shards of one process.

A placed cache has its sequence split over the model axis (the rules'
``cache_spec``); a decode step reads it there (``attention.sequence_read``,
``mla.mla_sequence_read``) and merges the float32 partials over the axis.
Here each of M ∈ {2, 4} shards is a thread holding its own rows of the
cache (and its own columns of the projections' outputs where they are
split), and ``ThreadAxis`` stands for ``sharding.ModelAxis``: its
collectives meet at a barrier. Each shard's result, put together, is held
within 1e-6 of the whole read (``attention._core`` and ``mla._core`` on
the whole cache), and the caches equal the whole write bit for bit:

* split heads (the a2a merge to each head's owner), 6 heads over 4
  shards (the MAX and SUM all-reduce merge, each card keeping its columns
  of a row-parallel ``wo``), MQA, GQA; q/k norms, a window, a prefix and
  a soft cap; one and three new tokens, rows that cross a shard boundary;
  and in bfloat16 compute within ``BF16_TOL`` of the plain read, which
  rounds its probabilities where the sequence read keeps them in float32;
* MLA's absorbed read, with the heads split and whole;
* the vocab-parallel cross entropy (``common._VocabParallelNLL``) and its
  gradient against ``cross_entropy`` on whole rows;
* the byte rule that picks the read (``read_path``): the sequence at
  decode_32k, the cache at prefill_32k.

No processes.
"""
import threading

import numpy as np
import pytest
import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.models import attention as A
from repro_torch.models import mla as MLA
from repro_torch.models.common import _VocabParallelNLL, cross_entropy

TOL = 1e-6


class ThreadAxis:
    """``sharding.ModelAxis``'s collectives between threads, one a shard:
    each call posts this shard's tensor and waits for the others'."""

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
    """``fn(axis)`` on ``size`` threads, one a shard; the results by
    rank."""
    board = ([None] * size, threading.Barrier(size, timeout=60))
    out, errors = [None] * size, []

    def run(rank):
        try:
            out[rank] = fn(ThreadAxis(rank, size, board))
        except BaseException as e:          # noqa: BLE001 - re-raised
            errors.append(e)
            board[1].abort()
    threads = [threading.Thread(target=run, args=(r,)) for r in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def rel(got, want):
    got, want = got.double(), want.double()
    assert got.shape == want.shape and torch.isfinite(got).all()
    return float((got - want).abs().max() / want.abs().max())


def cols(t, rank, size):
    n = t.shape[-1] // size
    return t[..., rank * n:(rank + 1) * n]


def rows(t, rank, size):
    n = t.shape[1] // size
    return t[:, rank * n:(rank + 1) * n]


B, MAX_SEQ, HD = 2, 16, 8
POS = torch.tensor([5, 9], dtype=torch.int32)

# (name, query heads, KV heads, shards, owners, features)
ATTENTION = [
    ("split heads", 4, 2, 2, True, {}),
    ("split heads", 8, 4, 4, True, {"qk_norm": True}),
    ("6 heads over 4 shards", 6, 2, 4, False, {"window": 5}),
    ("MQA", 4, 1, 2, True, {"prefix_len": 7}),
    ("MQA", 8, 1, 4, True, {"soft_cap": 2.0}),
    ("GQA over 4", 8, 2, 4, True, {"window": 6, "soft_cap": 3.0}),
]


def attention_read(heads, n_kv, size, owners, feat, s, cd):
    """(the read on ``size`` thread shards put together, each shard's
    result, ``_core``'s output and cache on the whole cache), the inputs
    drawn in float32 and cast to the compute dtype ``cd``."""
    g = torch.Generator().manual_seed(heads * 100 + size * 10 + s)
    q = torch.randn(B, s, heads * HD, generator=g).to(cd)
    k = torch.randn(B, s, n_kv * HD, generator=g).to(cd)
    v = torch.randn(B, s, n_kv * HD, generator=g).to(cd)
    cache = {"k": torch.randn(B, MAX_SEQ, n_kv, HD, generator=g).to(cd),
             "v": torch.randn(B, MAX_SEQ, n_kv, HD, generator=g).to(cd),
             "pos": POS}
    norms = ([(1.0 + 0.1 * torch.randn(HD, generator=g)).to(cd)
              for _ in range(2)] if feat.get("qk_norm") else [])
    kw = dict(head_dim=HD, rope_theta=10000.0, window=feat.get("window"),
              prefix_len=feat.get("prefix_len"), cd=cd,
              soft_cap=feat.get("soft_cap"))
    want, want_cache = A._core(q, k, v, *norms, group=heads // n_kv,
                               cache=cache, **kw)
    # the heads split on whole heads: q, k, v by their heads' columns
    # (MQA's single KV head whole); else q and K/V split by columns
    gathered = (True, n_kv % size == 0 or not owners,
                n_kv % size == 0 or not owners)

    def shard(axis):
        r = axis.rank
        parts = [cols(t, r, size) if gt else t
                 for t, gt in zip((q, k, v), gathered)]
        return A.sequence_read(
            *parts, rows(cache["k"], r, size), rows(cache["v"], r, size),
            POS, *norms, axis=axis, gathered=gathered, owners=owners,
            out_split=True, **kw)
    got = on_shards(size, shard)
    return torch.cat([o for o, *_ in got], dim=-1), got, want, want_cache


@pytest.mark.parametrize("s", [1, 3])
@pytest.mark.parametrize("name,heads,n_kv,size,owners,feat", ATTENTION,
                         ids=[f"{a[0]}-{a[1]}on{a[3]}" for a in ATTENTION])
def test_attention_read_on_sequence_shards_equals_the_whole(
        name, heads, n_kv, size, owners, feat, s):
    out, got, want, want_cache = attention_read(heads, n_kv, size, owners,
                                                feat, s, torch.float32)
    assert rel(out, want) <= TOL, (name, rel(out, want))
    for i, n in ((1, "k"), (2, "v")):
        assert torch.equal(torch.cat([r[i] for r in got], dim=1),
                           want_cache[n])
    assert all(torch.equal(r[3], want_cache["pos"]) for r in got)


# In bfloat16 compute the sequence read keeps its probabilities (and MLA
# its folded queries) in float32 up to the merge, where ``_core``, as the
# reference, rounds them to bfloat16: the two differ by that rounding.
# Over 5 seeds of these cases (``tools/sequence_read_bf16.py``) the
# largest gap was 6.8e-3 (attention) and 7.7e-3 (MLA) of the output's
# largest magnitude, and each path's gap to the float32 read 4.4e-3 and
# 3.2e-3 (the sequence read), 7.3e-3 and 5.1e-3 (``_core``); a fault in
# the merge or in the absorption is of order 1e-1 or more.
BF16_TOL = 1.5e-2


@pytest.mark.parametrize("name,heads,n_kv,size,owners,feat", ATTENTION,
                         ids=[f"{a[0]}-{a[1]}on{a[3]}" for a in ATTENTION])
def test_attention_read_in_bfloat16_stays_near_the_plain_one(
        name, heads, n_kv, size, owners, feat):
    out, got, want, want_cache = attention_read(heads, n_kv, size, owners,
                                                feat, 1, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    assert rel(out, want) <= BF16_TOL, (name, rel(out, want))
    for i, n in ((1, "k"), (2, "v")):
        assert torch.equal(torch.cat([r[i] for r in got], dim=1),
                           want_cache[n])


R, ROPE, NOPE, V = 16, 8, 12, 8


def mla_read(size, owners, cd):
    """(the absorbed read on ``size`` thread shards put together, each
    shard's result, ``mla._core`` on the whole cache, the whole cache's
    c_kv and k_rope), the inputs drawn in float32 and cast to ``cd``."""
    heads, s = 8, 2
    g = torch.Generator().manual_seed(size * 10 + owners)
    q = torch.randn(B, s, heads * (NOPE + ROPE), generator=g).to(cd)
    w = (torch.randn(R, heads * (NOPE + V), generator=g) / R ** 0.5).to(cd)
    c_new = torch.randn(B, s, R, generator=g).to(cd)
    kr_new = torch.randn(B, s, ROPE, generator=g).to(cd)
    c_cache = torch.randn(B, MAX_SEQ, R, generator=g).to(cd)
    kr_cache = torch.randn(B, MAX_SEQ, ROPE, generator=g).to(cd)
    c_all = A.write_rows(c_cache, c_new, POS)
    kr_all = A.write_rows(kr_cache, kr_new, POS)
    kw = dict(qk_nope_dim=NOPE, v_head_dim=V, rope_dim=ROPE,
              rope_theta=10000.0, cd=cd)
    want = MLA._core(q, c_all @ w, kr_all[..., None, :], POS,
                     steps=torch.arange(s, dtype=torch.int32), **kw)

    def shard(axis):
        r = axis.rank
        hq, hw = ((cols(q, r, size), cols(w, r, size)) if owners
                  else (q, w))
        return MLA.mla_sequence_read(
            hq, c_new, kr_new, rows(c_cache, r, size),
            rows(kr_cache, r, size), POS, hw, axis=axis, owners=owners,
            **kw)
    got = on_shards(size, shard)
    out = (torch.cat([o for o, *_ in got], dim=-1) if owners
           else got[0][0])
    assert all(torch.equal(o, got[0][0]) for o, *_ in got) or owners
    return out, got, want, (c_all, kr_all)


@pytest.mark.parametrize("size,owners", [(2, True), (4, True), (4, False)])
def test_mla_read_on_sequence_shards_equals_the_whole(size, owners):
    out, got, want, (c_all, kr_all) = mla_read(size, owners, torch.float32)
    assert rel(out, want) <= TOL, rel(out, want)
    assert torch.equal(torch.cat([r[1] for r in got], dim=1), c_all)
    assert torch.equal(torch.cat([r[2] for r in got], dim=1), kr_all)


@pytest.mark.parametrize("size,owners", [(2, True), (4, True), (4, False)])
def test_mla_read_in_bfloat16_stays_near_the_plain_one(size, owners):
    out, got, want, (c_all, _) = mla_read(size, owners, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    assert rel(out, want) <= BF16_TOL, rel(out, want)
    assert torch.equal(torch.cat([r[1] for r in got], dim=1), c_all)


@pytest.mark.parametrize("size", [2, 4])
def test_vocab_parallel_loss_and_gradient_equal_whole_rows(size):
    g = torch.Generator().manual_seed(size)
    logits = 3.0 * torch.randn(3, 5, 64, generator=g)
    labels = torch.randint(0, 64, (3, 5), generator=g)
    whole = logits.clone().requires_grad_(True)
    loss = cross_entropy(whole, labels)
    loss.backward()
    n = 64 // size

    def shard(axis):
        local = cols(logits, axis.rank, size).clone().requires_grad_(True)
        nll = _VocabParallelNLL.apply(local, labels, axis.rank * n, axis)
        torch.mean(nll).backward()
        return nll.detach(), local.grad
    got = on_shards(size, shard)
    assert all(torch.equal(nll, got[0][0]) for nll, _ in got)
    assert rel(torch.mean(got[0][0]), loss.detach()) <= TOL
    assert rel(torch.cat([gr for _, gr in got], dim=-1), whole.grad) <= TOL


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma-2b", "llama3.2-3b",
                                  "deepseek-v3-671b"])
def test_read_path_sequence_at_decode_cache_at_prefill(arch):
    cfg = get_config(arch)
    cd, kv = torch.bfloat16, torch.bfloat16

    def path(shape):
        sh = SHAPES[shape]
        tokens = 1 if sh.kind == "decode" else sh.seq_len
        if cfg.use_mla:
            return MLA.read_path(sh.global_batch, tokens, sh.seq_len,
                                 cfg.n_heads, cfg.kv_lora_rank,
                                 cfg.rope_dim, kv)
        return A.read_path(sh.global_batch, tokens, sh.seq_len, cfg.n_heads,
                           cfg.n_kv_heads, cfg.resolved_head_dim, cd, kv)
    assert path("decode_32k") == "sequence"
    assert path("prefill_32k") == "cache"


def test_write_rows_drops_a_neighbours_rows():
    arr = torch.zeros(2, 4, 3)
    new = torch.arange(12.0).reshape(2, 2, 3) + 1
    got = A.write_rows(arr, new, torch.tensor([3, 6]), 4)   # rows 4..7
    want = torch.zeros(2, 4, 3)
    want[0, 0] = new[0, 1]                 # position 4; 3 is a neighbour's
    want[1, 2:] = new[1]                   # positions 6 and 7
    assert torch.equal(got, want)
    assert np.array_equal(arr.numpy(), np.zeros((2, 4, 3)))
