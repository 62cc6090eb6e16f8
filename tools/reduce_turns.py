#!/usr/bin/env python3
"""A keyed reduce kernel of two checkouts, timed in turns on the same inputs.

Usage (on a machine with a CUDA GPU):

    python3 tools/reduce_turns.py --src A/src --src B/src
    python3 tools/reduce_turns.py --kernel scatter_workspace \
        --src A/src --src B/src

Each checkout runs in its own process, in the turns A, B, B, A (with more
than two ``--src``, in their order and then back). A turn builds that
tree's kernels (in its ``build/``) and times the kernel's inputs below with
CUDA events (the wrapper call as the engine pays it) and with
torch.profiler (the kernel alone). Every input is made from fixed seeds,
so every tree sees the same bytes. Prints one line a turn and a JSON
summary (per input and tree: [event ms, kernel ms] of each turn).

``--kernel segment_reduce`` (the default): the workloads of
``chip_smoke.py`` whose keyed reduces call the general entry with one
column, at their sizes but on data of this script's own seed: (c) SpMV
16384 at 0.4% (the collapse), (e) Plus3 1024 at 5% (each term's collapse)
and (k) the GAT-style program on 16384 nodes of 14 neighbours and 128
features (the sort-merge's inner sum over ``T``'s 2^28 keys). It records
every call of the general entry during one warm call (a profile hook;
nothing is rebound) and times the largest call of one column per
workload. It also times the general entry at two shapes of [value, 1]
rows rebuilt from an (i, k, j) product stream: a tile of (o) (2^28 rows,
137M live, 2^23 segments) and (d) (4,194,304 rows, 1.7M live, 2^24
segments); the general entry at (t)(2)'s shape (2^28 rows of one column
into 180,224 segments: the up stage's (e, c, f) keys of the 42 slots
that hold a token, each slot's 1408 keys repeated under 2048 values of
d, 121,110,528 live, the rest dropped at the end); and the [a*b, 1] mode
at a piece of (o) (2^26 rows, a quarter of a tile's products, int64 keys
over 2^23 segments, a prefix valid).

``--kernel scatter_workspace``: (d2) SpMSpM 1024 at 1% (``mul_pair``) and
(e)'s term merge (two columns), recorded through the engines as above;
and two streams built on the card with the key structure of the model
blocks' largest calls: (t)(2), ``MoEBlock``'s down stage in loop order
(e, c, f, g) at Moonlight's widths (2^29 rows, the ids of each (e, c)'s
2048 slots repeated under its 1408 values of f, 369,098,752 live, the rest
dropped at the end; ``mul_pair``, a of the (e, c) slots that hold a token
nonzero), and (s), the pruned transformer's FFN up product H(t, f) in
the loop order ``"auto"`` picks, (f, d, t), at qwen3-0.6b's widths (2^28
rows: under each of 3072 values of f the 512 kept d, under each d the
ids f * 128 + t of the 128 tokens, 201,326,592 live, the rest dropped at
the end; ``mul_pair``).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

SEED = 20261


def event_ms(fn, reps=20):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, name, reps=20):
    """The kernel's own time a call: torch.profiler's device time of the
    kernels whose name contains ``name`` over the launches it recorded."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = count = 0
    for evt in prof.key_averages():
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and name in evt.key):
            total += evt.self_device_time_total
            count += evt.count
    return total / count / 1e3 if count else None


def sparse_int(rng, shape, density):
    n = int(np.prod(shape))
    flat = np.unique(rng.integers(0, n, int(n * density)))
    arr = np.zeros(n)
    arr[flat] = rng.integers(1, 9, flat.size)
    return arr.reshape(shape)


def product_stream(b, c_rows, width, cap, nseg):
    """[b * c, 1] rows of the products B[i, k] * C[k, j] in (i, k, j)
    order, keys i * width + j, padded to ``cap`` rows of the dropped id
    ``nseg``; ``c_rows(k)`` gives C's row k as (j, value) arrays."""
    import torch

    ii, kk = np.nonzero(b)
    keys, prod = [], []
    for i, k in zip(ii, kk):
        j, v = c_rows(k)
        keys.append(i * width + j)
        prod.append(b[i, k] * v)
    keys = np.concatenate(keys)
    sids = torch.full((cap,), nseg, dtype=torch.int32)
    sids[:keys.size] = torch.as_tensor(keys.astype(np.int32))
    vals = torch.zeros((cap, 2))
    vals[:keys.size, 0] = torch.as_tensor(np.concatenate(prod),
                                          dtype=torch.float32)
    vals[:keys.size, 1] = 1.0
    return vals.cuda(), sids.cuda()


def recorder(code, keep):
    """``record(tag, fn)``: one call of ``fn`` to warm it, then one more
    under a profile hook that appends ``keep(frame locals)`` to
    ``seen[tag]`` for each call of the function whose code is ``code``
    (``keep`` returns None to skip a call)."""
    seen = {}

    def record(tag, fn):
        def hook(frame, event, arg):
            if event == "call" and frame.f_code is code:
                got = keep(frame.f_locals)
                if got is not None:
                    seen.setdefault(tag, []).append(got)
        fn()
        sys.setprofile(hook)
        try:
            fn()
        finally:
            sys.setprofile(None)
    return seen, record


def spmspm_1024(rng):
    """(d2): SpMSpM 1024^3 at 1% each, loop order ikj."""
    from repro_torch.core.schedule import Format, Schedule
    from repro_torch.core.torch_backend import compile_expr

    n = 1024
    eng = compile_expr("X(i,j) = B(i,k) * C(k,j)",
                       Format({"B": "cc", "C": "cc"}),
                       Schedule(loop_order=("i", "k", "j")),
                       {"i": n, "j": n, "k": n})
    arrays = {t: sparse_int(rng, (n, n), 0.01) for t in "BC"}
    return lambda: eng(arrays)


def plus3_1024(rng):
    """(e): Plus3 1024^2 at 5% each."""
    from repro_torch.core.schedule import Format, Schedule
    from repro_torch.core.torch_backend import compile_expr

    n = 1024
    eng = compile_expr("X(i,j) = B(i,j) + C(i,j) + D(i,j)",
                       Format({"B": "cc", "C": "cc", "D": "cc"}),
                       Schedule(loop_order=("i", "j")), {"i": n, "j": n})
    arrays = {t: sparse_int(rng, (n, n), 0.05) for t in "BCD"}
    return lambda: eng(arrays)


def workspace_turn() -> dict:
    import torch

    from repro_torch.kernels.scatter_workspace import scatter_workspace

    rng = np.random.default_rng(SEED)
    seen, record = recorder(scatter_workspace.__code__, lambda kw: (
        kw["ids"].clone(), kw["cols"].clone(), kw["num_slots"],
        kw["mul_pair"]))
    record("d2", spmspm_1024(rng))
    record("e", plus3_1024(rng))

    def times(ids, cols, slots, mul_pair):
        def call():
            scatter_workspace(ids, cols, num_slots=slots, mul_pair=mul_pair)
        return [event_ms(call), kernel_ms(call, "scatter_workspace")]

    def label(tag, ids, cols, slots, mul_pair):
        live = int(((ids >= 0) & (ids < slots)).sum())
        return (f"({tag}) N={ids.numel()} live={live} C={cols.shape[1]} "
                f"slots={slots} mul_pair={mul_pair}")

    out = {}
    for tag, calls in sorted(seen.items()):
        call = max(calls, key=lambda c: c[0].numel())
        out[label(tag, *call)] = times(*call)
    del seen
    g = torch.Generator(device="cuda").manual_seed(SEED)
    # (t)(2): Z(e,c,g) = H(e,c,f) * Wd(e,f,g) in loop order (e, c, f, g)
    n_ec, f_dim, g_dim, cap = 64 * 2, 1408, 2048, 1 << 29
    slots = n_ec * g_dim
    n_live = n_ec * f_dim * g_dim
    row = torch.arange(n_live, device="cuda")
    ids = torch.full((cap,), slots, dtype=torch.int32, device="cuda")
    ids[:n_live] = (row // (f_dim * g_dim) * g_dim + row % g_dim).int()
    del row
    cols = torch.zeros((cap, 3), device="cuda")
    held = torch.zeros(n_ec, device="cuda")
    held[torch.randperm(n_ec, device="cuda", generator=g)[:42]] = 1.0
    h = torch.randn((n_ec, f_dim), device="cuda", generator=g) * held[:, None]
    cols[:n_live, 0] = h.repeat_interleave(g_dim, dim=1).flatten()
    cols[:n_live, 1] = torch.randn(n_live, device="cuda", generator=g)
    cols[:n_live, 2] = 1.0
    del h
    out[label("t)(2", ids, cols, slots, True)] = times(ids, cols, slots,
                                                       True)
    del ids, cols
    # (s): H(t,f) = X(t,d) * W1(d,f) in the loop order "auto" picks,
    # (f, d, t): under each f the 512 kept d of W1's column (50%), under
    # each d the 128 tokens; slot f * 128 + t
    t_dim, d_dim, f_dim, kept, cap = 128, 1024, 3072, 512, 1 << 28
    slots = f_dim * t_dim
    n_live = f_dim * kept * t_dim
    row = torch.arange(n_live, device="cuda")
    ids = torch.full((cap,), slots, dtype=torch.int32, device="cuda")
    ids[:n_live] = (row // (kept * t_dim) * t_dim + row % t_dim).int()
    del row
    d_sel = torch.rand((f_dim, d_dim), device="cuda",
                       generator=g).argsort(dim=1)[:, :kept]
    x = torch.randn((t_dim, d_dim), device="cuda", generator=g)
    w1 = torch.randn((f_dim, kept), device="cuda", generator=g)
    cols = torch.zeros((cap, 3), device="cuda")
    cols[:n_live, 0] = w1.repeat_interleave(t_dim, dim=1).flatten()
    cols[:n_live, 1] = x[:, d_sel].permute(1, 2, 0).flatten()
    cols[:n_live, 2] = 1.0
    del d_sel, x, w1
    out[label("s", ids, cols, slots, True)] = times(ids, cols, slots, True)
    return out


def segment_turn() -> dict:
    import torch

    from repro_torch.core.schedule import Format, Schedule
    from repro_torch.core.torch_backend import compile_expr, compile_program
    from repro_torch.kernels.segment_reduce import (segment_reduce,
                                                    segment_reduce_mul)

    rng = np.random.default_rng(SEED)
    seen, record = recorder(segment_reduce.__code__, lambda kw: (
        (kw["vals"].clone(), kw["seg_ids"].clone(), kw["num_segments"])
        if kw["vals"].shape[1] == 1 else None))

    n = 16384
    eng = compile_expr("x(i) = B(i,j) * c(j)", Format({"B": "cc", "c": "c"}),
                       Schedule(loop_order=("i", "j")), {"i": n, "j": n})
    arrays = {"B": sparse_int(rng, (n, n), 0.004),
              "c": rng.integers(1, 9, n).astype(float)}
    record("c", lambda: eng(arrays))
    n = 1024
    eng = compile_expr("X(i,j) = B(i,j) + C(i,j) + D(i,j)",
                       Format({"B": "cc", "C": "cc", "D": "cc"}),
                       Schedule(loop_order=("i", "j")), {"i": n, "j": n})
    arrays = {t: sparse_int(rng, (n, n), 0.05) for t in "BCD"}
    record("e", lambda: eng(arrays))
    nodes, deg, feat = 16384, 14, 128
    src_i = np.repeat(np.arange(nodes), deg)
    dst = np.concatenate([rng.choice(nodes, deg, replace=False)
                          for _ in range(nodes)])
    adj = np.zeros((nodes, nodes))
    adj[src_i, dst] = rng.integers(1, 4, src_i.size)
    gat = {"B": adj, **{t: rng.integers(-3, 4, (nodes, feat)).astype(float)
                        for t in "CDE"}}
    cp = compile_program(
        "T(i,j) = B(i,j) * C(i,f) * D(j,f); A(i,g) = T(i,j) * E(j,g)",
        Format({"B": "cc", "T": "cc", "C": "dd", "D": "dd", "E": "dd",
                "A": "dd"}),
        {"T": Schedule(loop_order=("i", "j", "f")),
         "A": Schedule(loop_order=("i", "j", "g"))},
        {"i": nodes, "j": nodes, "f": feat, "g": feat})
    record("k", lambda: cp(gat))
    del adj, gat, arrays

    def times(vals, sids, nseg):
        def call():
            segment_reduce(vals, sids, num_segments=nseg)
        return [event_ms(call), kernel_ms(call, "segment_reduce")]

    out = {}
    for tag, calls in sorted(seen.items()):
        vals, sids, nseg = max(calls, key=lambda c: c[0].shape[0])
        out[f"({tag}) N={vals.shape[0]} D=1 S={nseg}"] = times(vals, sids,
                                                              nseg)
    # PR 17's shapes of the general entry with two columns
    n = 16384
    b = sparse_int(rng, (n, n), 0.002)[:n // 2, :n // 2]
    c = rng.integers(1, 9, (n // 2, 1024)).astype(float)
    j_all = np.arange(1024)
    shapes = [("o", b, lambda k: (j_all, c[k]), 1024, 1 << 28, 1 << 23)]
    import scipy.sparse as sp
    n = 4096
    bd = sparse_int(rng, (n, n), 0.005)
    cd = sp.csr_matrix(sparse_int(rng, (n, n), 0.005))
    shapes.append(("d", bd, lambda k: (cd.indices[cd.indptr[k]:
                                                  cd.indptr[k + 1]],
                                       cd.data[cd.indptr[k]:cd.indptr[k + 1]]),
                   n, 4194304, 1 << 24))
    for tag, bb, c_rows, width, cap, nseg in shapes:
        vals, sids = product_stream(bb, c_rows, width, cap, nseg)
        live = int((sids < nseg).sum())
        out[f"({tag}) N={cap} live={live} D=2 S={nseg}"] = times(vals, sids,
                                                                nseg)
        del vals, sids
    # (t)(2)'s general entry: the up stage's keys (e, c, f) in loop order
    # (e, c, d, f) for the 42 (e, c) slots that hold a token, the ids of
    # each slot's 1408 segments repeated under its 2048 values of d
    g = torch.Generator(device="cuda").manual_seed(SEED)
    cap, nseg, f_dim, d_dim = 1 << 28, 64 * 2 * 1408, 1408, 2048
    held = torch.randperm(128, device="cuda", generator=g)[:42].sort().values
    n_live = 42 * d_dim * f_dim
    row = torch.arange(n_live, device="cuda")
    sids = torch.full((cap,), nseg, dtype=torch.int32, device="cuda")
    sids[:n_live] = (held[row // (d_dim * f_dim)] * f_dim
                     + row % f_dim).int()
    del row
    vals = torch.randn((cap, 1), device="cuda", generator=g)
    out[f"(t)(2) N={cap} live={n_live} D=1 S={nseg}"] = times(vals, sids,
                                                             nseg)
    del sids, vals
    # the [a*b, 1] mode at a piece of (o): a quarter of a tile's rows of B
    n = 16384
    b = sparse_int(np.random.default_rng(SEED + 1), (n, n),
                   0.002)[:n // 8, :n // 2]
    ii, kk = np.nonzero(b)
    cnt = ii.size
    keys = torch.as_tensor(ii, device="cuda").repeat_interleave(1024) * 1024
    keys += torch.arange(1024, device="cuda").repeat(cnt)
    a = torch.as_tensor(b[ii, kk], dtype=torch.float32,
                        device="cuda").repeat_interleave(1024)
    cap, nseg = 1 << 26, 1 << 23
    n_live = keys.numel()
    pad = cap - n_live
    keys = torch.cat([keys, torch.full((pad,), 0, device="cuda")])
    a = torch.cat([a, torch.zeros(pad, device="cuda")])
    bv = torch.randint(1, 9, (cap,), device="cuda", generator=g).float()
    valid = torch.arange(cap, device="cuda") < n_live

    def mul_call():
        segment_reduce_mul(keys, a, bv, valid, num_segments=nseg)
    out[f"(o) piece [a*b, 1] mode N={cap} live={n_live} S={nseg}"] = [
        event_ms(mul_call), kernel_ms(mul_call, "segment_reduce")]
    return out


def one_turn(src: str, kernel: str) -> dict:
    sys.path.insert(0, src)
    from repro_torch.kernels import _build

    _build.library()
    return workspace_turn() if kernel == "scatter_workspace" else (
        segment_turn())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append", default=[])
    ap.add_argument("--kernel", default="segment_reduce",
                    choices=("segment_reduce", "scatter_workspace"))
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one_turn(args.one, args.kernel)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("reduce_turns: no CUDA device", file=sys.stderr)
        return 2
    if len(args.src) < 2:
        ap.error("give two or more --src directories")
    turns = {}
    for src in args.src + args.src[::-1]:
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, str(pathlib.Path(__file__)),
                              "--one", src, "--kernel", args.kernel],
                             capture_output=True, text=True)
        if res.returncode:
            print(f"turn {src} failed:\n{res.stderr[-4000:]}",
                  file=sys.stderr)
            return 1
        got = json.loads(res.stdout.strip().splitlines()[-1])
        print(f"turn {src}: {time.perf_counter() - t0:.1f} s; " + "; ".join(
            f"{k} {ev:.4f} ms, kernel "
            + ("not recorded" if kern is None else f"{kern:.4f} ms")
            for k, (ev, kern) in got.items()), flush=True)
        for k, v in got.items():
            turns.setdefault(k, {}).setdefault(src, []).append(v)
    print(json.dumps(turns))
    return 0


if __name__ == "__main__":
    sys.exit(main())
