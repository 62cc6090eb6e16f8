#!/usr/bin/env python3
"""``segment_reduce`` of two checkouts, timed in turns on the same inputs.

Usage (on a machine with a CUDA GPU):

    python3 tools/reduce_turns.py --src A/src --src B/src

Each checkout runs in its own process, in the turns A, B, B, A. A turn
builds that tree's kernels (in its ``build/``), drives the workloads of
``chip_smoke.py`` whose keyed reduces call ``segment_reduce``'s general
entry with one column, at their sizes but on data of this script's own
seed: (c) SpMV 16384 at 0.4% (the collapse), (e) Plus3 1024 at 5% (each
term's collapse) and (k) the GAT-style program on 16384 nodes of 14
neighbours and 128 features (the sort-merge's inner sum over ``T``'s 2^28
keys). It records every call of the general entry during one warm call
(a profile hook; nothing is rebound) and times the largest call of one
column per workload with CUDA events (the wrapper call as the engine pays
it) and with torch.profiler (the kernel alone). It also times the general
entry at the two shapes PR 17 timed it at, [value, 1] rows rebuilt from an
(i, k, j) product stream: a tile of (o) (2^28 rows, 137M live, 2^23
segments) and (d) (4,194,304 rows, 1.7M live, 2^24 segments). Every
input is made from fixed seeds, so both trees see the same bytes. Prints
one line a turn and a JSON summary (per input and tree: [event ms, kernel
ms] of each turn).
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


def kernel_ms(fn, reps=20):
    """The kernel's own time a call: torch.profiler's device time of the
    kernels named ``segment_reduce*`` over the launches it recorded."""
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
                and "segment_reduce" in evt.key):
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


def one_turn(src: str) -> dict:
    sys.path.insert(0, src)
    import torch

    from repro_torch.core.schedule import Format, Schedule
    from repro_torch.core.torch_backend import compile_expr, compile_program
    from repro_torch.kernels import _build
    from repro_torch.kernels.segment_reduce import segment_reduce

    _build.library()
    rng = np.random.default_rng(SEED)
    seen = {}

    def record(tag, fn):
        def hook(frame, event, arg):
            if event == "call" and frame.f_code is segment_reduce.__code__:
                kw = frame.f_locals
                if kw["vals"].shape[1] == 1:
                    seen.setdefault(tag, []).append(
                        (kw["vals"].clone(), kw["seg_ids"].clone(),
                         kw["num_segments"]))
        fn()
        sys.setprofile(hook)
        try:
            fn()
        finally:
            sys.setprofile(None)

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
        return [event_ms(call), kernel_ms(call)]

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
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append", default=[])
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one_turn(args.one)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("reduce_turns: no CUDA device", file=sys.stderr)
        return 2
    if len(args.src) != 2:
        ap.error("give two --src directories")
    a, b = args.src
    turns = {}
    for src in (a, b, b, a):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, str(pathlib.Path(__file__)),
                              "--one", src], capture_output=True, text=True,
                             check=True)
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
