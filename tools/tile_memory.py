#!/usr/bin/env python3
"""Peak device memory of one tile of ``chip_smoke.py`` (o), by allocation site.

Usage (on a machine with a CUDA GPU):

    python3 tools/tile_memory.py [--src DIR] [--n 16384] [--nj 1024]

Builds (o)'s operands (B n x n at 0.2% in ``cc``, C n x nj dense in ``dd``,
order ikj, values 1-8 from a fixed seed) and its ``TiledExpr`` under
``mem_budget="4GB"`` (the plan ``{i: 2, k: 2}``), takes the first tile of
the grid (B[:n/2, :n/2], C[:n/2, :]) and runs it through the tiled
engine's per-tile engine as ``TiledExpr`` runs every tile: in its pieces
(lanes over the outermost loop variable), on the shared input buckets.
One warm call is timed on the host clock; another is measured with
``torch.cuda.max_memory_allocated`` and traced with the allocator's
history. The lines printed are the pieces, the warm time, the peak, the
bytes a row of the largest stream capacity of the plan (one piece's), and
the bytes live at the peak grouped by the first ``repro_torch`` frame that
allocated them. ``--src`` points at another checkout's ``src`` directory,
so two trees can be compared in one call (the CUDA sources build per
tree; a tree without pieces runs the tile whole).
"""
from __future__ import annotations

import argparse
import collections
import pathlib
import sys
import time

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(pathlib.Path(__file__).resolve()
                                         .parent.parent / "src"))
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--nj", type=int, default=1024)
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import scipy.sparse as sp
    import torch

    if not torch.cuda.is_available():
        print("tile_memory: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.schedule import Format, Schedule
    from repro_torch.core.torch_backend import compile_expr

    n, nj, h = args.n, args.nj, args.n // 2
    rng = np.random.default_rng(20260)
    flat = np.unique(rng.integers(0, n * n, int(n * n * 0.002)))
    B = np.zeros(n * n)
    B[flat] = rng.integers(1, 9, flat.size)
    B = B.reshape(n, n)
    C = rng.integers(1, 9, (n, nj)).astype(float)
    teng = compile_expr("X(i,j) = B(i,k) * C(k,j)",
                        Format({"B": "cc", "C": "dd"}),
                        Schedule(loop_order=("i", "k", "j")),
                        {"i": n, "j": nj, "k": n}, mem_budget="4GB",
                        sparsity={"B": 0.002, "C": 1.0})
    teng._measure_hints({"B": B, "C": C})        # every tile's buckets
    eng, hints = teng.engine, teng._hints
    tile = {"B": B[:h, :h], "C": C[:h]}
    coords, vals = eng.execute_coo(tile, hints=hints)   # records the plan
    got = np.zeros((h, nj))
    got[coords[:, 0], coords[:, 1]] = vals
    if not np.array_equal(got, sp.csr_matrix(tile["B"]) @ tile["C"]):
        raise AssertionError("the tile differs from scipy's product")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.execute_coo(tile, hints=hints)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.memory._record_memory_history(max_entries=200000)
    eng.execute_coo(tile, hints=hints)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    snap = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    caps = next(iter(eng._plans.values())).caps
    big = max(caps.values())
    print(f"tile {h} x {h} x {nj} ({args.src}): "
          f"{getattr(teng, 'pieces', 1)} pieces, tile_bytes "
          f"{teng.tile_bytes}; warm call {warm_ms:.1f} ms; peak allocated "
          f"{peak} bytes, {peak / big:.1f} bytes a row of the largest "
          f"capacity {big}; caps {caps}")

    def site(frames):
        for f in frames:
            if "repro_torch" in f["filename"]:
                return (f"{pathlib.Path(f['filename']).name}:{f['line']}:"
                        f"{f['name']}")
        return "outside the package"

    live, cur, top, at = {}, 0, 0, {}
    for e in snap["device_traces"][0]:
        if e["action"] == "alloc":
            live[e["addr"]] = (e["size"], site(e["frames"]))
            cur += e["size"]
            if cur > top:
                top, at = cur, dict(live)
        elif e["action"] == "free_completed" and e["addr"] in live:
            cur -= live.pop(e["addr"])[0]
    by_site = collections.Counter()
    for size, where in at.values():
        by_site[where] += size
    print(f"live at the traced peak ({top} bytes), by allocation site:")
    for where, size in by_site.most_common(12):
        print(f"  {size / 2 ** 20:10.1f} MiB  {where}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
