#!/usr/bin/env python3
"""Run the GPU test file many times and keep the CUDA-core attention case.

Usage (on a machine with a CUDA GPU, from the repository root):

    python3 tools/attention_repeat.py [--runs 30] [--minutes 20]

Runs ``python -m pytest -q tests/test_torch_gpu.py`` in a fresh process
``--runs`` times (no new run starts after ``--minutes``), as the file is
run on the card. In each run a pytest plugin of this script watches
``test_bsr_attention_equals_plain[1-32-False-dtype0]`` (block size 1, head
dim 32, float32, the CUDA-core kernel): it records the tensors the test
hands ``torch.testing.assert_close`` (the kernel's ``got`` and the plain
version's ``want``), the global settings that could change either side
(float32 matmul precision, TF32 and oneDNN flags, CPU threads), the test
order and whether a plugin reorders it, and holds both sides against a
float64 oracle of the same inputs (the test's seed) row by row. Each run
prints one JSON line; the first failing run's and one passing run's
tensors go to ``chiprun_out/attention_repeat/run<k>.npz``. The last line
sums the runs: how many failed, and for each failure which side left the
float64 oracle.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
CASE = "test_bsr_attention_equals_plain[1-32-False-dtype0]"
OUT = ROOT / "chiprun_out" / "attention_repeat"
TOL = 2e-5


def oracle64(bs=1, d=32, causal=False):
    """The case's inputs from its seed, and float64 attention over them
    (the GPU test file's own oracle, ``_attention_f64``)."""
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]
    from repro_torch.kernels import ops as kops
    from test_torch_gpu import _attention_f64

    rng = np.random.default_rng(bs + d)
    bh, n_blk = 2, max(4, 512 // bs)
    s = n_blk * bs
    kv_idx = kops.sliding_window_kv_idx(n_blk, n_blk, 3, causal=causal)
    kv_idx[2] = n_blk
    q, k, v = (rng.standard_normal((bh, s, d)).astype(np.float32)
               for _ in range(3))
    return _attention_f64(q, k, v, kv_idx, bs, causal)


def side_report(x, ref):
    err = np.abs(x.astype(np.float64) - ref)
    bad = err > TOL + TOL * np.abs(ref)
    rows = sorted({(int(h), int(r)) for h, r, _ in zip(*np.nonzero(bad))})
    return {"max_err_vs_f64": float(err.max()), "elements_off": int(bad.sum()),
            "rows_off": rows[:40]}


def settings():
    import torch

    mk = getattr(torch.backends, "mkldnn", None)
    state = {"float32_matmul_precision": torch.get_float32_matmul_precision(),
             "cuda_matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
             "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
             "mkldnn_enabled": bool(mk and mk.is_available() and mk.enabled),
             "threads": torch.get_num_threads()}
    for name, obj in (("fp32_precision", torch.backends),
                      ("mkldnn_fp32_precision", mk),
                      ("mkldnn_matmul_fp32_precision",
                       getattr(mk, "matmul", None))):
        if obj is not None and hasattr(obj, "fp32_precision"):
            state[name] = str(obj.fp32_precision)
    return state


class Watch:
    """pytest plugin: records the watched case's compared tensors."""

    def __init__(self, run: int):
        self.run = run
        self.order = []
        self.record = {}

    def pytest_collection_modifyitems(self, session, config, items):
        self.reorders = [p for p in ("randomly", "random_order", "xdist")
                         if config.pluginmanager.hasplugin(p)]

    def pytest_collection_finish(self, session):
        self.order = [it.nodeid.split("::", 1)[1] for it in session.items]

    @pytest.hookimpl(hookwrapper=True)
    def pytest_runtest_call(self, item):
        if not item.nodeid.endswith(CASE):
            yield
            return
        import torch

        real = torch.testing.assert_close
        seen = {}

        def spy(actual, expected, *a, **kw):
            seen["got"] = actual.detach().cpu().double().numpy()
            seen["want"] = expected.detach().cpu().double().numpy()
            return real(actual, expected, *a, **kw)

        self.record["settings_before"] = settings()
        torch.testing.assert_close = spy
        try:
            outcome = yield
        finally:
            torch.testing.assert_close = real
        self.record["passed"] = outcome.excinfo is None
        self.record["position"] = self.order.index(
            item.nodeid.split("::", 1)[1]) if self.order else None
        self.record.update(seen)


def child(run: int) -> int:
    watch = Watch(run)
    rc = pytest.main(["-q", "-p", "no:cacheprovider", "tests/test_torch_gpu.py"],
                     plugins=[watch])
    rec = watch.record
    line = {"run": run, "pytest_rc": int(rc), "reorder_plugins":
            getattr(watch, "reorders", []), "case_position": rec.get("position"),
            "case_passed": rec.get("passed"),
            "settings": rec.get("settings_before"),
            "order_head": watch.order[:3]}
    if "got" in rec:
        ref = oracle64()
        line["got"] = side_report(rec["got"], ref)
        line["want"] = side_report(rec["want"], ref)
        line["got_vs_want_max"] = float(np.abs(rec["got"] - rec["want"]).max())
        OUT.mkdir(parents=True, exist_ok=True)
        (OUT / f"order{run}.txt").write_text("\n".join(watch.order))
        keep = not rec["passed"] or not any(OUT.glob("run*_pass.npz"))
        if keep:
            tag = "pass" if rec["passed"] else "fail"
            np.savez_compressed(OUT / f"run{run}_{tag}.npz", got=rec["got"],
                                want=rec["want"], f64=ref)
    print("ATTN_REPEAT " + json.dumps(line), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=30)
    ap.add_argument("--minutes", type=float, default=20.0)
    ap.add_argument("--child", type=int, default=None)
    args = ap.parse_args()
    if args.child is not None:
        return child(args.child)
    import torch

    if not torch.cuda.is_available():
        print("attention_repeat: no CUDA device", file=sys.stderr)
        return 2
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.monotonic()
    lines = []
    for run in range(args.runs):
        if time.monotonic() - t0 > args.minutes * 60:
            break
        t1 = time.monotonic()
        proc = subprocess.run([sys.executable, __file__, "--child", str(run)],
                              cwd=ROOT, env=env, capture_output=True,
                              text=True)
        found = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("ATTN_REPEAT ")]
        if not found:
            print(f"run {run}: no record (rc {proc.returncode})\n"
                  + proc.stdout[-2000:] + proc.stderr[-2000:], flush=True)
            continue
        line = json.loads(found[-1].split(" ", 1)[1])
        line["seconds"] = round(time.monotonic() - t1, 1)
        tail = [ln for ln in proc.stdout.splitlines() if "passed" in ln
                or "failed" in ln][-1:]
        line["pytest_summary"] = tail[0] if tail else None
        lines.append(line)
        print(json.dumps(line), flush=True)
    failed = [ln for ln in lines if ln.get("case_passed") is False]
    print(json.dumps({"runs": len(lines), "case_failed": len(failed),
                      "failed_runs": [ln["run"] for ln in failed],
                      "seconds": round(time.monotonic() - t0, 1)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
