"""Autoscheduler end-to-end on the PyTorch port: search the schedule space
for a fig12-shaped SpM*SpM, compare against every hand-written order,
then serve through the port's compiled engine with ``schedule="auto"``
(persistent schedule cache).

The counterpart of ``examples/autotune.py``. The search and the cycle
counts are the port's copies of the autoscheduler and the simulator (host
code); the engine runs on the GPU, or on the CPU with ``--device cpu``:

    PYTHONPATH=src python examples/torch_autotune.py [--device cpu]
"""
import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, "src")

import numpy as np

from repro_torch.core.autoschedule import (ScheduleCache, random_operand,
                                           resolve_schedule)
from repro_torch.core.schedule import Format, Schedule
from repro_torch.core.simulator import simulate_expr
from repro_torch.core.torch_backend import compile_expr
from repro_torch.kernels import ops as kops

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="CUDA unless given (an error without a GPU)")
args = ap.parse_args()

EXPR = "X(i,j) = B(i,k) * C(k,j)"
DIMS = {"i": 250, "j": 250, "k": 100}

rng = np.random.default_rng(0)
B = random_operand((250, 100), 0.05, rng)
C = random_operand((100, 250), 0.05, rng)
fmt = Format({"B": "cc", "C": "cc"})

# 1. the exhaustive baseline a user would otherwise have to guess among
print("exhaustive ijk dataflow orders (full-size simulated cycles):")
for order in ("ijk", "ikj", "jik", "jki", "kij", "kji"):
    res = simulate_expr(EXPR, fmt, Schedule(loop_order=tuple(order)),
                        {"B": B, "C": C}, DIMS)
    print(f"  {order}: {res.cycles}")

# 2. the autoscheduler: enumerate -> analytic prune -> simulate downsampled
cache = ScheduleCache(path=os.path.join(tempfile.mkdtemp(), "schedules.json"))
auto = resolve_schedule(EXPR, fmt, DIMS, arrays={"B": B, "C": C},
                        cache=cache, device_count=1)
rep = auto.report
print(f"\nautoscheduler: {rep.enumerated} schedules enumerated, "
      f"{rep.simulated} simulated at {rep.sample_dims} "
      f"in {rep.elapsed_s * 1e3:.0f}ms")
for cand in rep.candidates[:3]:
    print(f"  {cand.spec.key()}: sampled {cand.cycles} cycles")
sch = auto.schedule
full = simulate_expr(EXPR, fmt, sch, {"B": B, "C": C}, DIMS).cycles
print(f"picked order={''.join(sch.loop_order)} split={sch.split} "
      f"par={sch.parallelize}: {full} full-size cycles")

# 3. the same shape again: pure cache hit, no search
again = resolve_schedule(EXPR, fmt, DIMS, arrays={"B": B, "C": C},
                         cache=cache, device_count=1)
assert again.cache_hit and again.report is None
print("second resolution: schedule cache HIT (no search)")

# 4. serve it compiled: schedule="auto" inside the plan-cached engine
os.environ["SAM_SCHEDULE_CACHE"] = cache.path
eng = compile_expr(EXPR, fmt, "auto", DIMS, sparsity=0.05,
                   device=args.device)
out = eng.execute({"B": B, "C": C})
assert np.allclose(out.to_dense(), B @ C)
print(f"compiled engine (auto schedule) matches B @ C; stats: {eng.stats}")
print("kernel launches:", json.dumps(kops.launch_counts()))
print(f"OK: autotune on {eng.device}")
