"""Quickstart on the PyTorch port: compile a sparse expression with
Custard, inspect the SAM graph, simulate it, and run the port's torch
backend and its compiled engine.

The counterpart of ``examples/quickstart.py``. Runs on the GPU;
``--device cpu`` runs the plain PyTorch path on the CPU:

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import json
import sys

sys.path.insert(0, "src")

import numpy as np

from repro_torch.core.custard import compile_expr
from repro_torch.core.einsum import parse
from repro_torch.core.schedule import Format, Schedule, build_inputs
from repro_torch.core.simulator import simulate
from repro_torch.core.torch_backend import compile_expr as compile_engine
from repro_torch.core.torch_backend import execute_expr
from repro_torch.kernels import ops as kops

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="CUDA unless given (an error without a GPU)")
args = ap.parse_args()

# sparse matrix-vector multiply in tensor index notation
EXPR = "x(i) = B(i,j) * c(j)"
DIMS = {"i": 8, "j": 10}

rng = np.random.default_rng(0)
B = ((rng.random((8, 10)) < 0.3) * rng.integers(1, 9, (8, 10))).astype(float)
c = ((rng.random(10) < 0.5) * rng.integers(1, 9, 10)).astype(float)

fmt = Format({"B": "cc", "c": "c"})          # DCSR matrix, compressed vector
sch = Schedule(loop_order=("i", "j"))        # dataflow (iteration) order

# 1. Custard: tensor index notation -> SAM dataflow graph
graph = compile_expr(EXPR, fmt, sch, DIMS)
print("SAM primitive counts:", graph.primitive_counts())
print("\nGraphviz DOT (paste into any dot viewer):\n")
print(graph.to_dot()[:400], "...\n")

# 2. cycle-approximate simulation (the paper's evaluation vehicle)
tensors = build_inputs(parse(EXPR), fmt, sch, {"B": B, "c": c})
res = simulate(graph, tensors)
print(f"simulated cycles: {res.cycles}; bottleneck block: {res.bottleneck()}")
print("x =", res.outputs["x"].to_dense())

# 3. the port's coordinate-array backend (same graph, torch execution)
out = execute_expr(EXPR, fmt, sch, {"B": B, "c": c}, DIMS, device=args.device)
print("torch backend x =", out.to_dense())
assert np.allclose(out.to_dense(), B @ c)
print("\nmatches B @ c — OK")

# 4. the compiled engine: plan-cached, batched dispatch
eng = compile_engine(EXPR, fmt, sch, DIMS, device=args.device)
eng({"B": B, "c": c})                         # first call records a plan
eng({"B": B * 2, "c": c})                     # plan hit: no new plan
outs = eng.execute_batch([{"B": B, "c": c}, {"B": B * 3, "c": c}])
assert np.allclose(outs[1].to_dense(), 3 * (B @ c))
print("compiled engine stats:", eng.stats)
print("kernel launches:", json.dumps(kops.launch_counts()))
print(f"OK: quickstart on {eng.device}")
