"""SpM*SpM three ways on the PyTorch port: dataflow orders on the SAM
simulator, the port's coordinate-array backend, and the block-sparse
``spmm_bsr`` kernel.

The counterpart of ``examples/spmm_gustavson.py``, with its sizes and
checks; it builds its operands itself (the reference's come from the
benchmark helpers). Runs on the GPU; ``--device cpu`` runs the plain
PyTorch path on the CPU:

    PYTHONPATH=src python examples/torch_spmm_gustavson.py [--device cpu]
"""
import argparse
import json
import sys

sys.path.insert(0, "src")

import numpy as np
import torch

from repro_torch.core.autoschedule import random_operand
from repro_torch.core.custard import compile_expr
from repro_torch.core.einsum import parse
from repro_torch.core.schedule import Format, Schedule, build_inputs
from repro_torch.core.simulator import simulate
from repro_torch.core.torch_backend import execute_expr
from repro_torch.kernels import ops

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="CUDA unless given (an error without a GPU)")
args = ap.parse_args()
device = torch.device(args.device or "cuda")

EXPR = "X(i,j) = B(i,k) * C(k,j)"
rng = np.random.default_rng(20230325)
I, J, K = 64, 48, 56
B = random_operand((I, K), 0.3, rng)
# banded structure: block sparsity is what the BCSR tile level exploits
for i in range(I):
    for k in range(K):
        if abs(i - k) > 12:
            B[i, k] = 0.0
C = random_operand((K, J), 0.15, rng)
want = B @ C
dims = {"i": I, "j": J, "k": K}
fmt = Format({"B": "cc", "C": "cc"})

print("=== dataflow orders on the cycle-approximate simulator ===")
for order, label in (("ijk", "inner product"),
                     ("ikj", "linear combination (Gustavson)"),
                     ("kij", "outer product")):
    sch = Schedule(loop_order=tuple(order))
    graph = compile_expr(EXPR, fmt, sch, dims)
    res = simulate(graph, build_inputs(parse(EXPR), fmt, sch,
                                       {"B": B, "C": C}))
    assert np.allclose(res.outputs["X"].to_dense(), want)
    print(f"  {order} ({label:30s}): {res.cycles:8d} cycles, "
          f"bottleneck {res.bottleneck().kind}")

print("\n=== the port's coordinate-array backend ===")
out = execute_expr(EXPR, fmt, Schedule(loop_order=("i", "k", "j")),
                   {"B": B, "C": C}, dims, device=device)
assert np.allclose(out.to_dense(), want)
print("  Gustavson order matches dense oracle")

print("\n=== the BCSR kernel spmm_bsr (the tile-level SAM graph) ===")
bs = 16
Bb = np.zeros(((I + bs - 1) // bs * bs, (K + bs - 1) // bs * bs))
Bb[:I, :K] = B
occ = Bb.reshape(Bb.shape[0] // bs, bs, Bb.shape[1] // bs, bs) \
    .transpose(0, 2, 1, 3)
rows, cols = np.nonzero(np.abs(occ).sum((2, 3)) > 0)
blocks = occ[rows, cols].astype(np.float32)
blk_map, col_idx, blocks_p = ops.bsr_from_block_coords(
    rows, cols, blocks, occ.shape[0])
Cpad = np.zeros((Bb.shape[1], 128), np.float32)
Cpad[:K, :J] = C
got = ops.spmm_bsr(*(torch.from_numpy(a).to(device)
                     for a in (blk_map, col_idx, blocks_p, Cpad)))
assert np.allclose(got.cpu().numpy()[:I, :J], want, atol=1e-4)
nnzb = len(rows)
total_b = occ.shape[0] * occ.shape[1]
print(f"  {nnzb}/{total_b} nonzero blocks touched "
      f"({100 * nnzb / total_b:.0f}% of the dense tile grid) — matches oracle")
print("kernel launches:", json.dumps(ops.launch_counts()))
print(f"OK: SpM*SpM three ways on {device}")
