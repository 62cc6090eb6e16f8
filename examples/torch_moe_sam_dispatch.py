"""SAM-dispatched Mixture-of-Experts on the PyTorch port: the paper's
dataflow-order study inside an LM layer.

The counterpart of ``examples/moe_sam_dispatch.py``. Runs on the GPU;
``--device cpu`` runs on the CPU:

    PYTHONPATH=src python examples/torch_moe_sam_dispatch.py [--device cpu]
"""
import argparse
import sys
import time

sys.path.insert(0, "src")

import torch

from repro_torch.core.coord_ops import resolve_device
from repro_torch.models import moe as moe_mod

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="CUDA unless given (an error without a GPU)")
args = ap.parse_args()
dev = resolve_device(args.device)

D, DFF, E, K, T = 64, 128, 32, 2, 8192
p = moe_mod.init_moe(torch.Generator(device=dev).manual_seed(0), D, DFF, E)
x = torch.randn((T, D), generator=torch.Generator(device=dev).manual_seed(1),
                device=dev)

print(f"MoE: {E} experts, top-{K}, {T} tokens on {dev}")
print("routing expression:  Y[e,c,d] = sum_t G[e,c,t] * X[t,d]   "
      "(G = top-k one-hot, a sparse tensor)")


def sam(xx):
    return moe_mod.moe_sam_dispatch(p, xx, k=K, capacity_factor=2.0,
                                    compute_dtype=torch.float32)


def dense(xx):
    return moe_mod.moe_dense_dispatch(p, xx, k=K,
                                      compute_dtype=torch.float32)


y_sam, y_dense = sam(x), dense(x)
err = float((y_sam - y_dense).abs().max())
print(f"\nmax |sam - dense| = {err:.2e}  (identical up to capacity drops)")
# capacity 2x the mean load drops nothing here, so the two agree to
# float32 resolution
assert err <= 1e-5 * float(y_dense.abs().max()), err


def bench(f):
    f(x)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        f(x)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / 5 * 1e3


ms_sam, ms_dense = bench(sam), bench(dense)
print(f"dense one-hot (O(E*T*D), inner-product order): {ms_dense:8.2f} ms")
print(f"SAM sort-dispatch (O(k*T*D), Gustavson order): {ms_sam:8.2f} ms")
print(f"speedup {ms_dense / ms_sam:.1f}x   (analytic work ratio E/k = "
      f"{E // K}x)")
print("OK")
