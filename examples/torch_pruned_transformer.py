"""Pruned-transformer inference as SAM programs on the PyTorch port.

The counterpart of ``examples/pruned_transformer.py``: two decoder blocks
of a reduced ``qwen3-0.6b`` with magnitude-pruned FFN weights compiled
through the port's ``compile_program`` (autoscheduler + compiled cache)
and block-sparse sliding-window attention served through the port's
``SamServer`` on the ``bsr_bridge`` attention pattern (the
``bsr_attention`` CUDA kernel on a GPU). The whole forward is checked
against the dense float64 numpy oracle. Runs on the GPU; ``--device cpu``
runs the kernels' plain PyTorch versions:

    PYTHONPATH=src python examples/torch_pruned_transformer.py [--device cpu]
"""
import argparse
import sys

sys.path.insert(0, "src")

import numpy as np

from repro_torch.configs.qwen3_0_6b import REDUCED
from repro_torch.models.pruned_transformer import PrunedTransformer

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="CUDA unless given (an error without a GPU)")
args = ap.parse_args()

rng = np.random.default_rng(0)
with PrunedTransformer(REDUCED, seq_len=32, block=8, window_blocks=2,
                       ffn_density=0.5, device=args.device) as model:
    x = rng.standard_normal((32, REDUCED.d_model)).astype(np.float32)
    y = model(x)
    ref = model.reference(x)
    err = np.abs(y - ref).max() / np.abs(ref).max()
    stats = model.stats()

assert err < 1e-5, f"relative error {err}"
# 4 heads x 2 layers coalesce into one batched dispatch per layer, and
# the FFN executables compile once then serve both layers
assert stats["server"]["completed"] == 8
assert stats["server"]["dispatches"] == 2
assert stats["ffn_up_calls"] == 2
print(f"OK on {model.device}: rel err {err:.2e}, "
      f"{stats['server']['completed']} attention requests in "
      f"{stats['server']['dispatches']} dispatches")
