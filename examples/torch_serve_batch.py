"""Batched serving on the PyTorch port: prefill a batch of prompts, then
decode with per-family KV/state caches (GQA here; MLA and SSM caches work
the same).

The counterpart of ``examples/serve_batch.py``, through the port's
launcher (``repro_torch.launch.serve.main``). Runs on the GPU;
``--device cpu`` runs on the CPU:

    PYTHONPATH=src python examples/torch_serve_batch.py [--device cpu]
"""
import argparse
import sys

sys.path.insert(0, "src")

from repro_torch.launch.serve import main as serve_main

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="CUDA unless given (an error without a GPU)")
args = ap.parse_args()

argv = ["--arch", "qwen3-0.6b", "--reduced",
        "--batch", "4", "--prompt-len", "24", "--gen", "12"]
if args.device:
    argv += ["--device", args.device]
seqs = serve_main(argv)
assert tuple(seqs.shape) == (4, 24 + 12)
print("OK: generated", tuple(seqs.shape))
