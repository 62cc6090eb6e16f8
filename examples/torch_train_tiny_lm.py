"""End-to-end training on the PyTorch port: train a small LM for a few
hundred steps with checkpointing, deterministic data and automatic
resume.

The counterpart of ``examples/train_tiny_lm.py``, through the port's
launcher (``repro_torch.launch.train.main``). The synthetic tokens are
uniform over the vocabulary, so no model can beat ln(vocab) nats a
token: the check is that every loss is finite and the last lies within
1% of that entropy (a first loss above it need not be followed by a
lower last one). Runs on the GPU; ``--device cpu`` runs on the CPU:

    PYTHONPATH=src python examples/torch_train_tiny_lm.py [--steps 120] \
        [--device cpu]
"""
import argparse
import math
import os
import shutil
import sys
import tempfile

sys.path.insert(0, "src")

from repro_torch.configs import get_config
from repro_torch.launch.train import main as train_main

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=120)
ap.add_argument("--arch", default="llama3.2-3b")
ap.add_argument("--ckpt-dir", default=os.path.join(
    tempfile.gettempdir(), "repro_torch_tiny_lm"))
ap.add_argument("--device", default=None,
                help="CUDA unless given (an error without a GPU)")
args = ap.parse_args()

shutil.rmtree(args.ckpt_dir, ignore_errors=True)
argv = ["--arch", args.arch, "--reduced",
        "--steps", str(args.steps),
        "--batch", "16", "--seq", "128",
        "--lr", "1e-3", "--ckpt-dir", args.ckpt_dir,
        "--ckpt-every", "50"]
if args.device:
    argv += ["--device", args.device]
losses = train_main(argv)
entropy = math.log(get_config(args.arch, reduced=True).vocab)
assert all(math.isfinite(x) for x in losses), losses
assert abs(losses[-1] - entropy) < 0.01 * entropy, (losses[-1], entropy)
print(f"OK: loss {losses[0]:.3f} -> {losses[-1]:.3f} over {len(losses)} steps"
      f" (ln vocab {entropy:.3f}; checkpoints in {args.ckpt_dir})")
