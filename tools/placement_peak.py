#!/usr/bin/env python3
"""A placed train step on several cards, per checkout, in turns.

Usage (on a machine with several CUDA GPUs):

    python3 tools/placement_peak.py --src A/src --src B/src \
        [--model-parallel 2] [--steps 4] [--arch qwen3-0.6b] \
        [--layers N] [--batch 8] [--seq 256] [--compute-dtype bfloat16] \
        [--grads-only]

Each ``--src`` tree runs under ``python -m torch.distributed.run
--standalone --nproc-per-node N`` (N the host's cards) in the turns A, B,
B, A (with more than two ``--src``, in their order and then back). A turn
places ``--arch`` (its first ``--layers`` layers at full width, all of
them by default; parameters from a fixed seed, float32,
``--compute-dtype`` compute) and its AdamW state on the ``(N // M, M)``
mesh of ``launch.mesh.make_host_mesh(M)``, sets the activation policy
and runs ``--steps`` train steps (remat "dots") on batches of
``--batch`` x ``--seq`` from ``data.pipeline.batch_for_step``; with
``--grads-only`` each step is the loss and the gradients alone (no AdamW
update, whose copies of every leaf can set the peak and hide the
layers'). It records each card's allocated bytes before the first step
and its peak over that step, and each step's seconds (the cards
synchronized, the host clock of process 0). Prints one line a turn and
a JSON summary: per tree, each turn's peaks, the median of the steps
after the first in ms and the losses.

The trees need only the port's package (``repro_torch``) and its
``place``, ``make_host_mesh``, ``set_activation_policy``,
``make_train_step`` and ``batch_for_step``, so an older checkout's
``src/`` (``git archive <commit> src``) runs as it is.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

SEED = 20260


def rank(out_path: str, model_parallel: int, steps: int, arch: str,
         layers: int, batch_size: int, seq: int, compute_dtype: str,
         grads_only: bool) -> int:
    """One process of a turn (the module's docstring)."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data.pipeline import batch_for_step
    from repro_torch.distributed import sharding
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as lm
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import (make_train_step,
                                              remat_loss_fn, value_and_grad)

    train.start_process_group()
    mesh = make_host_mesh(model_parallel)
    sharding.set_activation_policy(mesh)
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=layers or cfg.n_layers,
                              compute_dtype=compute_dtype)
    opt = AdamWConfig()
    params = sharding.place(lm.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED)), mesh)
    state = init_opt_state(opt, params)
    step = make_train_step(cfg, opt, remat="dots")
    shape = ShapeConfig("peak", seq, batch_size, "train")
    seconds, losses = [], []
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    peak = None
    for i in range(steps):
        batch = batch_for_step(cfg, shape, i)
        batch = sharding.place(batch, mesh,
                               sharding.batch_shardings(mesh, batch))
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if grads_only:
            loss, grads = value_and_grad(remat_loss_fn(cfg, "dots"), params,
                                         batch)
            del grads
        else:
            params, state, metrics = step(params, state, batch)
            loss = metrics["loss"]
        torch.cuda.synchronize()
        dist.barrier()
        seconds.append(time.perf_counter() - t0)
        losses.append(float(loss))
        if peak is None:
            peak = torch.cuda.max_memory_allocated()
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, (peak, before))
    if dist.get_rank() == 0:
        with open(out_path, "w") as f:
            json.dump({"mesh": list(mesh.devices.shape),
                       "peaks": [p for p, _ in got],
                       "before": [b for _, b in got],
                       "seconds": seconds, "losses": losses}, f)
    sharding.set_activation_policy(None)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", action="append", required=True,
                    help="a tree's src/ directory (repeat)")
    ap.add_argument("--model-parallel", type=int, default=2)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--layers", type=int, default=0,
                    help="the first N layers (0: all)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--compute-dtype", default="bfloat16")
    ap.add_argument("--grads-only", action="store_true")
    args = ap.parse_args()
    import torch
    n = torch.cuda.device_count()
    if n == 0:
        print("placement_peak: no CUDA device", file=sys.stderr)
        return 2
    order = args.src + args.src[::-1] if len(args.src) > 1 else args.src
    runs = {s: [] for s in args.src}
    with tempfile.TemporaryDirectory() as tmp:
        for i, src in enumerate(order):
            out = os.path.join(tmp, f"turn{i}.json")
            env = {**os.environ, "PYTHONPATH": os.path.abspath(src)}
            proc = subprocess.run(
                [sys.executable, "-m", "torch.distributed.run",
                 "--standalone", "--nproc-per-node", str(n),
                 os.path.abspath(__file__), "--rank", out,
                 str(args.model_parallel), str(args.steps), args.arch,
                 str(args.layers), str(args.batch), str(args.seq),
                 args.compute_dtype, str(int(args.grads_only))],
                env=env, capture_output=True, text=True, timeout=900)
            if proc.returncode:
                print(proc.stdout[-3000:], proc.stderr[-6000:],
                      file=sys.stderr)
                return 1
            with open(out) as f:
                rec = json.load(f)
            rec["median_ms"] = statistics.median(rec["seconds"][1:]) * 1e3 \
                if len(rec["seconds"]) > 1 else None
            runs[src].append(rec)
            print(f"[placement] {src} on {rec['mesh']}: peak bytes a card "
                  f"{rec['peaks']} (allocated before {rec['before']}); "
                  f"steps ms {[round(s * 1e3, 3) for s in rec['seconds']]}"
                  f", median after the first {rec['median_ms']}; losses "
                  f"{rec['losses']}", flush=True)
    print(json.dumps(runs))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
                      sys.argv[5], int(sys.argv[6]), int(sys.argv[7]),
                      int(sys.argv[8]), sys.argv[9], sys.argv[10] == "1"))
    sys.exit(main())
