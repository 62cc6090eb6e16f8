"""Training launcher: fault-tolerant and resumable, on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
        --reduced --steps 100 --batch 8 --seq 128 --ckpt-dir CKPT_DIR

A port of ``repro.launch.train``: the host mesh, placement on it, and
the fault-tolerance runner (deterministic data, atomic async
checkpoints, straggler watchdog, automatic resume).
It runs on the card unless ``--device`` names another (``cpu`` runs the
plain PyTorch path on the CPU; without a GPU and without ``--device`` it
raises). ``--model-parallel`` above 1, the activation-sharding policy
and placement over several devices wait for lanes over several devices
(ROADMAP.md, still to port #5). The reference donates the state to its
jitted step; the port's step is functional, so the runner holds the old
state until the new one replaces it.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from ..configs import get_config, list_archs
from ..configs.base import ShapeConfig
from ..core import coord_ops as co
from ..data.pipeline import batch_for_step
from ..distributed.checkpoint import Checkpointer
from ..distributed.fault_tolerance import StragglerPolicy, TrainingRunner
from ..distributed.sharding import place
from ..models.model import init_params
from ..train.optimizer import AdamWConfig, init_opt_state
from ..train.train_step import make_train_step
from .mesh import make_host_mesh

__all__ = ["build", "main"]

_MULTI_DEVICE = ("--model-parallel above 1 waits for placement over "
                 "several devices (ROADMAP.md, still to port #5)")


def build(arch: str, *, reduced: bool, batch: int, seq: int,
          remat: str = "dots", n_micro: int = 1, lr: float = 3e-4,
          steps: int = 100, model_parallel: int = 1,
          compress_grads: bool = False, device=None):
    """(cfg, mesh, (params, opt_state), step_runner, data_fn) for the
    runner, on the host mesh of ``device``'s kind (one device)."""
    if model_parallel != 1:
        raise NotImplementedError(_MULTI_DEVICE)
    dev = co.resolve_device(device)
    cfg = get_config(arch, reduced=reduced)
    mesh = make_host_mesh(device=dev)
    shape = ShapeConfig("custom", seq, batch, "train")
    opt = AdamWConfig(lr=lr, total_steps=steps, warmup_steps=min(20, steps))

    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    opt_state = init_opt_state(opt, params)
    params = place(params, mesh)

    step_fn = make_train_step(cfg, opt, remat=remat, n_micro=n_micro,
                              compress_grads=compress_grads)

    def data_fn(step):
        return batch_for_step(cfg, shape, step, device=dev)

    def step_runner(state, batch_):
        p, o = state
        p, o, metrics = step_fn(p, o, batch_)
        return (p, o), metrics

    return cfg, mesh, (params, opt_state), step_runner, data_fn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), default="llama3.2-3b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--remat", default="dots")
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="the device to train on (CUDA by default; cpu "
                         "runs the plain PyTorch path)")
    args = ap.parse_args(argv)

    cfg, mesh, state, step_runner, data_fn = build(
        args.arch, reduced=args.reduced, batch=args.batch, seq=args.seq,
        remat=args.remat, n_micro=args.n_micro, lr=args.lr,
        steps=args.steps, model_parallel=args.model_parallel,
        compress_grads=args.compress_grads, device=args.device)

    runner = TrainingRunner(
        step_runner, data_fn, Checkpointer(args.ckpt_dir),
        ckpt_every=args.ckpt_every,
        straggler=StragglerPolicy(on_straggler=lambda s, dt, ema: print(
            f"[straggler] step {s}: {dt:.2f}s vs ema {ema:.2f}s")))
    state, history = runner.run(state, args.steps)
    losses = [h["loss"] for h in history]
    if losses:
        print(f"[train] {args.arch} steps={len(history)} "
              f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    return losses


if __name__ == "__main__":
    main()
