"""Training launcher: mesh-aware, fault-tolerant and resumable.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
        --reduced --steps 100 --batch 8 --seq 128 --ckpt-dir CKPT_DIR

    # one process a device, the parameters placed over a (2, 2) mesh
    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 4 -m repro_torch.launch.train --arch qwen3-0.6b \
        --reduced --model-parallel 2 --steps 2 --device cpu

A port of ``repro.launch.train``: the host mesh, placement on it, the
activation-sharding policy, and the fault-tolerance runner
(deterministic data, atomic async checkpoints, straggler watchdog,
automatic resume). It runs on the card unless ``--device`` names another
(``cpu`` runs the plain PyTorch path on the CPU; without a GPU and
without ``--device`` it raises). Run plainly it is one process on one
device. Under ``torch.distributed.run`` (its ``RANK``, ``WORLD_SIZE``
and ``LOCAL_RANK``) ``build`` starts the process group (NCCL, each
process on ``cuda:LOCAL_RANK``; gloo for ``--device cpu``), builds the
``(world // model_parallel, model_parallel)`` mesh, sets the activation
policy, places the parameters and the optimizer's state by the sharding
rules and each batch by ``batch_spec`` (every process draws the same
global batch: ``batch_for_step`` is a function of the step alone);
only process 0 prints the ``[train]`` line. The reference donates the
state to its jitted step; the port's step is functional, so the runner
holds the old state until the new one replaces it.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch
import torch.distributed as dist

from ..configs import get_config, list_archs
from ..configs.base import ShapeConfig
from ..core import coord_ops as co
from ..data.pipeline import batch_for_step
from ..distributed.checkpoint import Checkpointer
from ..distributed.fault_tolerance import StragglerPolicy, TrainingRunner
from ..distributed.sharding import (batch_shardings, place,
                                    set_activation_policy)
from ..models.model import init_params
from ..train.optimizer import AdamWConfig, init_opt_state
from ..train.train_step import make_train_step
from .mesh import make_host_mesh

__all__ = ["build", "main"]


def start_process_group(device=None) -> bool:
    """Start the process group that ``torch.distributed.run``'s
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``) describes: NCCL
    with this process on ``cuda:LOCAL_RANK``, or gloo for a CPU
    ``device``. Returns whether it started one (not without that
    environment, nor when a group exists already)."""
    if dist.is_initialized() or "RANK" not in os.environ:
        return False
    if torch.device("cuda" if device is None else device).type == "cuda":
        local = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        co.resolve_device(local)
        torch.cuda.set_device(local)
        dist.init_process_group("nccl", device_id=local)
    else:
        dist.init_process_group("gloo")
    return True


def build(arch: str, *, reduced: bool, batch: int, seq: int,
          remat: str = "dots", n_micro: int = 1, lr: float = 3e-4,
          steps: int = 100, model_parallel: int = 1,
          compress_grads: bool = False, device=None):
    """(cfg, mesh, (params, opt_state), step_runner, data_fn) for the
    runner, on the host mesh of ``device``'s kind: one device, or under
    ``torch.distributed.run`` the process group's ``(n // model_parallel,
    model_parallel)`` mesh (module docstring). ``ValueError`` when
    ``model_parallel`` does not divide the process count."""
    start_process_group(device)
    dev = co.resolve_device(device)
    if dev.type == "cuda" and dist.is_initialized():
        dev = torch.device("cuda", torch.cuda.current_device())
    cfg = get_config(arch, reduced=reduced)
    mesh = make_host_mesh(model_parallel, device=dev)
    set_activation_policy(mesh)
    shape = ShapeConfig("custom", seq, batch, "train")
    opt = AdamWConfig(lr=lr, total_steps=steps, warmup_steps=min(20, steps))

    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    params = place(params, mesh)
    opt_state = init_opt_state(opt, params)    # moments placed as params

    step_fn = make_train_step(cfg, opt, remat=remat, n_micro=n_micro,
                              compress_grads=compress_grads)

    def data_fn(step):
        b = batch_for_step(cfg, shape, step, device=dev)
        if mesh.device_mesh is None:
            return b
        return place(b, mesh, batch_shardings(mesh, b))

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

    started = start_process_group(args.device)
    try:
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
        first = not dist.is_initialized() or dist.get_rank() == 0
    finally:
        if started:
            set_activation_policy(None)
            dist.destroy_process_group()
    losses = [h["loss"] for h in history]
    if losses and first:
        print(f"[train] {args.arch} steps={len(history)} "
              f"loss {losses[0]:.3f} -> {losses[-1]:.3f}"
              + (f" on a {dict(mesh.shape)} mesh" if mesh.size > 1 else ""))
        print(f"[train] losses {losses!r}", flush=True)
    return losses


if __name__ == "__main__":
    main()
