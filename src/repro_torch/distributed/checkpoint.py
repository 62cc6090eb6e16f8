"""Checkpointing: atomic, async, manifest-driven.

Layout: ``<dir>/step_<N:08d>/shard_0.npz`` + ``manifest.json``. Writes go
to a ``.tmp`` directory and are renamed into place only after fsync — a
crashed writer can never corrupt the latest checkpoint; ``.tmp``
directories are never taken for a checkpoint. An async writer thread
keeps the train loop running during serialization; ``wait()`` joins
before the next save. Old steps are removed down to ``keep``.

A port of ``repro.distributed.checkpoint``. Leaves are flattened in
``jax.tree_util``'s order (a dict's keys sorted, lists and tuples in
order), so ``leaf_i`` is the same tensor in both packages and a
checkpoint written by one restores in the other. ``save`` copies every
leaf to host numpy before it returns (the writer thread reads only those
copies, never a tensor the next step may change); bfloat16 and float8
leaves are saved as float32 and cast back to the template's dtype on
restore, each leaf put on its template leaf's device. One process writes
one shard (``shard_0``). A state placed over a process group's mesh
(DTensor leaves) saves in the same layout, leaf for leaf whole: every
process's ``save`` is a collective that gathers each leaf, process 0
alone writes, and ``wait`` is a barrier after the write, so that every
process then sees the checkpoint; a restore places each leaf as its
template leaf is placed (the current mesh's specs), so a checkpoint
moves between meshes and device counts. ``seconds`` holds the wall
seconds of the last save's host copy (``"copy"``) and write
(``"write"``, in the writer thread) and of the last restore
(``"restore"``).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from ..models.model import tree_leaves, tree_unflatten
from .sharding import full_tensors

__all__ = ["Checkpointer"]

_NPZ_UNSAFE = (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2)


def _structure(tree) -> str:
    """The tree's structure as text for the manifest (``*`` a leaf)."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        return "[" + ", ".join(_structure(v) for v in tree) + "]"
    return "None" if tree is None else "*"


def _flatten(tree) -> dict:
    out = {}
    for i, leaf in enumerate(tree_leaves(tree)):
        t = torch.as_tensor(leaf).detach()
        if t.dtype in _NPZ_UNSAFE:
            t = t.float()                  # npz-safe; restore re-casts
        out[f"leaf_{i}"] = t.to("cpu", copy=True).numpy()
    return out


def _like(full: torch.Tensor, tmpl):
    """A restored leaf with ``tmpl``'s dtype and device, and its placements
    where it is a DTensor."""
    t = full.to(device=tmpl.device, dtype=tmpl.dtype)
    if isinstance(tmpl, DTensor):
        return distribute_tensor(t, tmpl.device_mesh, tmpl.placements)
    return t


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._collective = False    # a save over a process group's mesh
        self.seconds = {}

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state, blocking: bool = False) -> None:
        self.wait()
        t0 = time.perf_counter()
        self._collective = any(isinstance(t, DTensor)
                               for t in tree_leaves(state))
        if self._collective:
            state = full_tensors(state)
        writer = not self._collective or dist.get_rank() == 0
        arrays = _flatten(state) if writer else {}
        self.seconds["copy"] = time.perf_counter() - t0
        if not writer:
            return
        manifest = {"step": step, "treedef": _structure(state),
                    "n_leaves": len(arrays), "version": 1}

        def write():
            t0 = time.perf_counter()
            final = os.path.join(self.dir, f"step_{step:08d}")
            tmp = final + ".tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            with open(os.path.join(tmp, "shard_0.npz"), "wb") as f:
                np.savez(f, **arrays)
                f.flush()
                os.fsync(f.fileno())
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)       # atomic publish
            self._gc()
            self.seconds["write"] = time.perf_counter() - t0

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._collective:            # every process sees the write
            dist.barrier()
            self._collective = False

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore -------------------------------------------------------------
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name,
                                               "manifest.json")):
                    out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: Optional[int] = None) -> Tuple[object,
                                                                    int]:
        """Restore into the structure, dtypes and devices of ``template``
        (a DTensor leaf with its placements: a collective)."""
        t0 = time.perf_counter()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        leaves = tree_leaves(template)
        with np.load(os.path.join(path, "shard_0.npz")) as data:
            if len(leaves) != len(data.files):
                raise ValueError(
                    f"checkpoint has {len(data.files)} leaves, template "
                    f"{len(leaves)} — elastic reshard required (see "
                    f"elastic.py)")
            new = [_like(torch.from_numpy(data[f"leaf_{i}"]), tmpl)
                   for i, tmpl in enumerate(leaves)]
        out = tree_unflatten(template, new)
        self.seconds["restore"] = time.perf_counter() - t0
        return out, step
