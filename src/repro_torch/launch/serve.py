"""Serving launcher of the port: batched prefill + decode of a language
model with per-family caches (the default mode), and batched
sparse-expression serving through the compiled engine (``--sam``), on the
card by default.

    python -m repro_torch.launch.serve --arch qwen3-0.6b --reduced \
        --batch 4 --prompt-len 32 --gen 16

    # sparse-expression serving: compile once, dispatch batches through
    # the continuous-batching server
    python -m repro_torch.launch.serve \
        --sam "X(i,j) = B(i,k) * C(k,j)" --sam-order ikj \
        --sam-formats B=cc,C=cc --sam-dims i=64,j=64,k=64 \
        --batch 8 --reps 16

    # multi-expression PROGRAM serving: ';'-separated assignments compile
    # as one cascade; fusable producer→consumer stages run as one chain
    # on the device (the intermediate never reaches the host)
    python -m repro_torch.launch.serve \
        --sam "T(i,j) = B(i,j) * C(i,k) * D(j,k); A(i,j) = T(i,k) * E(k,j)" \
        --sam-dims i=32,j=32,k=32 --sam-density 0.2 --batch 4

    # out-of-core serving under a memory budget, the tiles spread over
    # workers with fault-tolerant retry
    python -m repro_torch.launch.serve \
        --sam "X(i,j) = B(i,k) * C(k,j)" --sam-order ikj \
        --sam-formats B=cc,C=dd --sam-dims i=512,j=512,k=512 \
        --mem-budget 24MB --workers 2 --batch 2 --reps 2

    # the lanes of a split spread over a lane mesh of 4 devices (4 GPUs,
    # or with --device cpu the CPU repeated 4 times)
    python -m repro_torch.launch.serve \
        --sam "X(i,j) = B(i,k) * C(k,j)" --sam-order ikj \
        --sam-formats B=cc,C=cc --sam-dims i=256,j=256,k=256 \
        --split i=4 --devices 4 --batch 4 --reps 2

Run from the repository root with ``PYTHONPATH=src``. ``--device cpu``
runs on the CPU (the plain PyTorch versions of the kernels); without it
and without a GPU every mode raises. ``--devices N`` shards the lanes
over N devices or fails: on the card it needs N GPUs; with ``--device
cpu``, ``main`` sets ``$SAM_LANE_DEVICES`` to N, a lane mesh of the CPU
repeated N times (the reference forces N host devices the same way).
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..configs import get_config, list_archs
from ..core import coord_ops as co
from ..core.einsum import parse
from ..core.program import parse_program
from ..core.schedule import Format, Schedule
from ..core.torch_backend import (LANE_DEVICES_ENV, compile_expr,
                                  compile_program, lane_device_count,
                                  lane_mesh_size)
from ..models.model import init_caches, init_params
from ..train.train_step import make_prefill_step, make_serve_step


def generate(cfg, params, prompts, gen_len: int, max_seq: int,
             temperature: float = 0.0, seed: int = 0):
    """prompts: (B, P) int32 on the parameters' device. Greedy (the
    default) or temperature sampling, batched; returns (B, P + gen_len)
    int32 tokens.

    Like the reference's, it serves token-input architectures only (the
    stub frontends take patches or frames a step). Sampling draws from a
    ``torch.Generator`` seeded with ``seed``, so its tokens differ from
    the reference's ``jax.random.categorical`` draws; greedy decoding
    takes the first maximum, as ``jnp.argmax`` does.
    """
    if cfg.frontend is not None:
        raise ValueError(f"{cfg.name} takes {cfg.frontend} inputs; "
                         f"generate serves token-input architectures")
    b, plen = prompts.shape
    dev = prompts.device
    caches = init_caches(cfg, b, max_seq, device=dev)
    prefill = make_prefill_step(cfg)
    step = make_serve_step(cfg)

    logits, caches = prefill(params, caches, {"tokens": prompts})
    out = [prompts]
    gen = torch.Generator(device=dev).manual_seed(seed)

    def pick(logits):
        if temperature > 0:
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=gen).int()
        return torch.argmax(logits, dim=-1)[:, None].int()

    tok = pick(logits)
    for _ in range(gen_len):
        out.append(tok)
        logits, caches = step(params, caches, {"tokens": tok})
        tok = pick(logits)
    return torch.cat(out, dim=1)


def serve_lm(arch: str, *, reduced: bool = False, batch: int = 4,
             prompt_len: int = 32, gen: int = 16, temperature: float = 0.0,
             device=None, log=print):
    """The language-model mode: parameters from seed 0 and prompts from
    seed 1 on ``device`` (CUDA unless the caller names one), then
    ``generate`` with room for 8 more tokens. Returns the sequences."""
    dev = co.resolve_device(device)
    cfg = get_config(arch, reduced=reduced)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    prompts = torch.randint(
        0, cfg.vocab, (batch, prompt_len), dtype=torch.int32, device=dev,
        generator=torch.Generator(device=dev).manual_seed(1))
    t0 = time.perf_counter()
    seqs = generate(cfg, params, prompts, gen, prompt_len + gen + 8,
                    temperature)
    seqs = seqs.cpu()          # waits for the card
    dt = time.perf_counter() - t0
    log(f"[serve] {arch}: batch={batch} prompt={prompt_len} gen={gen} on "
        f"{dev.type}: {dt:.2f}s  ({batch * gen / dt:.1f} tok/s, first "
        f"call)")
    log("[serve] first sequence:", seqs[0, :24].tolist(), "...")
    return seqs


def _parse_kv(text: str, cast=str):
    out = {}
    for item in text.split(","):
        if not item:
            continue
        if "=" not in item:
            raise SystemExit(
                f"expected comma-separated key=value pairs, got {item!r} "
                f"(e.g. B=cc,C=cc or i=64,j=64)")
        k, v = item.split("=", 1)
        out[k.strip()] = cast(v.strip())
    return out


def serve_sam(expr: str, order: str, formats, dims, *, batch: int = 8,
              reps: int = 8, density: float = 0.1, seed: int = 0,
              split=None, devices: int = 0, workers: int = 0,
              autotune: bool = False, mem_budget=None, device=None,
              log=print):
    """Sparse-expression serving: compile ONCE, then stream requests
    through the continuous-batching server (``core.serving.SamServer``).

    Every request in a dispatch shares the expression/format/schedule (one
    plan); only the operand data differs. The server coalesces the
    submitted requests by compiled-cache key into batched dispatches of
    width ``batch`` and overlaps host encode / device execute / host
    decode across consecutive dispatches. ``split={var: n}`` applies §4.4
    iteration splitting AND parallel lane duplication over that variable
    (the lanes run one after another on ``device``; ``devices`` asks for
    lanes over several GPUs, which ``compile_expr`` refuses).
    ``autotune=True`` picks the whole schedule through the autoscheduler
    and its persistent schedule cache. ``mem_budget`` (bytes or
    ``"64MB"``) bounds peak device allocation: requests whose untiled
    estimate exceeds it route through the out-of-core tiled driver, and
    ``workers > 1`` spreads its tiles over that many workers
    (``core.dist_exec.DistTiledExpr``). ``device`` places the engine:
    CUDA by default, ``"cpu"`` for the plain PyTorch versions. Returns
    (results of the last dispatch, engine stats).
    """
    from ..core import tiling

    device = co.resolve_device(device)
    if devices and lane_device_count(device) < devices:
        raise SystemExit(
            f"--devices {devices} requested but only "
            f"{lane_device_count(device)} device(s) present; on the CPU set "
            f"{LANE_DEVICES_ENV}={devices} (done by main for --device cpu)")
    split = dict(split or {})
    if autotune and split:
        raise SystemExit("--autotune searches the schedule (including "
                         "splits); drop --split")
    if mem_budget is not None:
        mem_budget = tiling.parse_budget(mem_budget)
    fmt = Format(dict(formats))
    if autotune:
        from ..core.autoschedule import resolve_schedule

        kw = {} if mem_budget is None else {"mem_budget": mem_budget}
        res = resolve_schedule(expr, fmt, dims, sparsity=density,
                               device_count=devices or 1, **kw)
        sch = res.schedule
        if res.cache_hit:
            log(f"[serve-sam] autotune: schedule cache HIT -> "
                f"order={''.join(sch.loop_order)} split={sch.split} "
                f"par={sch.parallelize} (no search, compiled dispatch only)")
        else:
            rep = res.report
            top = ", ".join(f"{c.spec.key()}:{c.cycles}cyc"
                            for c in rep.candidates[:3])
            log(f"[serve-sam] autotune: searched {rep.enumerated} schedules"
                + (" (order space capped)" if rep.orders_truncated else "")
                + f" ({rep.simulated} simulated at {rep.sample_dims}) in "
                f"{rep.elapsed_s * 1e3:.0f}ms -> "
                f"order={''.join(sch.loop_order)} split={sch.split} "
                f"par={sch.parallelize}; top: {top}")
        split = dict(sch.split)
    else:
        # §4.4: every requested variable splits; the OUTERMOST split
        # variable also parallelizes (the lowering supports one parallel
        # var)
        par = {v: split[v] for v in order if v in split}
        sch = Schedule(loop_order=tuple(order), split=split,
                       parallelize=dict(list(par.items())[:1]))
    if devices and not split:
        raise SystemExit(
            "--devices shards parallel lanes; "
            + ("--autotune picked an unsplit schedule for this shape"
               if autotune else "give --split too (e.g. --split k=4)"))
    par_n = max(sch.parallelize.values(), default=1)
    if devices and lane_mesh_size(par_n, devices, device) < 2:
        # an explicit --devices must shard or fail loudly (auto-detection
        # would run the lanes in series)
        raise SystemExit(
            f"--devices {devices}: no >1-device mesh fits {par_n} lane(s) "
            f"on {lane_device_count(device)} present device(s); "
            + ("--autotune picked a schedule without matching parallel "
               "lanes for this shape; drop --devices"
               if autotune else
               "pick a split factor a device subset divides"))
    eng = compile_expr(expr, fmt, sch, dims,
                       shard_lanes=devices if devices else None,
                       sparsity=density, mem_budget=mem_budget,
                       device=device)
    tiled = getattr(eng, "tile_of", None)
    if tiled:
        log(f"[serve-sam] mem-budget "
            f"{tiling.format_bytes(mem_budget) if mem_budget else 'n/a'}: "
            f"request routed OUT-OF-CORE -> tile={tiled} "
            f"({eng.n_tiles} tiles, ~{tiling.format_bytes(eng.tile_bytes)}"
            f"/tile; tiles stream through one plan-cached per-tile engine)")
    elif mem_budget is not None:
        log(f"[serve-sam] mem-budget {tiling.format_bytes(mem_budget)}: "
            f"untiled estimate fits, serving in-core")
    if workers and workers > 1:
        if tiled:
            from ..core.dist_exec import DistTiledExpr

            eng = DistTiledExpr(eng, workers=workers)
            log(f"[serve-sam] --workers {workers}: {eng.n_tiles} tiles "
                f"DISTRIBUTED over {len(eng.workers)} simulated worker(s) "
                f"with fault-tolerant retry (docs/DISTRIBUTED.md)")
        else:
            log(f"[serve-sam] --workers {workers}: request fits in-core "
                f"(untiled), nothing to distribute; serving single-device")
    if split:
        inner = getattr(eng, "engine", eng)     # a tiled engine's tile engine
        mesh = ", ".join(str(d) for d in inner._lane_devices)
        log(f"[serve-sam] split={split} parallelize={sch.parallelize}: "
            f"{eng.par_n}-lane {eng.low.merge_kind}-merge, "
            + (f"each request's lanes over a lane mesh of "
               f"{inner._lane_mesh} devices ({mesh})"
               if inner._shard_lanes else
               "lanes run one after another inside the batched dispatch"))
    assign = parse(expr)
    rng = np.random.default_rng(seed)

    def operand_set():
        from ..core.autoschedule import random_operand

        arrays = {}
        for term in assign.terms:
            for acc in term.factors:
                if acc.tensor in arrays:
                    continue
                shape = tuple(dims[v] for v in acc.vars)
                arrays[acc.tensor] = random_operand(shape, density, rng)
        return arrays

    # continuous-batching server: submit the whole load as one burst; the
    # batcher coalesces same-key requests into dispatches of width
    # ``batch`` while the pipeline overlaps encode/execute/decode across
    # consecutive dispatches (docs/SERVING.md)
    from ..core.serving import Request, SamServer

    srv = SamServer(max_batch=batch, device=eng.device)
    reqs = [Request(expr if isinstance(expr, str) else str(expr),
                    operand_set(), formats=fmt, dims=dims, density=density)
            for _ in range(batch * max(reps, 1))]
    handles = srv.submit_many(reqs, engine=eng)
    srv.drain(timeout=600)
    results = [h.result() for h in handles[-batch:]]
    sstats = srv.stats()
    srv.shutdown()
    log(f"[serve-sam] {expr!r}: {sstats['completed']} requests in "
        f"{sstats['dispatches']} dispatches "
        f"(occupancy {sstats['batch_occupancy']:.1f}): "
        f"{sstats['requests_per_sec']:.1f} req/s "
        f"p50={sstats['p50_ms']:.1f}ms p99={sstats['p99_ms']:.1f}ms")
    log(f"[serve-sam] engine stats: {eng.stats}")
    return results, eng.stats


def serve_program(text: str, formats, dims, *, batch: int = 8,
                  reps: int = 8, density: float = 0.1, seed: int = 0,
                  autotune: bool = False, mem_budget=None, device=None,
                  log=print):
    """Multi-expression program serving: compile the cascade ONCE
    (``torch_backend.compile_program``), then dispatch batches of operand
    sets through it.

    Fused producer→consumer stages run as one chain with the
    intermediates on the device; illegal fusions materialize between
    stages (the decisions are logged). ``autotune=True`` resolves every
    stage's schedule through the autoscheduler + persistent schedule
    cache. ``mem_budget`` routes over-sized unfused stages through the
    out-of-core tiled driver (docs/TILING.md). Returns (results of the
    last dispatch, program stats).
    """
    prog = parse_program(text)
    fmt = Format(dict(formats))
    schedules = "auto" if autotune else {
        a.lhs.tensor: Schedule(loop_order=tuple(a.all_vars))
        for a in prog.assigns}
    cp = compile_program(prog, fmt, schedules, dims, sparsity=density,
                         mem_budget=mem_budget, device=device)
    for d in cp.decisions:
        src, dst = prog.names[d.producer], prog.names[d.consumer]
        log(f"[serve-program] {d.tensor}: {src} -> {dst} "
            + ("FUSED (spliced streams, no materialization)" if d.fused
               else f"materialized ({d.reason})"))
    if not cp.decisions:
        log("[serve-program] single-stage program (nothing to fuse)")
    for kind, comp, unit in cp.units:
        if kind == "expr" and getattr(unit, "tile_of", None):
            from ..core import tiling
            log(f"[serve-program] stage {unit.assign.lhs.tensor}: "
                f"OUT-OF-CORE tile={unit.tile_of} ({unit.n_tiles} tiles, "
                f"~{tiling.format_bytes(unit.tile_bytes)}/tile)")
    rng = np.random.default_rng(seed)

    def operand_set():
        from ..core.autoschedule import random_operand

        free = set(prog.inputs)
        out = {}
        for a in prog.assigns:
            for trm in a.terms:
                for f in trm.factors:
                    if f.tensor in free and f.tensor not in out:
                        out[f.tensor] = random_operand(
                            tuple(dims[v] for v in f.vars), density, rng)
        return out

    # program requests stream through the same continuous-batching
    # server (coalesced by program cache key; stages execute per request
    # inside the pipeline's dispatch stage)
    from ..core.serving import Request, SamServer

    srv = SamServer(max_batch=batch, device=cp.device)
    reqs = [Request(text, operand_set(), formats=fmt, dims=dims,
                    density=density)
            for _ in range(batch * max(reps, 1))]
    handles = srv.submit_many(reqs, engine=cp)
    srv.drain(timeout=600)
    results = [h.result() for h in handles[-batch:]]
    sstats = srv.stats()
    srv.shutdown()
    log(f"[serve-program] {len(prog.assigns)} stages, outputs="
        f"{','.join(prog.outputs)}: {sstats['completed']} requests in "
        f"{sstats['dispatches']} dispatches: "
        f"{sstats['requests_per_sec']:.1f} req/s "
        f"p50={sstats['p50_ms']:.1f}ms p99={sstats['p99_ms']:.1f}ms")
    log(f"[serve-program] program stats: {cp.stats}")
    return results, cp.stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--sam", default=None, metavar="EXPR",
                    help="serve a sparse expression instead of an LM; "
                         "';'-separated assignments serve as a PROGRAM "
                         "with producer→consumer fusion, e.g. "
                         "\"T(i,j) = B(i,k) * C(k,j); "
                         "A(i,j) = T(i,k) * E(k,j)\"")
    ap.add_argument("--sam-order", default=None,
                    help="loop order, e.g. ikj (default: lhs+reduction vars)")
    ap.add_argument("--sam-formats", default="",
                    help="per-tensor formats, e.g. B=cc,C=cc")
    ap.add_argument("--sam-dims", default="",
                    help="index extents, e.g. i=64,j=64,k=64")
    ap.add_argument("--sam-density", type=float, default=0.1)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--split", default="", metavar="VAR=N[,VAR=N]",
                    help="§4.4 iteration splitting + N parallel lanes, "
                         "e.g. k=4 (implies parallelize)")
    ap.add_argument("--devices", type=int, default=0,
                    help="shard parallel lanes over a lane mesh of this "
                         "many devices (GPUs; with --device cpu the CPU "
                         "repeated), or fail")
    ap.add_argument("--workers", type=int, default=0,
                    help="distribute out-of-core tile grids over this "
                         "many workers with fault-tolerant retry "
                         "(docs/DISTRIBUTED.md); needs --mem-budget "
                         "small enough to tile")
    ap.add_argument("--autotune", action="store_true",
                    help="search the schedule space (loop order, split, "
                         "lanes) with the simulator cost model on the "
                         "first request per shape; later requests hit the "
                         "persistent schedule cache and serve compiled")
    ap.add_argument("--mem-budget", default=None, metavar="BYTES",
                    help="peak device-allocation budget (e.g. 64MB or "
                         "67108864); requests whose untiled estimate "
                         "exceeds it stream through the out-of-core "
                         "tiled engine automatically (docs/TILING.md)")
    ap.add_argument("--device", default="cuda",
                    help="where the model or the engines run: cuda (the "
                         "default) or cpu (the plain PyTorch versions)")
    args = ap.parse_args(argv)
    if (args.devices > 1 and args.device is not None
            and torch.device(args.device).type == "cpu"
            and lane_device_count("cpu") < args.devices):
        # the CPU lane mesh of --devices (the reference forces as many
        # host devices before JAX starts)
        os.environ[LANE_DEVICES_ENV] = str(args.devices)

    if not args.sam:
        return serve_lm(args.arch, reduced=args.reduced, batch=args.batch,
                        prompt_len=args.prompt_len, gen=args.gen,
                        temperature=args.temperature, device=args.device)

    if ";" in args.sam:
        # multi-expression program serving (producer→consumer fusion)
        if args.sam_order or args.split:
            raise SystemExit("program serving schedules per stage; drop "
                             "--sam-order/--split (use --autotune)")
        if args.devices:
            raise SystemExit("program serving does not shard lanes yet; "
                             "drop --devices (stages run serial, fused "
                             "where legal)")
        if args.workers:
            raise SystemExit("program serving does not distribute tiles "
                             "yet; drop --workers (single-expression "
                             "--sam supports it)")
        prog = parse_program(args.sam)
        all_vars = [v for a in prog.assigns for v in a.all_vars]
        dims = {**{v: 64 for v in all_vars},
                **_parse_kv(args.sam_dims, int)}
        results, _ = serve_program(args.sam, _parse_kv(args.sam_formats),
                                   dims, batch=args.batch, reps=args.reps,
                                   density=args.sam_density,
                                   autotune=args.autotune,
                                   mem_budget=args.mem_budget,
                                   device=args.device)
        return results

    if args.autotune and args.sam_order:
        raise SystemExit("--autotune searches the loop order; drop "
                         "--sam-order (like --split)")
    assign = parse(args.sam)
    order = args.sam_order or "".join(assign.all_vars)
    dims = {**{v: 64 for v in order}, **_parse_kv(args.sam_dims, int)}
    formats = _parse_kv(args.sam_formats)
    results, _ = serve_sam(args.sam, order, formats, dims,
                           batch=args.batch, reps=args.reps,
                           density=args.sam_density,
                           split=_parse_kv(args.split, int),
                           devices=args.devices, workers=args.workers,
                           autotune=args.autotune,
                           mem_budget=args.mem_budget, device=args.device)
    return results


if __name__ == "__main__":
    main()
