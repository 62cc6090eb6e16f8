"""Probe-based roofline sweep: every (arch x shape) cell on the
single-pod 16x16 mesh, extrapolated from layer probes
(``roofline.probe``), at the H100's rates.

A port of ``repro.launch.roofline_sweep``; the probes are counted on meta
tensors (``launch.dryrun.lower_cell``), so no device is needed::

    PYTHONPATH=src python -m repro_torch.launch.roofline_sweep \\
        --json roofline.json [--arch qwen3-0.6b --shape train_4k]

``--sam`` switches to the SAM (format x schedule x hardware) sweep: the
autoscheduler searches the joint format+schedule space once, then every
surviving candidate is re-costed under every ``simulator.HW_PRESETS``
hardware model (or ``--hw pe8,bw4``) — one command produces the full
modeled-cycles grid, written incrementally to ``--json``. It runs the
simulator alone and touches no device:

    PYTHONPATH=src python -m repro_torch.launch.roofline_sweep \\
        --sam "X(i,j) = B(i,j) * C(i,j)" --sam-dims i=128,j=128 \\
        --sam-density 0.25 --json sam_roofline.json
"""
from __future__ import annotations

import argparse
import time
import traceback

from .dryrun import parse_kv, write_json


def sam_sweep(args) -> list:
    """(format x schedule x hardware) sweep over the SAM cost model;
    returns the records."""
    from ..core.autoschedule import (FORMAT_CHOICES, resolve_densities,
                                     search, synthetic_operands)
    from ..core.einsum import parse
    from ..core.schedule import Format
    from ..core.simulator import HW_PRESETS, simulate_expr

    dims = parse_kv(args.sam_dims)
    fmt = Format(parse_kv(args.sam_formats, cast=str))
    assign = parse(args.sam)
    densities = resolve_densities(assign, args.sam_density)
    arrays = synthetic_operands(assign, dims, densities)
    hw_names = args.hw.split(",") if args.hw else sorted(HW_PRESETS)
    rep = search(assign, fmt, dims, arrays=arrays, device_count=1,
                 top_k=args.top_k, format_choices=FORMAT_CHOICES)
    results = []
    for cand in rep.candidates:
        cfmt = cand.spec.format(fmt)
        for hw in hw_names:
            t0 = time.time()
            res = simulate_expr(assign, cfmt, cand.schedule, arrays, dims,
                                hw=HW_PRESETS[hw])
            results.append({
                "expr": args.sam, "schedule": cand.spec.key(),
                "formats": dict(cand.spec.formats), "hw": hw,
                "cycles": int(res.cycles), "sweep_s": time.time() - t0})
            print(f"[sam-roofline] {cand.spec.key()} x {hw}: "
                  f"{res.cycles} cycles", flush=True)
            write_json(args.json, results)
    print(f"[sam-roofline] wrote {len(results)} cells to {args.json}")
    return results


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default="roofline_baseline.json")
    ap.add_argument("--remat", default="dots")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--sam", default=None,
                    help="SAM einsum: sweep (format x schedule x hardware)")
    ap.add_argument("--sam-dims", default="",
                    help="index extents, e.g. i=128,j=128")
    ap.add_argument("--sam-formats", default="",
                    help="baseline formats, e.g. B=cc,C=cc")
    ap.add_argument("--sam-density", type=float, default=0.1)
    ap.add_argument("--hw", default=None,
                    help="comma-joined simulator.HW_PRESETS names (default all)")
    ap.add_argument("--top-k", type=int, default=8)
    args = ap.parse_args(argv)

    if args.sam:
        return sam_sweep(args)

    from ..configs import SHAPES, get_config, list_archs, supports_shape
    from ..roofline.probe import probe_cell

    results = []
    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    for arch in archs:
        cfg = get_config(arch)
        for shape in shapes:
            if not supports_shape(cfg, shape):
                results.append({"arch": arch, "shape": shape,
                                "skipped": True})
                continue
            t0 = time.time()
            try:
                r = probe_cell(arch, shape, remat=args.remat)
                r["probe_s"] = time.time() - t0
                results.append(r)
                print(f"[roofline] {arch} x {shape}: "
                      f"comp={r['t_compute']:.3e} mem={r['t_memory']:.3e} "
                      f"coll=none "
                      f"bneck={r['bottleneck']} frac={r['roofline_fraction']:.3f} "
                      f"useful={r['useful_flop_ratio']:.2f} "
                      f"flops/dev={r['flops_per_device']:.6e} "
                      f"({r['probe_s']:.0f}s)", flush=True)
            except Exception as e:  # noqa: BLE001
                traceback.print_exc()
                results.append({"arch": arch, "shape": shape,
                                "error": str(e)})
            write_json(args.json, results)
    print(f"[roofline] wrote {len(results)} records to {args.json}")
    return results


if __name__ == "__main__":
    main()
