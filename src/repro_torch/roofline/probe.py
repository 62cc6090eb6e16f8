"""Depth-extrapolated roofline via layer-count probes.

A port of ``repro.roofline.probe``. In the reference, XLA's
``cost_analysis`` holds a ``while`` body once whatever its trip count, so
each cell is re-lowered at small unrolled layer counts and the full
depth's terms are extrapolated from the probes. The port's dry-run runs
the step eagerly on meta tensors, so its direct count at full depth is
already whole; the probes stay as the reference's method and as a check
that every per-layer cost is linear in the depth (the probes' extrapolation
must equal the direct count). Each cell is counted at small layer counts,
the per-layer-type cost vector is solved from the probe differences, and
the full-architecture terms are extrapolated with the real layer counts:

    dense/vlm/audio : probes L=1,2            total = base + L*c_layer
    moe             : (d,m)=(1,1),(2,1),(1,2) total = base + d*c_d + m*c_m
    ssm (xlstm)     : (m,s)=(1,0),(2,0),(1,1) total = base + m*c_m + s*c_s
    hybrid (zamba2) : groups g=1,2            total = base + g*c_group

Batch-size/sequence terms are untouched (probes keep the full shape).
The rates are the H100's (``analysis.H100_BF16_FLOPS``,
``analysis.H100_HBM_BW``). ``collective_bytes_per_device`` is
extrapolated like the FLOPs (every layer issues the same collectives),
and so is ``t_collective`` (each collective's seconds at its group's
link rate, ``analysis.NVLINK_BW`` or ``analysis.NIC_BW``); both are None
where a probe could not be placed.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from ..configs.base import ModelConfig, SHAPES
from .analysis import H100_BF16_FLOPS, H100_HBM_BW, analyze_cell, model_flops

__all__ = ["probe_configs", "layer_counts", "METRICS",
           "solve_and_extrapolate", "probe_cell"]


def probe_configs(cfg: ModelConfig) -> List[Tuple[Dict, ModelConfig]]:
    """[(layer-count dict, probe config)] for this family."""
    rep = lambda **kw: dataclasses.replace(cfg, unroll_scan=True, **kw)
    if cfg.family in ("dense", "vlm", "audio"):
        return [({"layer": n}, rep(n_layers=n)) for n in (1, 2)]
    if cfg.family == "moe":
        return [({"dense": d, "moe": m},
                 rep(n_layers=d + m, first_dense_layers=d))
                for d, m in ((1, 1), (2, 1), (1, 2))]
    if cfg.family == "ssm":
        return [({"mlstm": m, "slstm": s},
                 rep(n_layers=m + s,
                     slstm_layers=tuple(range(m, m + s))))
                for m, s in ((1, 0), (2, 0), (1, 1))]
    if cfg.family == "hybrid":
        return [({"group": g}, rep(n_layers=cfg.attn_every * g))
                for g in (1, 2)]
    raise ValueError(cfg.family)


def layer_counts(cfg: ModelConfig) -> Dict[str, int]:
    if cfg.family in ("dense", "vlm", "audio"):
        return {"layer": cfg.n_layers}
    if cfg.family == "moe":
        return {"dense": cfg.first_dense_layers,
                "moe": cfg.n_layers - cfg.first_dense_layers}
    if cfg.family == "ssm":
        s = len(cfg.slstm_layers)
        return {"mlstm": cfg.n_layers - s, "slstm": s}
    if cfg.family == "hybrid":
        return {"group": cfg.n_layers // cfg.attn_every}
    raise ValueError(cfg.family)


METRICS = ("flops_per_device", "bytes_per_device",
           "collective_bytes_per_device")


def solve_and_extrapolate(probes: List[Tuple[Dict, Dict]],
                          full_counts: Dict[str, int]) -> Dict[str, float]:
    """Solve base + per-layer-type costs from probe rooflines, extrapolate.

    ``probes``: [(layer-count dict, roofline record)]. The probe set is
    constructed so differences isolate one variable at a time.
    """
    keys = sorted({k for c, _ in probes for k in c})
    out = {}
    for metric in METRICS + ("t_collective",):
        if any(r.get(metric) is None for _, r in probes):
            out[metric] = None
        else:
            out.update(_extrapolate(probes, full_counts, keys, metric))
    out["t_compute"] = out["flops_per_device"] / H100_BF16_FLOPS
    out["t_memory"] = out["bytes_per_device"] / H100_HBM_BW
    terms = {"compute": out["t_compute"], "memory": out["t_memory"]}
    if out["t_collective"] is not None:
        terms["collective"] = out["t_collective"]
    out["bottleneck"] = max(terms, key=terms.get)
    t_step = max(terms.values())
    out["t_step_bound"] = t_step
    out["roofline_fraction"] = out["t_compute"] / t_step if t_step else 0.0
    return out


def _extrapolate(probes, full_counts, keys, metric) -> Dict[str, float]:
    """``metric`` at the full layer counts, its base and its cost a layer
    of each type, from the probe differences."""
    base_counts, base_r = probes[0]
    per = {}
    for c, r in probes[1:]:
        # which single key differs from the base probe?
        diff = [k for k in keys if c.get(k, 0) != base_counts.get(k, 0)]
        assert len(diff) == 1, (c, base_counts)
        k = diff[0]
        per[k] = ((r[metric] - base_r[metric])
                  / (c[k] - base_counts[k]))
    base = base_r[metric] - sum(
        per.get(k, 0.0) * base_counts.get(k, 0) for k in keys)
    total = base + sum(per.get(k, 0.0) * full_counts.get(k, 0)
                       for k in keys)
    out = {metric: max(total, 0.0), f"{metric}/base": base}
    for k in keys:
        out[f"{metric}/per_{k}"] = per.get(k, 0.0)
    return out


def probe_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               remat: str = "dots", n_micro: int = 1, mesh=None,
               cfg_override=None, collectives: bool = True) -> Dict:
    """Probe-extrapolated roofline for one (arch x shape) cell;
    ``cfg_override`` probes another configuration (a reduced one) under
    ``arch``'s name; without ``collectives`` the probes are not placed
    and the collective term is None."""
    from ..configs import get_config
    from ..launch import dryrun

    cfg = cfg_override or get_config(arch)
    shape = SHAPES[shape_name]
    records = []
    for counts, pcfg in probe_configs(cfg):
        cost, meta = dryrun.lower_cell(
            arch, shape_name, multi_pod=multi_pod, remat=remat,
            n_micro=n_micro, mesh=mesh, cfg_override=pcfg,
            collectives=collectives)
        records.append((counts, analyze_cell(cost, meta)))
    out = solve_and_extrapolate(records, layer_counts(cfg))
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    mf = model_flops(cfg.n_active_params(), tokens, shape.kind)
    n_dev = int(meta["n_devices"])
    out["model_flops_global"] = mf
    out["flops_global"] = out["flops_per_device"] * n_dev
    out["useful_flop_ratio"] = (mf / out["flops_global"]
                                if out["flops_global"] else 0.0)
    out["arch"] = arch
    out["shape"] = shape_name
    out["multi_pod"] = multi_pod
    out["remat"] = remat
    return out
