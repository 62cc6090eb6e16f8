#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Usage (from the repository root, on a machine with a CUDA GPU and nvcc):

    python3 chip_smoke.py

Drives the port's paths end to end on the card: expressions
(``repro_torch.core.torch_backend.compile_expr`` -> ``CompiledExpr``,
``TiledExpr`` under a memory budget, or ``BsrEngine``; ``schedule="auto"``
through the autoscheduler) and fused programs (``compile_program`` ->
``CompiledProgram``), and checks every result against a float64
numpy/scipy oracle. Operands are integer valued
(1-8) from a fixed numpy seed, so every float32 partial sum is an exact
integer and results must EQUAL the oracle whatever order the atomics take.

Phases:
  (a) build the CUDA kernels from ``src/repro_torch/kernels/csrc``;
  (b) the 14 Table-1 expressions at i=6, j=5, k=4, l=3, plus the
      multi-fiber locate case;
  (c) SpMV  x(i) = B(i,j) * c(j), B cc 16384 x 16384 (~1.07M nonzeros);
  (d) Gustavson SpMSpM X(i,j) = B(i,k) * C(k,j), order ikj, 4096^3 at
      0.5% density each (key bound above the dense-workspace limit, so the
      sort-merge runs with segment_reduce as its inner sum);
      then the same loop at 1024^3 and 1% density, whose 2**20-key result
      keeps the collapse on scatter_workspace in mul_pair mode;
  (e) Plus3 X(i,j) = B + C + D, 1024 x 1024 at 5% density each;
  (m) (d)'s product with split {i: 4} and parallelize {i: 4}: four lanes
      run one after another and merge in one keyed reduce (segment_reduce,
      the key space being 4096^2); the result must equal (d)'s bit for bit;
  (n) a batch of 16 SpMSpM 1024 at 1% (d2's shape, a seed a member)
      through execute_batch on one plan: each member must equal its own
      single call and the oracle, and scatter_workspace must run in
      mul_pair mode;
  (o) out-of-core SpMM X(i,j) = B(i,k) * C(k,j), B cc 16384 x 16384 at
      0.2%, C dd 16384 x 1024, order ikj, under mem_budget="4GB" with the
      density hint {B: 0.002, C: 1}: auto_tile=False must refuse with the
      untiled estimate 16,282,246,691 bytes; the tiled call must be a
      TiledExpr of 4 tiles ({i: 2, k: 2}, 4,104,153,287 estimated bytes a
      tile), each run in L pieces (lanes over i; L and the per-piece
      capacity are printed), equal to the oracle, record 1 plan miss and 3
      hits, then 4 hits warm, one lane dispatch a tile, free every tile's
      tensors, launch segment_reduce, and peak
      (torch.cuda.max_memory_allocated) within the budget on the first
      and on the warm call; the host stages are timed under cProfile;
  (p) schedule="auto": (d)'s product resolved through the autoscheduler
      (sparsity 0.005, one device, a schedule cache in a temporary
      directory), run through compile_expr and equal to (d)'s oracle; a
      second resolve must be a cache hit; then (o) with "auto" under its
      budget: a tiled pick whose tiles fit, equal to (o)'s oracle;
  (g)-(j) the block-sparse (b-format) path at the full widths of
      llama3.2-3b-bsr (d_model 3072, d_ff 8192, 24 heads of 128, window
      4096 = 32 blocks of 128), through compile_expr -> BsrEngine:
  (g) SpMM x(i,k) = B(i,j) * C(j,k): B = W1^T 8192 x 3072 with 25% of its
      128-blocks kept, C = X^T 3072 x 4096 tokens (spmm_bsr);
  (h) SDDMM X(i,j) = M(i,j) * A(i,k) * C(j,k): M the 8192 x 8192 causal
      sliding-window block mask, A = Q and C = K 8192 x 128 (sddmm_bsr);
      (g) and (h) hold integers |v| <= 3, so they must EQUAL the oracle;
  (i) attention O(i,d) = M(i,j) * Q(i,e) * K(j,e) * V(j,d), one head,
      S = 8192, E = D = 128, the mask of (h), standard normal data
      (bsr_attention), within ATTN_TOL of a float64 oracle;
  (j) bsr_flash_attention called directly on all 24 heads, with
      kv_idx = sliding_window_kv_idx(64, 64, 32), causal off and on;
  (k) the fused program of graph attention at ogbn-arxiv's widths (128
      features; 16384 nodes, 14 edges a row drawn uniformly), through
      compile_program -> CompiledProgram:
        T(i,j) = B(i,j) * C(i,f) * D(j,f)   (SDDMM: scores on the edges)
        A(i,g) = T(i,j) * E(j,g)            (SpMM: aggregate neighbours)
      B and T cc, C, D, E and A dd; T fuses, so its COO result becomes
      on-device (seg, crd) levels through coo_to_levels; integers |v| <= 3,
      so A must EQUAL a sparse float64 oracle;
  (k2) the same program with fuse=False: T is materialized on the host
      between two CompiledExpr units; A must equal (k)'s bit for bit;
  (l) coo_to_levels called directly on a 3-level COO, dims
      [4096, 2**25, 8], 2**24 unique sorted keys plus 1024 pad rows, at the
      engine's bucketed capacities and with every capacity half the
      level's count (overflow), and on an empty and a one-row input;
  (l2) the same at extents that are not powers of two, dims
      [4099, 33554393, 7] (the kernel's multiply-shift quotients);
  (f) every kernel against its plain PyTorch version at the shapes (c)-(k)
      gave it, and fused_imr through the intersect_mul_reduce entry on
      sorted streams with NA = 4M, NB = 1M, num_slots = 2**20. The
      block-sparse kernels are also held on a fully masked q block (zeros)
      and in bfloat16; coo_to_levels also at (l)'s shape. sddmm_bsr is also
      held on standard-normal float32 at (h)'s shape, and spmm_bsr at
      (g)'s, each element within the worst case of 3xTF32 against
      float64; spmm_bsr and bsr_attention are timed in bfloat16 at (g) and
      (j); the CUDA-core kernels that the tensor-core route replaced at
      (g), (h) and (j) are timed in turns with it (new, old, old, new); and
      coo_to_levels is timed at (k), (l) and (l2). segment_reduce is held
      and timed at the general entry's calls of (c), (e) and (k) (one
      column), its [a*b, 1] mode's calls of (d), (m) and (o) (a lane of a
      tile), and the general entry at the two shapes PR 17 timed it at,
      rebuilt from (o)'s first tile and (d)'s product streams (2^28 rows
      into 2^23 segments, 4,194,304 into 2^24), with scatter_workspace on
      the same inputs beside them. fused_imr's bound counts a's value and
      output key and b's value only at the hits, and the reduce kernels'
      bounds the values of the rows whose id is in range only, in 32-byte
      sectors.

Launch counters are zeroed before (b) and read after (e): scatter_workspace
and segment_reduce must have launched there. They are zeroed again before
(m), (n), (o) and (p) and read after each: segment_reduce must have
launched in (m) and (o) and scatter_workspace in (n) (the two reduce
kernels' launches in the kernels line are those of (b)-(e) and (m)-(p)). They are zeroed again
before each of (g)-(j) and read after it: its kernel must have launched there,
(g)-(i) must report block size 128 and no fallback call, and spmm_bsr,
sddmm_bsr and bsr_attention must have launched only their tensor-core
kernels (the launches by route are printed). They are zeroed
before (k), (k2), (l) and (l2) too: coo_to_levels and a reduce kernel must have
launched in (k), and no call of (k) may regrow its recorded capacities.
fused_imr's counter is zeroed before its own entry call in (f) and read
after it. Any mismatch or error exits non-zero. The last lines printed are
the ``kernels`` JSON line (with ``bound_ms`` under the rule at
``PRODUCT_OPS_PER_S`` and ``fp32_bound_ms`` beside it), the card's name
and power limit from nvidia-smi, and the ``ok`` JSON line.
"""
from __future__ import annotations

import json
import pathlib
import re
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 20260
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory bandwidth (data sheet)
FP32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
TF32_OPS_PER_S = 495e12       # H100 SXM dense TF32 on the tensor cores
BF16_OPS_PER_S = 989e12       # H100 SXM dense bf16 on the tensor cores
# A kernel's bound is max(bytes / HBM rate, operations / rate): for a
# matrix product on float32 data the rate is three TF32 passes (3xTF32
# keeps the float32 tolerances below; one pass does not), for bfloat16 data
# the bf16 rate, and for anything else the FP32 rate. fp32_bound_ms keeps
# the earlier rule (every operation at the FP32 rate) beside it.
PRODUCT_OPS_PER_S = {"float32": TF32_OPS_PER_S / 3,
                     "bfloat16": BF16_OPS_PER_S}
# (i) against its float64 oracle: float32 scores and float32 sums over up
# to 4096 keys a row leave errors near 1e-6; 1e-4 leaves room for that
ATTN_TOL = 1e-4
# a block-sparse kernel against its plain version on the same inputs:
# float32 differs only in summation order (the tolerance of the
# reference's own kernel tests); bfloat16 also rounds the output once
KERNEL_TOL = {"float32": 2e-5, "bfloat16": 1e-2}

TABLE1 = [
    ("SpMV", "x(i) = B(i,j) * c(j)", "ij", {"B": "cc", "c": "c"}),
    ("SpMSpM_lc", "X(i,j) = B(i,k) * C(k,j)", "ikj", {"B": "cc", "C": "cc"}),
    ("SpMSpM_ip", "X(i,j) = B(i,k) * C(k,j)", "ijk", {"B": "cc", "C": "cc"}),
    ("SpMSpM_op", "X(i,j) = B(i,k) * C(k,j)", "kij", {"B": "cc", "C": "cc"}),
    ("SDDMM", "X(i,j) = B(i,j) * C(i,k) * D(j,k)", "ijk",
     {"B": "cc", "C": "cc", "D": "cc"}),
    ("InnerProd", "x = B(i,j,k) * C(i,j,k)", "ijk", {"B": "ccc", "C": "ccc"}),
    ("TTV", "X(i,j) = B(i,j,k) * c(k)", "ijk", {"B": "ccc", "c": "c"}),
    ("TTM", "X(i,j,k) = B(i,j,l) * C(k,l)", "ijkl", {"B": "ccc", "C": "cc"}),
    ("MTTKRP", "X(i,j) = B(i,k,l) * C(j,k) * D(j,l)", "ijkl",
     {"B": "ccc", "C": "cc", "D": "cc"}),
    ("Residual", "x(i) = b(i) - C(i,j) * d(j)", "ij",
     {"b": "c", "C": "cc", "d": "c"}),
    ("MatTransMul", "x(i) = alpha * Bt(i,j) * c(j) + beta * d(i)", "ij",
     {"Bt": "cc", "c": "c", "d": "c", "alpha": "", "beta": ""}),
    ("MMAdd", "X(i,j) = B(i,j) + C(i,j)", "ij", {"B": "cc", "C": "cc"}),
    ("Plus3", "X(i,j) = B(i,j) + C(i,j) + D(i,j)", "ij",
     {"B": "cc", "C": "cc", "D": "cc"}),
    ("Plus2", "X(i,j,k) = B(i,j,k) + C(i,j,k)", "ijk",
     {"B": "ccc", "C": "ccc"}),
]
TABLE1_DIMS = {"i": 6, "j": 5, "k": 4, "l": 3}
KERNEL_META = {
    "scatter_workspace": (
        "src/repro_torch/kernels/csrc/scatter_workspace.cu",
        "src/repro/kernels/scatter_workspace.py:87"),
    "segment_reduce": (
        "src/repro_torch/kernels/csrc/segment_reduce.cu",
        "src/repro/kernels/segment_reduce.py:67"),
    "fused_imr": (
        "src/repro_torch/kernels/csrc/fused_stream.cu",
        "src/repro/kernels/fused_stream.py:98"),
    "spmm_bsr": (
        "src/repro_torch/kernels/csrc/spmm_bsr.cu",
        "src/repro/kernels/spmm_bsr.py:71"),
    "sddmm_bsr": (
        "src/repro_torch/kernels/csrc/sddmm_bsr.cu",
        "src/repro/kernels/sddmm_bsr.py:61"),
    "bsr_attention": (
        "src/repro_torch/kernels/csrc/bsr_attention.cu",
        "src/repro/kernels/bsr_attention.py:108"),
    "coo_to_levels": (
        "src/repro_torch/kernels/csrc/coo_levels.cu",
        "src/repro/kernels/coo_levels.py:33"),
}
# (k): graph attention as a fused SDDMM -> SpMM program (GAT-style)
GAT = "T(i,j) = B(i,j) * C(i,f) * D(j,f); A(i,g) = T(i,j) * E(j,g)"
GAT_FMT = {"B": "cc", "T": "cc", "C": "dd", "D": "dd", "E": "dd", "A": "dd"}
GAT_ORDER = {"T": ("i", "j", "f"), "A": ("i", "j", "g")}


def log(*parts):
    print(*parts, flush=True)


def sparse_int(rng, shape, density):
    """Dense float64 array with ~density nonzeros, values in 1..8."""
    n = int(np.prod(shape))
    flat = np.unique(rng.integers(0, n, int(n * density)))
    arr = np.zeros(n)
    arr[flat] = rng.integers(1, 9, flat.size)
    return arr.reshape(shape)


def tree_to_dense(ft) -> np.ndarray:
    """Vectorized dense expansion of a d/c FiberTree (original axes)."""
    if ft.order == 0:
        return np.asarray(ft.vals[0])
    coords = np.zeros((1, 0), dtype=np.int64)
    for lv in ft.levels:
        if lv.format == "dense":
            c = np.arange(lv.dim)
            coords = np.concatenate(
                [np.repeat(coords, lv.dim, axis=0),
                 np.tile(c, len(coords))[:, None]], axis=1)
        else:
            counts = np.diff(np.asarray(lv.seg))[:len(coords)]
            coords = np.concatenate(
                [np.repeat(coords, counts, axis=0),
                 np.asarray(lv.crd)[:, None]], axis=1)
    out = np.zeros(ft.shape)
    out[tuple(coords.T)] = ft.vals
    return np.transpose(out, np.argsort(ft.mode_order))


def check_equal(name, got, want):
    if got.shape != want.shape or not np.array_equal(got, want):
        bad = (np.abs(got - want).max() if got.shape == want.shape
               else f"shape {got.shape} != {want.shape}")
        raise AssertionError(f"{name}: result differs from oracle ({bad})")


def check_close(name, got, want, tol):
    err = (np.abs(got - want).max() if got.shape == want.shape and got.size
           else 0.0)
    if got.shape != want.shape or not np.isfinite(got).all() or err > tol:
        raise AssertionError(f"{name}: result differs from oracle (max abs "
                             f"err {err}, tolerance {tol})")
    log(f"  {name}: max abs err {err:.3e} against the float64 oracle "
        f"(tolerance {tol})")


def attention_oracle(q, k, v, allow):
    """float64 block-masked softmax attention (no fully masked rows)."""
    sc = (q.astype(np.float64) @ k.astype(np.float64).T) / np.sqrt(q.shape[1])
    sc = np.where(allow, sc, -np.inf)
    p = np.exp(sc - sc.max(1, keepdims=True))
    return (p / p.sum(1, keepdims=True)) @ v.astype(np.float64)


def attention_pairs(kv_idx, bq, bkv, n_kvblk, causal):
    """Allowed (query, key) pairs of one head under ``kv_idx``."""
    pairs = 0
    r = np.arange(bq)[:, None]
    c = np.arange(bkv)[None, :]
    for qi, row in enumerate(kv_idx):
        for kb in row:
            if 0 <= kb < n_kvblk:
                pairs += (int((qi * bq + r >= kb * bkv + c).sum()) if causal
                          else bq * bkv)
    return pairs


def oracle(expr, arrays):
    """numpy einsum evaluation of a sum-of-products assignment."""
    from repro_torch.core.einsum import parse

    assign = parse(expr)
    out_subs = "".join(assign.lhs.vars)
    total = None
    for t in assign.terms:
        spec = ",".join("".join(f.vars) for f in t.factors)
        val = np.einsum(spec + "->" + out_subs,
                        *[arrays[f.tensor] for f in t.factors])
        total = t.sign * val if total is None else total + t.sign * val
    return total


def warm_ms(fn, reps=5):
    """Median host-clock ms over ``reps`` calls after one warm-up (each
    call ends in a device-to-host copy of the result, which synchronizes)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def event_ms(fn, reps=20):
    """Device time per call from CUDA events around ``reps`` calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profiler_warmup():
    """Launch a few spin kernels inside a fresh profile before the work it
    measures: the profiler may miss the first device activities of a
    session (call 3, PR 12, recorded no kernel of one profiled call).
    Their events carry the name ``spin_kernel`` and are left out."""
    import torch

    for _ in range(8):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()


def profiled_device_ms(fn, match, reps=20, per_call=1):
    """Per-call device time of ``fn`` from torch.profiler's kernel events:
    (all kernels, the kernels whose name contains ``match``), or
    (None, None) when the profiler recorded no such kernel. Sums are
    divided by the number of calls the profiler recorded (``match``
    kernels over the ``per_call`` of them one call launches), not by
    ``reps``: it does not always record every launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiler_warmup()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = mine = 0.0
    recorded = 0
    split = {}
    for evt in prof.key_averages():
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or "spin_kernel" in evt.key):
            continue
        total += evt.self_device_time_total
        if match in evt.key:
            mine += evt.self_device_time_total
            recorded += evt.count
            name = re.search(rf"\w*{match}\w*", evt.key).group(0)
            split[name] = split.get(name, 0.0) + evt.self_device_time_total
    if not recorded:
        return None, None
    if recorded != reps * per_call:
        log(f"  profiler recorded {recorded} of {reps * per_call} {match} "
            f"launches")
    calls = recorded / per_call
    if per_call > 1:     # a wrapper of several kernels: each one's share
        log("  per call: " + ", ".join(
            f"{k} {v / calls / 1e3:.4f} ms" for k, v in sorted(split.items())))
    return total / calls / 1e3, mine / calls / 1e3


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import coord_ops as co
    from repro_torch.core import tiling
    from repro_torch.core.schedule import Format, Schedule
    from repro_torch.core.torch_backend import (CompiledExpr, TiledExpr,
                                                _bucket_cap,
                                                clear_compile_cache,
                                                clear_program_cache,
                                                compile_expr, compile_program)
    from repro_torch.kernels import _build
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.fused_stream import (fused_imr_workspace,
                                                  fused_imr_workspace_plain)
    from repro_torch.kernels.scatter_workspace import scatter_workspace_plain
    from repro_torch.kernels.segment_reduce import (
        segment_reduce_mul, segment_reduce_mul_plain, segment_reduce_plain)
    from repro_torch.kernels.bsr_attention import (bsr_flash_attention,
                                                   bsr_flash_attention_plain)
    from repro_torch.kernels.coo_levels import (coo_to_levels,
                                                coo_to_levels_plain)
    from repro_torch.kernels.sddmm_bsr import sddmm_bsr, sddmm_bsr_plain
    from repro_torch.kernels.spmm_bsr import spmm_bsr, spmm_bsr_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # -- (a) build -------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    log(f"[a] kernels built in {time.perf_counter() - t0:.2f} s -> "
        f"{lib_path.name}")
    for src, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[a] {src}: {line.strip()}")
    log(f"[a] {smi}")

    from repro_torch.kernels.scatter_workspace import scatter_workspace
    from repro_torch.kernels.segment_reduce import segment_reduce

    # the tensors the main path hands each kernel wrapper, by phase, so (f)
    # can hold each kernel against its plain version at those shapes
    seen = {}
    wrappers = {scatter_workspace.__code__: "scatter_workspace",
                segment_reduce.__code__: "segment_reduce",
                segment_reduce_mul.__code__: "segment_reduce_mul",
                spmm_bsr.__code__: "spmm_bsr",
                sddmm_bsr.__code__: "sddmm_bsr",
                bsr_flash_attention.__code__: "bsr_attention",
                coo_to_levels.__code__: "coo_to_levels"}

    def record_kernel_inputs(tag, fn):
        """Run ``fn`` once, keeping a copy of the arguments of every call
        to a kernel wrapper (observed with a profile hook: nothing in the
        package is rebound)."""
        def hook(frame, event, arg):
            name = wrappers.get(frame.f_code) if event == "call" else None
            if name is not None:
                seen.setdefault(tag, {}).setdefault(name, []).append({
                    k: v.clone() if torch.is_tensor(v) else v
                    for k, v in frame.f_locals.items()})
        sys.setprofile(hook)
        try:
            fn()
        finally:
            sys.setprofile(None)

    rng = np.random.default_rng(SEED)
    kops.reset_launch_counts()
    per_phase = {}

    # -- (b) Table 1 -------------------------------------------------------
    for name, expr, order, fmts in TABLE1:
        from repro_torch.core.einsum import parse
        arrays = {}
        for t in parse(expr).terms:
            for f in t.factors:
                if f.tensor not in arrays:
                    arrays[f.tensor] = (
                        np.asarray(float(rng.integers(1, 5))) if not f.vars
                        else sparse_int(rng, tuple(TABLE1_DIMS[v]
                                                   for v in f.vars), 0.4))
        eng = compile_expr(expr, Format(dict(fmts)),
                           Schedule(loop_order=tuple(order)), TABLE1_DIMS)
        check_equal(name, tree_to_dense(eng(arrays)), oracle(expr, arrays))
    B = sparse_int(rng, (6, 7), 0.5)
    C = sparse_int(rng, (6, 7), 0.5)
    for cf in ("dd", "dc", "cc"):
        eng = compile_expr(
            "X(i,j) = B(i,j) * C(i,j)", Format({"B": "cc", "C": cf}),
            Schedule(loop_order=("i", "j"), locate=frozenset({("C", "j")})),
            {"i": 6, "j": 7})
        check_equal(f"locate-{cf}", tree_to_dense(eng({"B": B, "C": C})),
                    B * C)
    per_phase["b"] = kops.launch_counts()
    log(f"[b] 14 Table-1 cases + 3 multi-fiber locate cases equal numpy; "
        f"launches {per_phase['b']}")

    workloads = {}

    def host_profile(fn, top=6):
        """Where one warm call spends its host time: the functions of the
        package with the most cumulative time under cProfile (which slows
        Python-heavy stages, so these are shares, not latencies)."""
        import cProfile
        import pstats

        prof = cProfile.Profile()
        prof.runcall(fn)
        rows = []
        for (path, _, func), (_, _, _, cum, _) in pstats.Stats(
                prof).stats.items():
            if "repro_torch" in path and func != "__call__":
                rows.append((cum * 1e3, f"{pathlib.Path(path).stem}.{func}"))
        rows.sort(reverse=True)
        return [{"cum_ms": ms, "name": name} for ms, name in rows[:top]]

    def device_profile(fn):
        """Kernel time on the card during one warm call (torch.profiler)."""
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            profiler_warmup()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        rows = []
        for evt in prof.key_averages():
            # kernel events only: the host ops that launched them report
            # the same device time again
            dev_us = evt.self_device_time_total
            if (evt.device_type == torch.autograd.DeviceType.CUDA and dev_us
                    and "spin_kernel" not in evt.key):
                rows.append((dev_us / 1e3, evt.count, evt.key))
        rows.sort(reverse=True)
        busy = sum(r[0] for r in rows)
        return {"wall_ms": wall, "device_busy_ms": busy,
                "idle_share": (1 - busy / wall) if busy else None,
                "top_kernels": [{"ms": ms, "count": n, "name": k[:80]}
                                for ms, n, k in rows[:8]]}

    def expr_engine(expr, fmts, order, dims):
        return compile_expr(expr, Format(fmts), Schedule(loop_order=order),
                            dims)

    def run_workload(tag, label, eng, arrays, want, check=check_equal,
                     reps=5, result=lambda out: out):
        """Drive one engine on one operand set: first call, warm median,
        recorded kernel inputs, host and device profiles. ``result`` picks
        the checked FiberTree out of what the engine returns; the first
        call's dense result is returned."""
        before = kops.launch_counts()
        t0 = time.perf_counter()
        got = eng(arrays)
        first_ms = (time.perf_counter() - t0) * 1e3
        dense = tree_to_dense(result(got))
        check(label, dense, want)
        ms = warm_ms(lambda: eng(arrays), reps)
        check(label + " (warm)", tree_to_dense(result(eng(arrays))), want)
        record_kernel_inputs(tag, lambda: eng(arrays))
        host = host_profile(lambda: eng(arrays))
        prof = device_profile(lambda: eng(arrays))
        after = kops.launch_counts()
        per_phase[tag] = {k: after[k] - before[k] for k in after}
        workloads[label] = {"first_ms": first_ms, "warm_ms": ms,
                            "result_nnz": int(np.count_nonzero(want)),
                            "host_profile": host, "profile": prof,
                            "stats": dict(eng.stats)}
        idle = prof["idle_share"]
        log(f"[{tag}] {label}: first call {first_ms:.1f} ms, warm median "
            f"{ms:.1f} ms over {reps} calls; result nnz "
            f"{workloads[label]['result_nnz']}; launches {per_phase[tag]}")
        log(f"[{tag}] {label}: host (cProfile cumulative ms) " + ", ".join(
            f"{r['name']} {r['cum_ms']:.1f}" for r in host))
        log(f"[{tag}] {label}: profiled call {prof['wall_ms']:.1f} ms with "
            f"{prof['device_busy_ms']:.3f} ms of kernels on the card, idle "
            f"share " + ("not measured" if idle is None else f"{idle:.4f}"))
        for row in prof["top_kernels"][:4]:
            log(f"[{tag}]   {row['ms']:.3f} ms x{row['count']} {row['name']}")
        log(f"[{tag}] engine stats {eng.stats}")
        return dense

    # -- (c) SpMV ------------------------------------------------------------
    import scipy.sparse as sp

    n = 16384
    B = sparse_int(rng, (n, n), 0.004)
    c = rng.integers(1, 9, n).astype(float)
    log(f"[c] B nnz {np.count_nonzero(B)}")
    run_workload("c", "SpMV 16384",
                 expr_engine("x(i) = B(i,j) * c(j)", {"B": "cc", "c": "c"},
                             ("i", "j"), {"i": n, "j": n}),
                 {"B": B, "c": c}, sp.csr_matrix(B) @ c)
    del B

    # -- (d) Gustavson SpMSpM ----------------------------------------------
    n = 4096
    B = sparse_int(rng, (n, n), 0.005)
    C = sparse_int(rng, (n, n), 0.005)
    Bs, Cs = sp.csr_matrix(B), sp.csr_matrix(C)
    products = int(np.diff(Cs.indptr)[Bs.indices].sum())
    log(f"[d] B nnz {Bs.nnz}, C nnz {Cs.nnz}, products {products}")
    spmspm_d = {"B": B, "C": C}           # (m) splits the same product
    want_d = (Bs @ Cs).toarray()
    # (f) rebuilds the product stream PR 17 timed segment_reduce on
    Bo = Bs.tocoo()
    d_csr = {"b": [torch.as_tensor(a, device="cuda") for a in (
                 Bo.row.astype(np.int64), Bo.col.astype(np.int64),
                 Bo.data.astype(np.float32))],
             "c": [torch.as_tensor(a, device="cuda") for a in (
                 Cs.indptr.astype(np.int64), Cs.indices.astype(np.int64),
                 Cs.data.astype(np.float32))]}
    del Bo
    got_d = run_workload("d", "SpMSpM 4096 ikj",
                         expr_engine("X(i,j) = B(i,k) * C(k,j)",
                                     {"B": "cc", "C": "cc"}, ("i", "k", "j"),
                                     {"i": n, "j": n, "k": n}),
                         spmspm_d, want_d)
    del B, C, Bs, Cs

    # the same loop with a result of 1024 x 1024 = 2**20 keys: the collapse
    # stays inside the dense-workspace bound, so mul_reduce runs
    # scatter_workspace in mul_pair mode
    n = 1024
    B = sparse_int(rng, (n, n), 0.01)
    C = sparse_int(rng, (n, n), 0.01)
    run_workload("d2", "SpMSpM 1024 ikj",
                 expr_engine("X(i,j) = B(i,k) * C(k,j)",
                             {"B": "cc", "C": "cc"}, ("i", "k", "j"),
                             {"i": n, "j": n, "k": n}),
                 {"B": B, "C": C},
                 (sp.csr_matrix(B) @ sp.csr_matrix(C)).toarray())
    del B, C

    # -- (e) Plus3 -------------------------------------------------------------
    n = 1024
    arrays = {t: sparse_int(rng, (n, n), 0.05) for t in "BCD"}
    run_workload("e", "Plus3 1024",
                 expr_engine("X(i,j) = B(i,j) + C(i,j) + D(i,j)",
                             {"B": "cc", "C": "cc", "D": "cc"}, ("i", "j"),
                             {"i": n, "j": n}),
                 arrays, arrays["B"] + arrays["C"] + arrays["D"])

    main_counts = kops.launch_counts()
    log(f"[b-e] launches on the main path: {main_counts}")
    for name in ("scatter_workspace", "segment_reduce"):
        for tag in ("c", "d", "d2", "e"):
            if name in seen.get(tag, {}) and per_phase[tag][name] == 0:
                raise AssertionError(f"{name} was called in ({tag}) but "
                                     f"never launched")
        if not any(per_phase[t][name] for t in ("c", "d", "d2", "e")):
            raise AssertionError(f"{name} never launched in (c)-(e)")

    # -- (m) (d)'s product, split and parallelized over 4 lanes --------------
    n = 4096
    kops.reset_launch_counts()
    got_m = run_workload(
        "m", "SpMSpM 4096 lanes",
        compile_expr("X(i,j) = B(i,k) * C(k,j)",
                     Format({"B": "cc", "C": "cc"}),
                     Schedule(loop_order=("i", "k", "j"), split={"i": 4},
                              parallelize={"i": 4}),
                     {"i": n, "j": n, "k": n}),
        spmspm_d, want_d)
    lanes_m = workloads["SpMSpM 4096 lanes"]
    if (not np.array_equal(got_m, got_d)
            or per_phase["m"]["segment_reduce"] < 1
            or lanes_m["stats"]["lane_dispatches"] < 1):
        raise AssertionError(f"(m) differs from (d) or launched "
                             f"{per_phase['m']} with stats "
                             f"{lanes_m['stats']}")
    log(f"[m] equals (d) bit for bit; warm {lanes_m['warm_ms']:.3f} ms "
        f"against (d)'s {workloads['SpMSpM 4096 ikj']['warm_ms']:.3f} "
        f"({lanes_m['warm_ms'] / workloads['SpMSpM 4096 ikj']['warm_ms']:.3f}"
        f"x); lane_dispatches {lanes_m['stats']['lane_dispatches']}")
    del got_d, got_m                  # (p) runs (d)'s operands again

    # -- (n) a batch of 16 SpMSpM 1024, one seed a member ---------------------
    n, members = 1024, 16
    batch, wants = [], []
    for m in range(members):
        rm = np.random.default_rng(SEED + 1 + m)
        Bm, Cm = sparse_int(rm, (n, n), 0.01), sparse_int(rm, (n, n), 0.01)
        batch.append({"B": Bm, "C": Cm})
        wants.append((sp.csr_matrix(Bm) @ sp.csr_matrix(Cm)).toarray())
    dims_n = {"i": n, "j": n, "k": n}
    beng = CompiledExpr("X(i,j) = B(i,k) * C(k,j)",
                        Format({"B": "cc", "C": "cc"}),
                        Schedule(loop_order=("i", "k", "j")), dims_n)
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    outs = beng.execute_batch(batch)
    first_n = (time.perf_counter() - t0) * 1e3
    if beng.stats["plan_misses"] != 1:
        raise AssertionError(f"(n) warm-up batch stats {beng.stats}")
    batch_ms = warm_ms(lambda: beng.execute_batch(batch), reps=3)
    record_kernel_inputs("n", lambda: beng.execute_batch(batch))
    prof_n = device_profile(lambda: beng.execute_batch(batch))
    per_phase["n"] = kops.launch_counts()
    single = expr_engine("X(i,j) = B(i,k) * C(k,j)", {"B": "cc", "C": "cc"},
                         ("i", "k", "j"), dims_n)        # (d2)'s engine
    for m, (out, arrays, want) in enumerate(zip(
            beng.execute_batch(batch), batch, wants)):
        dense = tree_to_dense(out)
        check_equal(f"(n) member {m}", dense, want)
        check_equal(f"(n) member {m} against its single call",
                    dense, tree_to_dense(single(arrays)))
    mul_pair = [kw["mul_pair"] for kw in
                seen.get("n", {}).get("scatter_workspace", [])]
    if (beng.stats["plan_misses"] != 1 or not any(mul_pair)
            or per_phase["n"]["scatter_workspace"] < 1):
        raise AssertionError(f"(n) stats {beng.stats}, launches "
                             f"{per_phase['n']}, mul_pair calls {mul_pair}")
    d2_ms = workloads["SpMSpM 1024 ikj"]["warm_ms"]
    workloads["SpMSpM 1024 batch of 16"] = {
        "first_ms": first_n, "warm_ms": batch_ms,
        "member_warm_ms": batch_ms / members, "profile": prof_n,
        "stats": dict(beng.stats),
        "result_nnz": [int(np.count_nonzero(w)) for w in wants]}
    idle = prof_n["idle_share"]
    log(f"[n] {members} members equal their single calls and the oracle on "
        f"one plan; first batch {first_n:.1f} ms, warm batch {batch_ms:.1f} "
        f"ms = {batch_ms / members:.3f} ms a member against (d2)'s single "
        f"warm {d2_ms:.3f} ({batch_ms / members / d2_ms:.3f}x); launches "
        f"{per_phase['n']}")
    log(f"[n] profiled batch {prof_n['wall_ms']:.1f} ms with "
        f"{prof_n['device_busy_ms']:.3f} ms of kernels on the card, idle "
        f"share " + ("not measured" if idle is None else f"{idle:.4f}"))
    for row in prof_n["top_kernels"][:4]:
        log(f"[n]   {row['ms']:.3f} ms x{row['count']} {row['name']}")
    log(f"[n] engine stats {beng.stats}")
    del batch, wants, outs

    # -- (o) out-of-core SpMM under a memory budget -------------------------
    # the repo's own out-of-core case (benchmarks/tiled_oob.py): B 16384^2 at
    # 0.2% (about 33 a row), C 16384 x 1024 dense, under a 4 GB budget
    n, nj = 16384, 1024
    o_expr, o_fmt = "X(i,j) = B(i,k) * C(k,j)", Format({"B": "cc", "C": "dd"})
    o_sch = Schedule(loop_order=("i", "k", "j"))
    o_dims, o_dens = {"i": n, "j": nj, "k": n}, {"B": 0.002, "C": 1.0}
    o_budget = tiling.parse_budget("4GB")
    o_arrays = {"B": sparse_int(rng, (n, n), 0.002),
                "C": rng.integers(1, 9, (n, nj)).astype(float)}
    want_o = sp.csr_matrix(o_arrays["B"]) @ o_arrays["C"]
    log(f"[o] B nnz {np.count_nonzero(o_arrays['B'])}, C {n} x {nj} dense; "
        f"result nnz {np.count_nonzero(want_o)}")
    try:
        compile_expr(o_expr, o_fmt, o_sch, o_dims, mem_budget="4GB",
                     sparsity=o_dens, auto_tile=False)
        raise AssertionError("(o) the untiled call was not refused")
    except tiling.MemoryBudgetExceeded as exc:
        o_untiled = exc.estimate
    if o_untiled != 16282246691:
        raise AssertionError(f"(o) untiled estimate {o_untiled}")
    teng = compile_expr(o_expr, o_fmt, o_sch, o_dims, mem_budget="4GB",
                        sparsity=o_dens)
    if not isinstance(teng, TiledExpr) or teng.n_tiles != 4:
        raise AssertionError(f"(o) engine {type(teng).__name__}")
    log(f"[o] refused untiled at {o_untiled} bytes; tiled {teng.tile_of}, "
        f"{teng.n_tiles} tiles of {teng.tile_bytes} estimated bytes")
    if (teng.tile_of != {"i": 2, "k": 2} or teng.tile_bytes != 4104153287
            or teng.pieces < 2 or teng.engine.par_n != teng.pieces):
        raise AssertionError(f"(o) plan {teng.tile_of}, {teng.tile_bytes} "
                             f"bytes a tile, {teng.pieces} pieces")

    def peak_call(label):
        """One tiled call: host ms, peak allocated bytes over it, and the
        per-tile engine's plan misses and hits and lane dispatches (one a
        tile run in pieces) it added."""
        st0 = dict(teng.engine.stats)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = teng(o_arrays)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated()
        check_equal(f"(o) {label}", tree_to_dense(out), want_o)
        after = torch.cuda.memory_allocated()
        if after != base:
            raise AssertionError(f"(o) {label}: {after - base} bytes "
                                 f"outlive the call")
        return ms, peak, {k: teng.engine.stats[k] - st0[k]
                          for k in ("plan_misses", "plan_hits",
                                    "lane_dispatches")}

    kops.reset_launch_counts()
    first_o, peak_first, st_first = peak_call("first call")
    warm_o, peak_warm, st_warm = peak_call("warm call")
    per_phase["o"] = kops.launch_counts()
    # one plan for the four tiles, each run in pieces: one lane dispatch
    # a tile
    if (st_first != {"plan_misses": 1, "plan_hits": 3, "lane_dispatches": 4}
            or st_warm != {"plan_misses": 0, "plan_hits": 4,
                           "lane_dispatches": 4}
            or per_phase["o"]["segment_reduce"] < 1):
        raise AssertionError(f"(o) plan stats {st_first} then {st_warm}, "
                             f"launches {per_phase['o']}")
    caps_o = next(iter(teng.engine._plans.values())).caps
    piece_cap = max(caps_o.values())
    log(f"[o] each tile in L = {teng.pieces} pieces (lanes over "
        f"{o_sch.loop_order[0]}); per-piece capacity {piece_cap} rows "
        f"(caps {caps_o})")
    log(f"[o] equals the oracle exactly; first call {first_o:.1f} ms, warm "
        f"{warm_o:.1f} ms; plans {st_first} then {st_warm}; launches "
        f"{per_phase['o']}")
    log(f"[o] peak allocated {peak_first} bytes (first call), {peak_warm} "
        f"(warm), {max(peak_first, peak_warm) / piece_cap:.1f} bytes a row "
        f"of the per-piece capacity; tile_bytes {teng.tile_bytes}, budget "
        f"{o_budget}, untiled estimate {o_untiled}")
    if peak_first > o_budget or peak_warm > o_budget:
        raise AssertionError(f"(o) peak {peak_first} (first call), "
                             f"{peak_warm} (warm) above the budget "
                             f"{o_budget}")
    o_peak = max(peak_first, peak_warm)

    # (f) holds segment_reduce at the largest shape the pieces gave it, and
    # rebuilds the first tile's product stream PR 17 timed it on
    record_kernel_inputs("o", lambda: teng(o_arrays))
    seen["o"] = {k: [max(v, key=lambda kw: kw["keys"].numel())]
                 for k, v in seen["o"].items() if k == "segment_reduce_mul"}
    # (C's dense tile as a CSR whose every row holds all nj columns)
    ti, tk = np.nonzero(o_arrays["B"][:n // 2, :n // 2])
    o_tile = {"b": [torch.as_tensor(ti, device="cuda"),
                    torch.as_tensor(tk, device="cuda"),
                    torch.as_tensor(o_arrays["B"][ti, tk], device="cuda",
                                    dtype=torch.float32)],
              "c": [torch.arange(0, n // 2 * nj + 1, nj, device="cuda"),
                    torch.arange(nj, device="cuda").repeat(n // 2),
                    torch.as_tensor(o_arrays["C"][:n // 2], device="cuda",
                                    dtype=torch.float32).reshape(-1)]}
    del ti, tk

    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.runcall(teng, o_arrays)
    stages = {}
    for (path, _, func), (_, _, _, cum, _) in pstats.Stats(
            prof).stats.items():
        if func in ("_measure_hints", "slice_operands", "accumulate_coo",
                    "_finalize", "execute_coo") and "repro_torch" in path:
            stages[func] = stages.get(func, 0.0) + cum * 1e3
    prof_o = device_profile(lambda: teng(o_arrays))
    idle = prof_o["idle_share"]
    workloads["SpMM 16384 x 1024 tiled"] = {
        "first_ms": first_o, "warm_ms": warm_o,
        "result_nnz": int(np.count_nonzero(want_o)), "peak_bytes": o_peak,
        "peak_first_bytes": peak_first, "peak_warm_bytes": peak_warm,
        "tile_bytes": teng.tile_bytes, "budget": o_budget,
        "pieces": teng.pieces, "piece_caps": caps_o,
        "untiled_estimate": o_untiled, "host_stages_ms": stages,
        "profile": prof_o, "stats": dict(teng.stats),
        "engine_stats": dict(teng.engine.stats)}
    log("[o] host (cProfile cumulative ms) " + ", ".join(
        f"{k} {v:.1f}" for k, v in sorted(stages.items(),
                                          key=lambda kv: -kv[1])))
    log(f"[o] profiled call {prof_o['wall_ms']:.1f} ms with "
        f"{prof_o['device_busy_ms']:.3f} ms of kernels on the card, idle "
        f"share " + ("not measured" if idle is None else f"{idle:.4f}"))
    for row in prof_o["top_kernels"][:4]:
        log(f"[o]   {row['ms']:.3f} ms x{row['count']} {row['name']}")

    # -- (p) schedule="auto" ------------------------------------------------
    # (d)'s product searched, then (o)'s under its budget; a cache file of
    # its own in a temporary directory
    import os
    import tempfile

    from repro_torch.core.autoschedule import resolve_schedule

    kops.reset_launch_counts()
    saved_cache = os.environ.get("SAM_SCHEDULE_CACHE")
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["SAM_SCHEDULE_CACHE"] = os.path.join(tmp, "s.json")
        try:
            d_fmt = Format({"B": "cc", "C": "cc"})
            d_dims = {"i": 4096, "j": 4096, "k": 4096}
            # compile_expr searches for one device (lanes run on one card)
            t0 = time.perf_counter()
            res = resolve_schedule(o_expr, d_fmt, d_dims, sparsity=0.005,
                                   device_count=1)
            search_s = time.perf_counter() - t0
            peng = compile_expr(o_expr, d_fmt, "auto", d_dims,
                                sparsity=0.005)
            again = resolve_schedule(o_expr, d_fmt, d_dims, sparsity=0.005,
                                     device_count=1)
            if (res.cache_hit or res.report is None or not again.cache_hit
                    or again.report is not None
                    or peng.schedule != res.schedule
                    or again.schedule != res.schedule):
                raise AssertionError("(p) the pick was not searched once "
                                     "and then served from the cache")
            t0 = time.perf_counter()
            check_equal("(p) SpMSpM 4096 auto", tree_to_dense(peng(spmspm_d)),
                        want_d)
            p_ms = (time.perf_counter() - t0) * 1e3
            p_warm = warm_ms(lambda: peng(spmspm_d), reps=3)
            log(f"[p] SpMSpM 4096 auto: pick {res.report.best.spec.key()} "
                f"(cycles {res.report.best.cycles}); search {search_s:.3f} s, "
                f"enumerated {res.report.enumerated}, simulated "
                f"{res.report.simulated}; the second resolve a cache hit; "
                f"equals (d)'s oracle, first call {p_ms:.1f} ms, warm "
                f"median {p_warm:.1f} ms over 3 calls")
            t0 = time.perf_counter()
            po = compile_expr(o_expr, o_fmt, "auto", o_dims,
                              mem_budget="4GB", sparsity=o_dens)
            po_s = time.perf_counter() - t0
            if (not isinstance(po, TiledExpr) or not po.schedule.tile
                    or po.tile_bytes > o_budget):
                raise AssertionError(f"(p) budgeted pick {po.schedule}")
            t0 = time.perf_counter()
            check_equal("(p) (o) auto", tree_to_dense(po(o_arrays)), want_o)
            log(f"[p] (o) auto under 4GB: pick {po.schedule.loop_order} tile "
                f"{po.schedule.tile} ({po.n_tiles} tiles of "
                f"{po.tile_bytes} estimated bytes, search and build "
                f"{po_s:.3f} s; the engine of (o): {po is teng}); equals "
                f"(o)'s oracle, {(time.perf_counter() - t0) * 1e3:.1f} ms")
        finally:
            if saved_cache is None:
                os.environ.pop("SAM_SCHEDULE_CACHE", None)
            else:
                os.environ["SAM_SCHEDULE_CACHE"] = saved_cache
    per_phase["p"] = kops.launch_counts()
    workloads["SpMSpM 4096 auto"] = {
        "pick": res.report.best.spec.key(), "search_s": search_s,
        "enumerated": res.report.enumerated,
        "simulated": res.report.simulated, "first_ms": p_ms,
        "warm_ms": p_warm}
    log(f"[p] launches {per_phase['p']}")
    del o_arrays, want_o, teng, po, peng, spmspm_d, want_d

    # -- (g)-(j) the block-sparse path at llama3.2-3b-bsr's widths ------------
    # d_model 3072, d_ff 8192, 24 heads of 128, window 4096 tokens
    bs, d_model, d_ff, tokens = 128, 3072, 8192, 4096
    s_len, hd, heads, win = 8192, 128, 24, 32

    per_route = {}

    def check_routes(tag, kernel):
        """The phase's calls of a two-route kernel all took the tensor
        cores (no CUDA-core launch)."""
        per_route[tag] = kops.route_counts()
        got = per_route[tag].get(kernel)
        if got is not None and (got["tensor_cores"] < 1
                                or got["cuda_cores"]):
            raise AssertionError(f"({tag}) {kernel} routes {got}")
        log(f"[{tag}] launches by route {per_route[tag]}")

    def run_bsr(tag, label, kind, kernel, expr, fmts, dims, arrays, want,
                check=check_equal):
        kops.reset_launch_counts()
        run_workload(tag, label, expr_engine(expr, fmts, tuple(dims), dims),
                     arrays, want, check=check, reps=3)
        st = workloads[label]["stats"]
        if (st["kernel"] != kind or st["block_size"] != bs
                or st["fallback_calls"] or per_phase[tag][kernel] < 1):
            raise AssertionError(f"({tag}) {label}: stats {st}, launches "
                                 f"{per_phase[tag]}")
        check_routes(tag, kernel)

    # (g) block-pruned FFN up-projection: W1^T (d_ff x d_model) @ X^T
    nbr, nbc = d_ff // bs, d_model // bs
    keep = np.zeros(nbr * nbc, bool)
    keep[rng.choice(nbr * nbc, nbr * nbc // 4, replace=False)] = True
    w1t = (np.kron(keep.reshape(nbr, nbc), np.ones((bs, bs), np.int8))
           * rng.integers(-3, 4, (d_ff, d_model), dtype=np.int8)
           ).astype(np.float32)
    xt = rng.integers(-3, 4, (d_model, tokens)).astype(np.float32)
    want = w1t.astype(np.float64) @ xt.astype(np.float64)
    log(f"[g] W1^T {d_ff} x {d_model}: {int(keep.sum())} of {keep.size} "
        f"blocks kept; X^T {d_model} x {tokens}")
    run_bsr("g", "SpMM W1^T X^T", "spmm", "spmm_bsr",
            "x(i,k) = B(i,j) * C(j,k)", {"B": "bb", "C": "dd", "x": "dd"},
            {"i": d_ff, "j": d_model, "k": tokens}, {"B": w1t, "C": xt},
            want)
    del w1t, xt, want

    # (h) sampled attention scores under the causal sliding-window mask
    n_win = s_len // bs
    kv_win = kops.sliding_window_kv_idx(n_win, n_win, win)
    allow_blk = np.zeros((n_win, n_win), bool)
    qb = np.repeat(np.arange(n_win), win)
    live = kv_win.ravel() < n_win
    allow_blk[qb[live], kv_win.ravel()[live]] = True
    mask = (np.kron(allow_blk, np.ones((bs, bs), np.int8))
            * rng.integers(1, 4, (s_len, s_len), dtype=np.int8)
            ).astype(np.float32)
    a_q = rng.integers(-3, 4, (s_len, hd)).astype(np.float32)
    c_k = rng.integers(-3, 4, (s_len, hd)).astype(np.float32)
    want = mask.astype(np.float64) * (a_q.astype(np.float64)
                                      @ c_k.astype(np.float64).T)
    log(f"[h] M {s_len} x {s_len}: {int(allow_blk.sum())} of "
        f"{allow_blk.size} blocks")
    run_bsr("h", "SDDMM M*(Q K^T)", "sddmm", "sddmm_bsr",
            "X(i,j) = M(i,j) * A(i,k) * C(j,k)", {"M": "bb", "X": "dd"},
            {"i": s_len, "j": s_len, "k": hd},
            {"M": mask, "A": a_q, "C": c_k}, want)
    del a_q, c_k, want

    # (i) one head of llama3.2-3b-bsr through the attention pattern
    qkv = {t: rng.standard_normal((s_len, hd)).astype(np.float32)
           for t in "QKV"}
    allow = np.kron(allow_blk, np.ones((bs, bs), bool))
    want = attention_oracle(qkv["Q"], qkv["K"], qkv["V"], allow)
    del allow
    run_bsr("i", "attention 1 head", "attention", "bsr_attention",
            "O(i,d) = M(i,j) * Q(i,e) * K(j,e) * V(j,d)",
            {"M": "bb", "Q": "dd", "K": "dd", "V": "dd", "O": "dd"},
            {"i": s_len, "j": s_len, "e": hd, "d": hd},
            {"M": mask, **qkv}, want,
            check=lambda n, got, w: check_close(n, got, w, ATTN_TOL))
    del mask, qkv, want

    # (j) the attention kernel on all heads, called directly
    g = torch.Generator(device="cuda").manual_seed(SEED)
    q_all, k_all, v_all = (torch.randn((heads, s_len, hd), device="cuda",
                                       generator=g) for _ in range(3))
    kv_all = torch.as_tensor(kv_win, device="cuda")
    kops.reset_launch_counts()
    outs = {c: bsr_flash_attention(q_all, k_all, v_all, kv_all, bq=bs,
                                   bkv=bs, causal=c) for c in (False, True)}
    torch.cuda.synchronize()
    per_phase["j"] = kops.launch_counts()
    if per_phase["j"]["bsr_attention"] != 2:
        raise AssertionError(f"(j) launches {per_phase['j']}")
    check_routes("j", "bsr_attention")
    for causal, out in outs.items():
        if out.shape != q_all.shape or not torch.isfinite(out).all():
            raise AssertionError(f"(j) causal={causal}: not finite")
    log(f"[j] bsr_flash_attention on {heads} heads x {s_len} x {hd}, "
        f"causal off and on: finite; launches {per_phase['j']}")
    del outs

    # -- (k), (k2) the fused GAT-style program -------------------------------
    # ogbn-arxiv's widths: 128 node features, mean degree about 13.7 once
    # symmetrized; the node count is cut to 16384 (the entry point takes
    # dense operands) and the degree is uniform (14 distinct neighbours a row)
    n_nodes, deg, feat = 16384, 14, 128
    src = np.repeat(np.arange(n_nodes), deg)
    dst = np.concatenate([rng.choice(n_nodes, deg, replace=False)
                          for _ in range(n_nodes)])
    edge = rng.integers(1, 4, src.size) * rng.choice([-1, 1], src.size)
    adj = np.zeros((n_nodes, n_nodes))
    adj[src, dst] = edge
    feats = {t: rng.integers(-3, 4, (n_nodes, feat)).astype(float)
             for t in "CDE"}
    gat_arrays = {"B": adj, **feats}
    scores = edge * np.einsum("ef,ef->e", feats["C"][src], feats["D"][dst])
    gat_want = sp.csr_matrix((scores, (src, dst)),
                             shape=(n_nodes, n_nodes)) @ feats["E"]
    gat_dims = {"i": n_nodes, "j": n_nodes, "f": feat, "g": feat}
    log(f"[k] B {n_nodes} x {n_nodes}: {src.size} edges; C, D, E "
        f"{n_nodes} x {feat}")
    gat_out = {}

    def run_program(tag, label, fuse):
        kops.reset_launch_counts()
        cp = compile_program(
            GAT, Format(GAT_FMT),
            {k: Schedule(loop_order=o) for k, o in GAT_ORDER.items()},
            gat_dims, fuse=fuse)
        gat_out[tag] = run_workload(tag, label, cp, gat_arrays, gat_want,
                                    reps=3, result=lambda out: out["A"])
        units = [dict(u.stats) for _, _, u in cp.units]
        workloads[label]["unit_stats"] = units
        log(f"[{tag}] units {units}")
        return cp, units

    # the first call records capacities, so no call of (k) may regrow them
    cp, units = run_program("k", "GAT fused", True)
    reduces = (per_phase["k"]["segment_reduce"]
               + per_phase["k"]["scatter_workspace"])
    if (cp.stats["fused_stages"] != 2 or cp.stats["fused_intermediates"] != 1
            or cp.stats["materialized_handoffs"] != 0
            or per_phase["k"]["coo_to_levels"] < 1 or reduces < 1
            or any(u["overflow_retries"] for u in units)):
        raise AssertionError(f"(k) stats {cp.stats}, launches "
                             f"{per_phase['k']}, units {units}")
    cp, _ = run_program("k2", "GAT unfused", False)
    if (cp.stats["fused_stages"] != 0
            or cp.stats["materialized_handoffs"] != 1
            or not np.array_equal(gat_out["k2"], gat_out["k"])):
        raise AssertionError(f"(k2) stats {cp.stats}, or A differs from (k)")
    log(f"[k2] A is bit-identical to (k)'s; warm median fused "
        f"{workloads['GAT fused']['warm_ms']:.1f} ms, unfused "
        f"{workloads['GAT unfused']['warm_ms']:.1f} ms")
    clear_program_cache()
    del adj, gat_arrays, gat_out, cp

    # -- (l) coo_to_levels alone at 2**24 keys -------------------------------
    dims_l = [4096, 1 << 25, 8]
    n_l = 1 << 24
    g = torch.Generator(device="cuda").manual_seed(SEED)
    space = 4096 * (1 << 25) * 8
    raw = torch.unique(torch.randint(0, space, (n_l + (1 << 16),),
                                     device="cuda", generator=g))
    pick = torch.randperm(raw.numel(), device="cuda", generator=g)[:n_l]
    keys_l = torch.cat([raw[pick.sort().values],
                        torch.full((1024,), co.PAD_KEY, device="cuda")])
    valid_l = keys_l != co.PAD_KEY
    del raw, pick
    counts_l, pref = [], keys_l[:n_l]
    for d in reversed(dims_l):
        counts_l.insert(0, int(torch.unique(pref).numel()))
        pref = pref // d
    caps_l = [_bucket_cap(c) for c in counts_l]

    def coo_equal(got, want, where):
        for part, dtype in enumerate((torch.int32, torch.int32,
                                      torch.int64)):
            for lvl, (a, b) in enumerate(zip(got[part], want[part])):
                if a.dtype != dtype or not torch.equal(a, b):
                    raise AssertionError(f"coo_to_levels differs from its "
                                         f"plain version at {where}: part "
                                         f"{part}, level {lvl}")

    kops.reset_launch_counts()
    for caps in (caps_l, [c // 2 for c in counts_l]):
        got = coo_to_levels(keys_l, valid_l, dims_l, caps)
        coo_equal(got, coo_to_levels_plain(keys_l, valid_l, dims_l, caps),
                  f"(l) caps {caps}")
        if [int(c) for c in got[2]] != counts_l:
            raise AssertionError(f"(l) counts {got[2]} != {counts_l}")
    for keys_e in (torch.zeros(0, dtype=torch.int64, device="cuda"),
                   torch.tensor([12345], device="cuda")):
        valid_e = torch.ones_like(keys_e, dtype=torch.bool)
        coo_equal(coo_to_levels(keys_e, valid_e, dims_l, [8, 8, 8]),
                  coo_to_levels_plain(keys_e, valid_e, dims_l, [8, 8, 8]),
                  f"(l) N={keys_e.numel()}")
    torch.cuda.synchronize()
    per_phase["l"] = kops.launch_counts()
    if per_phase["l"]["coo_to_levels"] != 4:
        raise AssertionError(f"(l) launches {per_phase['l']}")
    log(f"[l] coo_to_levels on N={keys_l.numel()} dims {dims_l}: counts "
        f"{counts_l} exact and equal to the plain version at caps {caps_l} "
        f"and at half the counts (overflow); N=0 and N=1 equal too")

    # -- (l2) the same at extents that are not powers of two ----------------
    dims_l2 = [4099, 33554393, 7]
    space = 4099 * 33554393 * 7
    raw = torch.unique(torch.randint(0, space, (n_l + (1 << 16),),
                                     device="cuda", generator=g))
    pick = torch.randperm(raw.numel(), device="cuda", generator=g)[:n_l]
    keys_l2 = torch.cat([raw[pick.sort().values],
                         torch.full((1024,), co.PAD_KEY, device="cuda")])
    valid_l2 = keys_l2 != co.PAD_KEY
    del raw, pick
    counts_l2, pref = [], keys_l2[:n_l]
    for d in reversed(dims_l2):
        counts_l2.insert(0, int(torch.unique(pref).numel()))
        pref = pref // d
    caps_l2 = [_bucket_cap(c) for c in counts_l2]
    kops.reset_launch_counts()
    for caps in (caps_l2, [c // 2 for c in counts_l2]):
        got = coo_to_levels(keys_l2, valid_l2, dims_l2, caps)
        coo_equal(got, coo_to_levels_plain(keys_l2, valid_l2, dims_l2, caps),
                  f"(l2) caps {caps}")
        if [int(c) for c in got[2]] != counts_l2:
            raise AssertionError(f"(l2) counts {got[2]} != {counts_l2}")
    torch.cuda.synchronize()
    per_phase["l2"] = kops.launch_counts()
    if per_phase["l2"]["coo_to_levels"] != 2:
        raise AssertionError(f"(l2) launches {per_phase['l2']}")
    log(f"[l2] coo_to_levels on N={keys_l2.numel()} dims {dims_l2}: counts "
        f"{counts_l2} exact and equal to the plain version at caps "
        f"{caps_l2} and at half the counts (overflow)")

    # -- (f) kernels against their plain versions ----------------------------
    # each kernel is timed at the last input a warm (plan-cached) call of
    # each workload handed it; the kernels line carries the largest of
    # those shapes
    kernels, measured = [], []

    def held(name, out_k, out_p, where, tol=0.0):
        """Max abs error of a kernel's output against its plain version's;
        raises unless every element is within tol + tol * |plain|."""
        torch.cuda.synchronize()
        diff = (out_k.double() - out_p.double()).abs()
        err = float(diff.max()) if out_k.numel() else 0.0
        if (out_k.shape != out_p.shape or not torch.isfinite(out_k).all()
                or bool((diff > tol + tol * out_p.double().abs()).any())):
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version at {where} (max abs err {err}, "
                                 f"tolerance {tol})")
        return err

    def paired_ms(new, old):
        """The kernel and the CUDA-core kernel its route replaced, timed in
        turns on the same inputs: new, old, old, new."""
        return [event_ms(fn) for fn in (new, old, old, new)]

    def timed_library(name, library):
        """Time one PyTorch library call, or None where there is none or it
        does not run."""
        if library is None:
            return None
        try:
            library()
            return event_ms(library)
        except (RuntimeError, NotImplementedError, TypeError) as exc:
            log(f"[f] {name}: library call not timed ({exc})"[:300])
            return None

    def report(name, launches, kernel, plain, library, nbytes, nops, where,
               tol=0.0, flat=lambda out: out, per_call=1,
               rate=FP32_OPS_PER_S):
        """Hold a kernel against its plain version and time both; ``rate``
        is the operation rate of its bound (``PRODUCT_OPS_PER_S`` for the
        matrix products)."""
        err = held(name, flat(kernel()), flat(plain()), where, tol)
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = nops / rate
        row = {"name": name, "route": "cuda",
               "source": KERNEL_META[name][0],
               "replaces": KERNEL_META[name][1], "launches": launches,
               "max_abs_err": err, "ms": event_ms(kernel),
               "plain_ms": event_ms(plain), "bound_ms": max(t_bytes, t_ops)
               * 1e3, "bound_by": "bytes" if t_bytes >= t_ops else
               "operations", "library_ms": timed_library(name, library),
               "fp32_bound_ms": max(t_bytes, nops / FP32_OPS_PER_S) * 1e3,
               "shape": where, "bytes": nbytes}
        # CUDA events time the wrapper call as the engine pays it, host
        # launch gaps included; the profiler splits out device time
        row["device_ms"], row["kernel_device_ms"] = profiled_device_ms(
            kernel, name,          # each kernel's symbol contains its name
            per_call=per_call)
        # the same events again, after the profiled run: a spread between
        # the two readings is the card's, not the kernel's
        row["ms_again"] = event_ms(kernel)
        measured.append(row)
        dev = ("device not measured" if row["device_ms"] is None else
               f"device {row['device_ms']:.4f}, of it the kernel "
               f"{row['kernel_device_ms']:.4f}")
        lib = ("not timed" if row["library_ms"] is None
               else f"{row['library_ms']:.4f}")
        log(f"[f] {name} at {where}: ms {row['ms']:.4f} (again after the "
            f"profile {row['ms_again']:.4f}; {dev}) plain_ms "
            f"{row['plain_ms']:.4f} library_ms {lib} bound_ms "
            f"{row['bound_ms']:.4f} ({row['bound_by']}; fp32_bound_ms "
            f"{row['fp32_bound_ms']:.4f}) max_abs_err {err}")
        return row

    def sector_bytes(rows, row_bytes):
        """Bytes of the 32-byte sectors that hold the given rows of an
        array of ``row_bytes``-byte rows (a row of up to 32 bytes spans at
        most two sectors)."""
        first = rows * row_bytes // 32
        last = (rows * row_bytes + row_bytes - 1) // 32
        return torch.unique(torch.cat([first, last])).numel() * 32

    # the reduce kernels skip a row whose id lies outside [0, slots) before
    # they read its values, so their bound counts every id, the values of
    # the live rows in the sectors that hold them, and the output once
    def reduce_launches(name):
        return sum(per_phase[t][name] for t in "mnop") + main_counts[name]

    def workspace_row(tag, ids, cols, slots, mp):
        ids64 = ids.long().clamp(0, slots)
        c_out = 2 if mp else cols.shape[1]
        lib_cols = cols[:, :c_out].contiguous()
        live = ((ids >= 0) & (ids < slots)).nonzero().squeeze(1)
        return report(
            "scatter_workspace", reduce_launches("scatter_workspace"),
            lambda: scatter_workspace(ids, cols, num_slots=slots,
                                      mul_pair=mp),
            lambda: scatter_workspace_plain(ids, cols, num_slots=slots,
                                            mul_pair=mp),
            lambda: torch.zeros((slots + 1, c_out), device="cuda"
                                ).index_add_(0, ids64, lib_cols),
            ids.numel() * ids.element_size()
            + sector_bytes(live, cols.shape[1] * 4) + slots * c_out * 4,
            live.numel() * c_out,
            f"({tag}) N={ids.numel()} live={live.numel()} "
            f"C={cols.shape[1]} slots={slots} mul_pair={mp}")

    def segment_row(tag, vals, sids, nseg):
        """The general entry: (N, D) values by int32 id."""
        sids64 = sids.long().clamp(0, nseg)
        live = ((sids >= 0) & (sids < nseg)).nonzero().squeeze(1)
        return report(
            "segment_reduce", reduce_launches("segment_reduce"),
            lambda: segment_reduce(vals, sids, num_segments=nseg),
            lambda: segment_reduce_plain(vals, sids, num_segments=nseg),
            lambda: torch.zeros((nseg + 1, vals.shape[1]), device="cuda",
                                dtype=vals.dtype
                                ).index_add_(0, sids64, vals),
            sids.numel() * sids.element_size()
            + sector_bytes(live, vals.shape[1] * vals.element_size())
            + nseg * vals.shape[1] * vals.element_size(),
            live.numel() * vals.shape[1],
            f"({tag}) N={vals.shape[0]} live={live.numel()} "
            f"D={vals.shape[1]} S={nseg}")

    def segment_mul_row(tag, kw):
        """The [a*b, 1] mode at the inputs the engine handed it. Its bound
        counts every key and mask byte (the kernel reads both for every
        row), a and b of the live rows in their sectors, and the output;
        no single PyTorch call computes it (a product, a mask and a
        scatter), so it has no library time."""
        keys, a, b, valid = kw["keys"], kw["a"], kw["b"], kw["valid"]
        nseg = kw["num_segments"]
        live = (valid & (keys >= 0) & (keys < nseg)).nonzero().squeeze(1)
        return report(
            "segment_reduce", reduce_launches("segment_reduce"),
            lambda: segment_reduce_mul(keys, a, b, valid, num_segments=nseg),
            lambda: segment_reduce_mul_plain(keys, a, b, valid,
                                             num_segments=nseg), None,
            keys.numel() * 9 + sector_bytes(live, 4)
            * (1 if b is None else 2) + nseg * 2 * 4,
            live.numel() * (3 if b is not None else 2),
            f"({tag}) [a*b, 1] mode N={keys.numel()} live={live.numel()} "
            f"S={nseg}")

    rows = []
    for tag in ("c", "d", "d2", "e"):
        for kw in seen.get(tag, {}).get("scatter_workspace", [])[-1:]:
            rows.append(workspace_row(tag, kw["ids"], kw["cols"],
                                      kw["num_slots"], kw["mul_pair"]))
    kernels.append(max(rows, key=lambda r: r["bytes"]))

    # segment_reduce on the main path: the general entry's D = 1 calls
    # ((c)'s and (e)'s collapses, the sort-merge's inner sum in (k)) and
    # the [a*b, 1] mode over a key space ((d), (m), each lane of (o)'s
    # tiles); the kernels line carries the largest of those
    rows = []
    for tag in ("c", "e", "k"):
        for kw in seen.get(tag, {}).get("segment_reduce", [])[-1:]:
            rows.append(segment_row(tag, kw["vals"], kw["seg_ids"],
                                    kw["num_segments"]))
    for tag in ("d", "m", "o"):
        for kw in seen.get(tag, {}).get("segment_reduce_mul", [])[-1:]:
            rows.append(segment_mul_row(tag, kw))
    kernels.append(max(rows, key=lambda r: r["bytes"]))

    # the general entry at the two shapes PR 17 timed it at, rebuilt with
    # the key structure its recorded inputs had: a [value, 1] stream whose
    # live rows are a prefix in (i, k, j) order, the rest the dropped id S.
    # (o): the first tile's 137M products (j-contiguous keys under each
    # (i, k)) at a capacity of 2^28 into 2^23 segments; (d): 1.7M products
    # at a capacity of 4,194,304 into 2^24
    def product_stream(b_coo, c_csr, width, cap, nseg):
        """The [b * c, 1] rows of the products B[i, k] * C[k, j] over C's
        row k in (i, k, j) order, keys i * width + j, padded to ``cap``
        rows of the dropped id ``nseg``. ``b_coo``: B's (i, k, value) in
        row-major order; ``c_csr``: C's (indptr, indices, data)."""
        ii, kk, bv = b_coo
        indptr, indices, data = c_csr
        cnt = indptr[kk + 1] - indptr[kk]
        pos = (torch.repeat_interleave(indptr[kk] - torch.cumsum(cnt, 0)
                                       + cnt, cnt)
               + torch.arange(int(cnt.sum()), device="cuda"))
        n_live = pos.numel()
        sids = torch.full((cap,), nseg, dtype=torch.int32, device="cuda")
        sids[:n_live] = (torch.repeat_interleave(ii, cnt) * width
                         + indices[pos]).int()
        vals = torch.zeros((cap, 2), device="cuda")
        vals[:n_live, 0] = torch.repeat_interleave(bv, cnt) * data[pos]
        vals[:n_live, 1] = 1.0
        return vals, sids

    pr17_shapes = (("o", o_tile["b"], o_tile["c"], nj, 1 << 28, 1 << 23),
                   ("d", d_csr["b"], d_csr["c"], 4096, 1 << 22, 1 << 24))
    for tag, b_coo, c_csr, width, cap, nseg in pr17_shapes:
        vals, sids = product_stream(b_coo, c_csr, width, cap, nseg)
        row = segment_row(f"{tag}, PR 17's shape", vals, sids, nseg)
        # a [value, 1] reduce over the key space: the workspace kernel
        # computes the same function on the same inputs
        if not torch.equal(scatter_workspace(sids, vals, num_slots=nseg),
                           segment_reduce(vals, sids, num_segments=nseg)):
            raise AssertionError(f"({tag}) scatter_workspace differs from "
                                 "segment_reduce")
        row["workspace_route_ms"] = event_ms(
            lambda: scatter_workspace(sids, vals, num_slots=nseg))
        log(f"[f] segment_reduce at ({tag}, PR 17's shape): "
            f"scatter_workspace on the same inputs, equal, ms "
            f"{row['workspace_route_ms']:.4f}")
        del vals, sids

    # fused_imr: its own phase through the intersect_mul_reduce entry
    na, nb, slots = 4 << 20, 1 << 20, 1 << 20
    g = torch.Generator(device="cuda").manual_seed(SEED)
    space = 16 << 20
    a_key = torch.unique(torch.randint(0, space, (int(na * 1.1),),
                                       device="cuda", generator=g))[:na]
    b_key = torch.unique(torch.randint(0, space, (int(nb * 1.1),),
                                       device="cuda", generator=g))[:nb]
    a_key = a_key.long()
    b_key = b_key.long()
    na, nb = a_key.numel(), b_key.numel()
    a_valid = torch.ones(na, dtype=torch.bool, device="cuda")
    b_valid = torch.arange(nb, device="cuda") < nb - 4096    # prefix-valid
    b_key = torch.where(b_valid, b_key, co.PAD_KEY)
    a_vals = torch.randint(1, 9, (na,), device="cuda", generator=g).float()
    b_vals = torch.randint(1, 9, (nb,), device="cuda", generator=g).float()
    out_key = torch.randint(0, slots, (na,), device="cuda", generator=g)
    imr = kops.sam_primitive("intersect_mul_reduce", "cuda")
    fused_imr_workspace.launches = 0
    uk, uv, uvalid, count = imr(a_key, a_valid, a_vals, b_key, b_valid,
                                b_vals, out_key, slots, key_bound=slots)
    imr_launches = fused_imr_workspace.launches
    if imr_launches < 1:
        raise AssertionError("intersect_mul_reduce never launched fused_imr")
    fk, fv, fvalid, fcount = co.fused_intersect_mul_reduce(
        a_key, a_valid, a_vals, b_key, b_valid, b_vals, out_key, slots,
        key_bound=slots)
    if (int(count) != int(fcount) or not torch.equal(uk, fk)
            or not torch.equal(uv, fv) or not torch.equal(uvalid, fvalid)):
        raise AssertionError("intersect_mul_reduce entry differs from the "
                             "coord_ops composition")
    hits = int((uvalid & (uv != 0)).sum())
    log(f"[f] intersect_mul_reduce entry equals coord_ops on NA={na} "
        f"NB={nb} slots={slots}: {int(count)} slots appeared, {hits} live")
    bk_in = torch.where(b_valid, b_key, co.PAD_KEY)
    bv_in = torch.where(b_valid, b_vals, 0.0)
    idx = torch.searchsorted(bk_in, a_key).clamp(max=nb - 1)
    hit = bk_in[idx] == a_key
    # the bytes the function needs: every key of a and of b once, the
    # workspace once, and a's value and output key and b's value only at
    # the hits, counted in the 32-byte sectors that hold them
    hit_a = hit.nonzero().squeeze(1)
    n_hit = hit_a.numel()

    n_hit_bytes = (sector_bytes(hit_a, 4) + sector_bytes(hit_a, 8)
                   + sector_bytes(idx[hit_a], 4))
    log(f"[f] fused_imr: {n_hit} of {na} elements of a hit; the hits' "
        f"gathers touch {n_hit_bytes} bytes")
    lib_ids = torch.where(hit, out_key, slots)
    lib_cols = torch.stack([a_vals * bv_in[idx], hit.float()], 1)
    kernels.append(report("fused_imr", imr_launches,
           lambda: fused_imr_workspace(a_key, a_vals, out_key, bk_in, bv_in,
                                       num_slots=slots),
           lambda: fused_imr_workspace_plain(a_key, a_vals, out_key, bk_in,
                                             bv_in, num_slots=slots),
           lambda: torch.zeros((slots + 1, 2), device="cuda"
                               ).index_add_(0, lib_ids, lib_cols),
           na * 8 + nb * 8 + slots * 2 * 4 + n_hit_bytes,
           n_hit * 3,
           f"NA={na} NB={nb} slots={slots}"))

    # the block-sparse kernels, at the inputs (g)-(j) gave them
    kw = seen["g"]["spmm_bsr"][-1]
    bm, ci, bp, cc = kw["blk_map"], kw["col_idx"], kw["blocks"], kw["c"]
    n_brow, bsz, nnzb = bm.shape[0], bp.shape[1], bp.shape[0] - 1
    live = bm < nnzb
    crow = torch.zeros(n_brow + 1, dtype=torch.int64, device="cuda")
    crow[1:] = live.sum(1).cumsum(0)
    bsr_w = torch.sparse_bsr_tensor(crow, ci[live].long(),
                                    bp[bm[live].long()],
                                    size=(n_brow * bsz, cc.shape[0]))
    n_live = int(live.sum())
    kernels.append(report(
        "spmm_bsr", per_phase["g"]["spmm_bsr"],
        lambda: spmm_bsr(bm, ci, bp, cc),
        lambda: spmm_bsr_plain(bm, ci, bp, cc),
        lambda: torch.sparse.mm(bsr_w, cc),
        2 * bm.numel() * 4 + bp.numel() * 4 + cc.numel() * 4
        + n_brow * bsz * cc.shape[1] * 4,
        2 * n_live * bsz * bsz * cc.shape[1],
        f"(g) n_brow={n_brow} max_nnz={bm.shape[1]} nnzb={nnzb} bs={bsz} "
        f"K={cc.shape[0]} N={cc.shape[1]}",
        rate=PRODUCT_OPS_PER_S["float32"]))
    del bsr_w
    bm32, ci32 = (x.to(torch.int32).contiguous() for x in (bm, ci))
    out_cc = torch.empty((n_brow * bsz, cc.shape[1]), device="cuda")
    turns = paired_ms(
        lambda: spmm_bsr(bm, ci, bp, cc),
        lambda: _build.call("sam_spmm_bsr_f32", bm32.data_ptr(),
                            ci32.data_ptr(), bp.data_ptr(), cc.data_ptr(),
                            out_cc.data_ptr(), n_brow, bm.shape[1], nnzb,
                            bsz, cc.shape[0], cc.shape[1]))
    log("[f] spmm_bsr at (g), tensor cores against the CUDA-core kernel "
        "in turns (new, old, old, new): " + ", ".join(
            f"{t:.4f}" for t in turns) + " ms")
    held("spmm_bsr", out_cc, spmm_bsr_plain(bm, ci, bp, cc),
         "(g), the CUDA-core kernel")
    del out_cc

    # (g)'s shape on standard-normal float32: every element against the
    # float64 product, within (3 * 2^-22 + K * 2^-24) * sum_k |a_k c_k|,
    # K the row's live slots times bs (the bound sddmm_bsr is held to)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    bn = torch.randn(bp.shape, device="cuda", generator=g)
    bn[-1] = 0
    cn = torch.randn(cc.shape, device="cuda", generator=g)
    got_n = spmm_bsr(bm, ci, bn, cn)
    n_bcol = -(-cc.shape[0] // bsz)
    w64 = torch.zeros((n_brow, n_bcol, bsz, bsz), dtype=torch.float64,
                      device="cuda")
    w64[torch.arange(n_brow, device="cuda").repeat_interleave(
        bm.shape[1])[live.reshape(-1)], ci[live].long()] = bn[
            bm[live].long()].double()
    w64 = w64.permute(0, 2, 1, 3).reshape(n_brow * bsz, n_bcol * bsz)[
        :, :cc.shape[0]]
    err_n = (got_n.double() - w64 @ cn.double()).abs()
    k_row = (live.sum(1).double() * bsz).repeat_interleave(bsz)[:, None]
    limit = (3 * 2.0 ** -22 + k_row * 2.0 ** -24) * (w64.abs()
                                                     @ cn.double().abs())
    worst = float((err_n / limit.clamp_min(1e-300)).max())
    plain_err = float((got_n - spmm_bsr_plain(bm, ci, bn, cn)).abs().max())
    if not torch.isfinite(got_n).all() or bool((err_n > limit).any()):
        raise AssertionError(f"spmm_bsr on normal data: error reaches "
                             f"{worst} of its 3xTF32 bound")
    log(f"[f] spmm_bsr at (g) on standard-normal float32: largest error "
        f"{float(err_n.max()):.3e} against float64, {worst:.4f} of the "
        f"per-element 3xTF32 bound; max abs diff from the plain version "
        f"{plain_err:.3e}")
    del bn, cn, got_n, w64, err_n, k_row, limit

    kw = seen["h"]["sddmm_bsr"][-1]
    sr, sc, sa, sb, sbs = kw["rows"], kw["cols"], kw["a"], kw["b"], kw["bs"]
    a3 = sa.view(-1, sbs, sa.shape[1])
    b3 = sb.view(-1, sbs, sb.shape[1])
    nnzb = sr.numel()
    kernels.append(report(
        "sddmm_bsr", per_phase["h"]["sddmm_bsr"],
        lambda: sddmm_bsr(sr, sc, sa, sb, sbs),
        lambda: sddmm_bsr_plain(sr, sc, sa, sb, sbs),
        lambda: torch.bmm(a3[sr], b3[sc].transpose(1, 2)),
        2 * nnzb * 4 + (sa.numel() + sb.numel() + nnzb * sbs * sbs) * 4,
        2 * nnzb * sbs * sbs * sa.shape[1],
        f"(h) nnzb={nnzb} bs={sbs} K={sa.shape[1]}",
        rate=PRODUCT_OPS_PER_S["float32"]))

    out_cc = torch.empty((nnzb, sbs, sbs), device="cuda")
    turns = paired_ms(
        lambda: sddmm_bsr(sr, sc, sa, sb, sbs),
        lambda: _build.call("sam_sddmm_bsr_f32", sr.data_ptr(),
                            sc.data_ptr(), sa.data_ptr(), sb.data_ptr(),
                            out_cc.data_ptr(), nnzb, sbs, sa.shape[1],
                            sa.shape[0], sb.shape[0]))
    log("[f] sddmm_bsr at (h), tensor cores against the CUDA-core kernel "
        "in turns (new, old, old, new): " + ", ".join(
            f"{t:.4f}" for t in turns) + " ms")
    del out_cc

    # (h)'s shape on standard-normal float32: every element against the
    # float64 product, within the worst case of 3xTF32 (the dropped lo*lo
    # term and two residual roundings, 3 * 2^-22 a product) plus float32
    # summation (K * 2^-24), times sum_k |a_k b_k|; one TF32 pass would
    # fail it many times over
    g = torch.Generator(device="cuda").manual_seed(SEED)
    an, bn = (torch.randn(x.shape, device="cuda", generator=g)
              for x in (sa, sb))
    got_n = sddmm_bsr(sr, sc, an, bn, sbs)
    a64 = an.double().view(-1, sbs, an.shape[1])[sr.long()]
    b64 = bn.double().view(-1, sbs, bn.shape[1])[sc.long()].transpose(1, 2)
    err_n = (got_n.double() - torch.bmm(a64, b64)).abs()
    limit = ((3 * 2.0 ** -22 + an.shape[1] * 2.0 ** -24)
             * torch.bmm(a64.abs(), b64.abs()))
    worst = float((err_n / limit).max())
    plain_err = float((got_n - sddmm_bsr_plain(sr, sc, an, bn, sbs)).abs()
                      .max())
    if not torch.isfinite(got_n).all() or worst > 1.0:
        raise AssertionError(f"sddmm_bsr on normal data: error reaches "
                             f"{worst} of its 3xTF32 bound")
    log(f"[f] sddmm_bsr at (h) on standard-normal float32: largest error "
        f"{float(err_n.max()):.3e} against float64, {worst:.4f} of the "
        f"per-element 3xTF32 bound; max abs diff from the plain version "
        f"{plain_err:.3e}")
    del an, bn, got_n, a64, b64, err_n, limit

    def attention_mask(kv, n_q, n_kv, causal):
        """Dense boolean (S_q, S_kv) mask of a kv_idx (for the library)."""
        blk = torch.zeros((n_q, n_kv + 1), dtype=torch.bool, device="cuda")
        blk.scatter_(1, kv.long().clamp(0, n_kv), True)
        full = blk[:, :n_kv].repeat_interleave(bs, 0).repeat_interleave(
            bs, 1)
        return full.tril() if causal else full

    attn_launches = (per_phase["i"]["bsr_attention"]
                     + per_phase["j"]["bsr_attention"])
    for causal in (False, True):
        pairs = heads * attention_pairs(kv_win, bs, bs, n_win, causal)
        dense_mask = attention_mask(kv_all, n_win, n_win, causal)
        row = report(
            "bsr_attention", attn_launches,
            lambda: bsr_flash_attention(q_all, k_all, v_all, kv_all, bq=bs,
                                        bkv=bs, causal=causal),
            lambda: bsr_flash_attention_plain(q_all, k_all, v_all, kv_all,
                                              bq=bs, bkv=bs, causal=causal),
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q_all[None], k_all[None], v_all[None], attn_mask=dense_mask),
            4 * q_all.numel() * 4 + kv_all.numel() * 4, 4 * hd * pairs,
            f"(j) BH={heads} S={s_len} D={hd} causal={causal}",
            tol=KERNEL_TOL["float32"], rate=PRODUCT_OPS_PER_S["float32"])
        del dense_mask
        if not causal:
            kernels.append(row)
        out_cc = torch.empty_like(q_all)
        turns = paired_ms(
            lambda: bsr_flash_attention(q_all, k_all, v_all, kv_all, bq=bs,
                                        bkv=bs, causal=causal),
            lambda: _build.call(
                "sam_bsr_attention_f32", kv_all.data_ptr(), q_all.data_ptr(),
                k_all.data_ptr(), v_all.data_ptr(), out_cc.data_ptr(), heads,
                s_len, s_len, hd, n_win, win, bs, bs, hd ** -0.5,
                int(causal)))
        log(f"[f] bsr_attention at (j) causal={causal}, tensor cores against "
            f"the CUDA-core kernel in turns (new, old, old, new): "
            + ", ".join(f"{t:.4f}" for t in turns) + " ms")
        del out_cc

    # the path's own head (i): a fully masked q block, and bfloat16
    kw = seen["i"]["bsr_attention"][-1]
    qi_, ki_, vi_, idx_i = kw["q"], kw["k"], kw["v"], kw["kv_idx"]
    idx_m = idx_i.clone()
    idx_m[0] = ki_.shape[1] // bs                     # every slot masked
    out_m = bsr_flash_attention(qi_, ki_, vi_, idx_m, bq=bs, bkv=bs)
    torch.cuda.synchronize()
    if out_m[:, :bs].count_nonzero():
        raise AssertionError("bsr_attention: a fully masked q block is not "
                             "zeros")
    err_m = held("bsr_attention", out_m,
                 bsr_flash_attention_plain(qi_, ki_, vi_, idx_m, bq=bs,
                                           bkv=bs),
                 "(i) with q block 0 masked", KERNEL_TOL["float32"])
    q16, k16, v16 = (x.bfloat16() for x in (qi_, ki_, vi_))
    err_16 = held("bsr_attention",
                  bsr_flash_attention(q16, k16, v16, idx_i, bq=bs, bkv=bs),
                  bsr_flash_attention_plain(q16, k16, v16, idx_i, bq=bs,
                                            bkv=bs),
                  "(i) in bfloat16", KERNEL_TOL["bfloat16"])
    log(f"[f] bsr_attention at (i): q block 0 fully masked gives zeros "
        f"(max abs err {err_m} elsewhere); bfloat16 max abs err {err_16}")

    def one_head():
        return bsr_flash_attention(qi_, ki_, vi_, idx_i, bq=bs, bkv=bs)

    dev_i, kern_i = profiled_device_ms(one_head, "bsr_attention")
    ops_i = 4 * hd * attention_pairs(kv_win, bs, bs, n_win, False)
    log(f"[f] bsr_attention at (i) BH=1 S={qi_.shape[1]} D={qi_.shape[2]}: "
        f"ms {event_ms(one_head):.4f}, device " + (
            "not measured" if dev_i is None else
            f"{dev_i:.4f}, of it the kernel {kern_i:.4f}")
        + f", bound_ms {ops_i / PRODUCT_OPS_PER_S['float32'] * 1e3:.4f} "
        f"(fp32_bound_ms {ops_i / FP32_OPS_PER_S * 1e3:.4f})")

    # (j) in bfloat16: the card's rate for a bf16 model's attention
    qb_all, kb_all, vb_all = (x.bfloat16() for x in (q_all, k_all, v_all))
    err_b = held("bsr_attention",
                 bsr_flash_attention(qb_all, kb_all, vb_all, kv_all, bq=bs,
                                     bkv=bs),
                 bsr_flash_attention_plain(qb_all, kb_all, vb_all, kv_all,
                                           bq=bs, bkv=bs),
                 "(j) in bfloat16", KERNEL_TOL["bfloat16"])
    ops_j = 4 * hd * heads * attention_pairs(kv_win, bs, bs, n_win, False)
    bound_b = max(ops_j / PRODUCT_OPS_PER_S["bfloat16"],
                  4 * qb_all.numel() * 2 / HBM_BYTES_PER_S) * 1e3
    ms_b = event_ms(lambda: bsr_flash_attention(qb_all, kb_all, vb_all,
                                                kv_all, bq=bs, bkv=bs))
    log(f"[f] bsr_attention at (j) in bfloat16, causal=False: ms "
        f"{ms_b:.4f}, bound_ms {bound_b:.4f} (bf16 rate), max abs err "
        f"{err_b} against the plain version")
    del qb_all, kb_all, vb_all
    for name, fn, args in (
            ("spmm_bsr", spmm_bsr, (bm, ci, bp.bfloat16(), cc.bfloat16())),
            ("sddmm_bsr", sddmm_bsr, (sr, sc, sa.bfloat16(), sb.bfloat16(),
                                      sbs))):
        plain = spmm_bsr_plain if name == "spmm_bsr" else sddmm_bsr_plain
        err = held(name, fn(*args), plain(*args), "bfloat16")
        log(f"[f] {name} in bfloat16 at the same shape: max abs err {err}")
    bf_args = (bm, ci, bp.bfloat16(), cc.bfloat16())
    ops_g = 2 * n_live * bsz * bsz * cc.shape[1]
    bound_g = max(ops_g / PRODUCT_OPS_PER_S["bfloat16"],
                  (bp.numel() + cc.numel() + n_brow * bsz * cc.shape[1]) * 2
                  / HBM_BYTES_PER_S) * 1e3
    log(f"[f] spmm_bsr at (g) in bfloat16: ms "
        f"{event_ms(lambda: spmm_bsr(*bf_args)):.4f}, bound_ms "
        f"{bound_g:.4f} (bf16 rate)")
    del bf_args

    # coo_to_levels at (k)'s intermediate (the row of the kernels line) and
    # at (l); no single PyTorch call computes it, so it has no library time
    def coo_flat(out):
        return torch.cat([t.reshape(-1).long() for part in out for t in part])

    def coo_bytes(n, caps):
        """keys (8 B) and valid (1 B) read once for the whole call; each
        level's crd, seg and count written once."""
        total, parent = n * 9, 1
        for cap in caps:
            total += cap * 4 + (parent + 1) * 4 + 8
            parent = cap
        return total

    for tag, kw in (("k", seen["k"]["coo_to_levels"][-1]),
                    ("l", {"keys": keys_l, "valid": valid_l,
                           "dims_list": dims_l, "caps": caps_l}),
                    ("l2", {"keys": keys_l2, "valid": valid_l2,
                            "dims_list": dims_l2, "caps": caps_l2})):
        ck, cv, cd, cc = kw["keys"], kw["valid"], kw["dims_list"], kw["caps"]
        row = report(
            "coo_to_levels", per_phase[tag]["coo_to_levels"],
            lambda: coo_to_levels(ck, cv, cd, cc),
            lambda: coo_to_levels_plain(ck, cv, cd, cc), None,
            coo_bytes(ck.numel(), cc), 0,
            f"({tag}) N={ck.numel()} dims={list(cd)} caps={list(cc)}",
            flat=coo_flat, per_call=4)       # launches a call, N > 0
        if tag == "k":
            kernels.append(row)
    del keys_l, valid_l, keys_l2, valid_l2

    clear_compile_cache()
    summary = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
               "workloads": workloads, "launches_by_phase": per_phase,
               "launches_by_route": per_route,
               "kernels": measured}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(summary, indent=1))
    for label, w in workloads.items():
        log(f"[workload] {label}: warm {w['warm_ms']:.3f} ms")
    log(json.dumps({"kernels": [
        {k: v for k, v in r.items()
         if k not in ("shape", "bytes", "device_ms", "kernel_device_ms",
                      "ms_again")}
        for r in kernels]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
