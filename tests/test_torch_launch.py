"""The port's launch tools and examples, on the CPU.

* (a) ``roofline.probe``'s pure parts (``probe_configs``,
  ``layer_counts``, ``solve_and_extrapolate``'s extrapolated metrics)
  equal the reference's for every registered configuration, on
  synthetic probe records.
* (b) For a reduced configuration of each family, the probes'
  extrapolation equals the dry-run's direct count at full depth: FLOPs,
  bytes and collective bytes exactly (every op's bytes and every layer's
  collectives grow linearly with depth).
* (c) The counted FLOPs of a dense forward equal the analytic sum of
  2·m·n·k over its products; a train step counts 3x the forward with
  remat "none", and with "full" one more forward of the checkpointed
  layers (not of the unembedding) but their last product, which torch's
  checkpoint does not recompute.
* (d) Per-device argument bytes equal the sum of each leaf's bytes over
  its shard factor, on the (16, 16) and (2, 16, 16) meshes.
* (g) The collective bytes a device of a train step of qwen3-0.6b's
  reduced config at widths the rules split (d_model 256, head dim 64,
  d_ff 256), placed on a (2, 2) mesh over a fake process group in this
  process, equal a closed form of the layout's collectives: FSDP's
  gathers and gradient reduce-scatters over the data axis, the
  row-parallel sums over the model axis (two a layer, attention's again
  in the recompute), the embedding's and the backward's sums, the label
  pick's logits and the norms' gradients; a ring model prices each.
* (e) ``dryrun --sam`` and ``roofline_sweep --sam`` records (the port's
  on the CPU) equal the reference's cell for cell.
* (f) ``dryrun --sam`` refuses to run without a GPU unless told
  ``--device cpu``.
* The examples import nothing of ``repro``, ``benchmarks`` or ``jax``;
  three of them run with ``--device cpu`` (``torch_autotune.py`` takes
  over 10 s on the CPU and runs on the card only, in ``chip_smoke.py``).

The dry-run cells here use small shapes added to ``SHAPES`` for the
test; the full-size cells are the CLI's (``--all``) and
``chip_smoke.py``'s.
"""
import dataclasses
import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import SHAPES, ShapeConfig, get_config, list_archs
from repro_torch.distributed import sharding
from repro_torch.launch import dryrun, roofline_sweep
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.launch.specs import input_specs
from repro_torch.models import model as M
from repro_torch.roofline import probe
from repro_torch.roofline.analysis import NIC_BW, NVLINK_BW, analyze_cell
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import make_train_step

ROOT = pathlib.Path(__file__).resolve().parent.parent

TINY = {"tiny_train": ShapeConfig("tiny_train", 16, 4, "train"),
        "tiny_decode": ShapeConfig("tiny_decode", 32, 32, "decode")}


def _stand_in(sizes):
    """A (data, model) mesh of ``sizes`` over meta devices."""
    devs = np.empty(int(np.prod(sizes)), dtype=object)
    devs[:] = [torch.device("meta")] * devs.size
    return Mesh(devs.reshape(sizes), ("data", "model"))


@pytest.fixture
def tiny_shapes(monkeypatch):
    for name, shape in TINY.items():
        monkeypatch.setitem(SHAPES, name, shape)


# -- (a) the pure parts against the reference -------------------------------

@pytest.mark.parametrize("arch", list_archs())
def test_probe_pure_parts_equal_the_reference(arch):
    pytest.importorskip("jax")
    from repro.configs import get_config as ref_config
    from repro.roofline import probe as rprobe

    cfg, rcfg = get_config(arch), ref_config(arch)
    mine, theirs = probe.probe_configs(cfg), rprobe.probe_configs(rcfg)
    assert [c for c, _ in mine] == [c for c, _ in theirs]
    for (_, p), (_, rp) in zip(mine, theirs):
        assert (p.n_layers, p.first_dense_layers, p.slstm_layers,
                p.unroll_scan) == (rp.n_layers, rp.first_dense_layers,
                                   rp.slstm_layers, rp.unroll_scan)
    assert probe.layer_counts(cfg) == rprobe.layer_counts(rcfg)

    rng = np.random.default_rng(len(arch))
    records = [(c, {m: float(rng.integers(1, 2 ** 40)) for m in
                    ("flops_per_device", "bytes_per_device",
                     "collective_bytes_per_device")}) for c, _ in mine]
    got = probe.solve_and_extrapolate(records, probe.layer_counts(cfg))
    want = rprobe.solve_and_extrapolate(records, rprobe.layer_counts(rcfg))
    keys = [k for k in want if k.startswith(probe.METRICS)]
    assert len(keys) >= 6
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    # the collective term's seconds extrapolate as its bytes do (each
    # collective priced at its group's rate); here a record's seconds are
    # its bytes at one rate
    rate = 450e9
    timed = [(c, dict(r, t_collective=r["collective_bytes_per_device"]
                      / rate)) for c, r in records]
    got = probe.solve_and_extrapolate(timed, probe.layer_counts(cfg))
    assert got["t_collective"] == pytest.approx(
        want["collective_bytes_per_device"] / rate, rel=1e-12)
    assert got["bottleneck"] == max(
        ("compute", "memory", "collective"),
        key=lambda k: got[f"t_{k}"])


# -- (b) the probes' extrapolation equals the direct count --------------------

@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-v3-671b",
                                  "xlstm-125m", "zamba2-2.7b"])
@pytest.mark.parametrize("shape", ["tiny_train", "tiny_decode"])
def test_probe_extrapolation_equals_the_direct_count(arch, shape,
                                                     tiny_shapes):
    cfg = get_config(arch, reduced=True)
    # placed on a (2, 2) mesh, whose data axis divides the tiny batches;
    # a placed run costs seconds of DTensor dispatch on the CPU, so the
    # collectives are held for qwen3-0.6b and xlstm-125m (a stack of two
    # layer types, whose train step runs its gates per shard: DTensor has
    # no rule for the backward of their log-sigmoid)
    mesh = _stand_in((2, 2))
    placed = arch in ("qwen3-0.6b", "xlstm-125m")
    got = probe.probe_cell(arch, shape, cfg_override=cfg, mesh=mesh,
                           collectives=placed)
    cost, meta = dryrun.lower_cell(arch, shape, cfg_override=cfg, mesh=mesh,
                                   collectives=placed)
    n = meta["n_devices"]
    assert got["flops_per_device"] * n == cost["flops"]
    assert got["bytes_per_device"] * n == cost["bytes accessed"]
    assert cost["flops"] > 0 and cost["bytes accessed"] > 0
    direct = analyze_cell(cost, meta)
    if not placed:
        assert got["t_collective"] is None
        return
    assert direct["collective_bytes_per_device"] > 0
    assert got["collective_bytes_per_device"] == pytest.approx(
        direct["collective_bytes_per_device"], rel=1e-9)
    assert got["t_collective"] == pytest.approx(direct["t_collective"],
                                                rel=1e-9)


# -- (c) counted FLOPs against the analytic sum --------------------------------

def _dense_forward_flops(cfg, b, s):
    d, hd, f, v = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff, cfg.vocab
    q, kv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    layer = (2 * b * s * d * q + 2 * 2 * b * s * d * kv    # q, k, v
             + 2 * 2 * b * cfg.n_heads * s * s * hd        # scores, values
             + 2 * b * s * q * d                           # output
             + 3 * 2 * b * s * d * f)                      # gate, up, down
    head = 2 * b * s * d * v
    return cfg.n_layers * layer, head


def test_counted_flops_equal_the_analytic_products():
    cfg = get_config("qwen3-0.6b", reduced=True)
    shape = TINY["tiny_train"]
    b, s = shape.global_batch, shape.seq_len
    specs = input_specs(cfg, shape, AdamWConfig())
    layers, head = _dense_forward_flops(cfg, b, s)

    _, fwd = dryrun.count_step(lambda p, x: M.forward(cfg, p, x)[0],
                               specs["params"], specs["batch"])
    assert fwd["flops"] == layers + head
    steps = {}
    for remat in ("none", "full"):
        step = make_train_step(cfg, AdamWConfig(), remat=remat)
        _, steps[remat] = dryrun.count_step(
            step, specs["params"], specs["opt_state"], specs["batch"])
    assert steps["none"]["flops"] == 3 * fwd["flops"]
    # "full" recomputes each checkpointed layer in the backward pass, but
    # torch's non-reentrant checkpoint stops a recompute once it holds
    # every tensor the backward needs: a layer's last product (the MLP's
    # down projection), whose output the backward does not need, is not
    # run again
    down = cfg.n_layers * 2 * b * s * cfg.d_ff * cfg.d_model
    assert steps["full"]["flops"] == 3 * fwd["flops"] + layers - down


def test_byte_counter_counts_inputs_and_outputs_but_views():
    a = torch.empty((8, 16), device="meta")
    b = torch.empty((16, 4), dtype=torch.bfloat16, device="meta")
    out, cost = dryrun.count_step(
        lambda x, y: (x.T.contiguous() @ x, x.to(torch.bfloat16) @ y), a, b)
    # x.T is a view (nothing); contiguous copies 512 B in and out; x.T @ x
    # reads 2 x 512 and writes 16x16 floats; the cast reads 512, writes
    # 256; the bf16 product reads 256 + 128 and writes 64
    assert cost["bytes accessed"] == (2 * 512 + 2 * 512 + 1024
                                      + 512 + 256 + 256 + 128 + 64)
    assert cost["flops"] == 2 * 16 * 8 * 16 + 2 * 8 * 16 * 4


# -- (d) per-device argument bytes ---------------------------------------------

def _leaves_with_paths(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_paths(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_paths(v, path + (i,))
    else:
        yield "/".join(str(p) for p in path), tree


def _factor(spec, mesh):
    axes = [a for e in spec if e is not None
            for a in (e if isinstance(e, tuple) else (e,))]
    return int(np.prod([mesh.shape[a] for a in axes]))


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch,reduced,shape", [
    ("qwen3-0.6b", False, "tiny_decode"),
    ("deepseek-v3-671b", True, "tiny_train")])
def test_argument_bytes_are_leaf_bytes_over_the_shard_factor(
        arch, reduced, shape, multi_pod, tiny_shapes):
    cfg = get_config(arch, reduced=reduced)
    mesh = make_production_mesh(multi_pod=multi_pod)
    assert mesh.shape == ({"pod": 2, "data": 16, "model": 16} if multi_pod
                          else {"data": 16, "model": 16})
    _, meta = dryrun.lower_cell(arch, shape, multi_pod=multi_pod,
                                cfg_override=cfg, collectives=False)
    sc = SHAPES[shape]
    specs = input_specs(cfg, sc, AdamWConfig())
    want = 0
    for path, leaf in _leaves_with_paths(specs["params"]):
        want += (leaf.numel() * leaf.element_size()
                 // _factor(sharding.param_spec(path, leaf.shape, mesh),
                            mesh))
    if sc.kind == "train":
        for path, leaf in _leaves_with_paths(specs["opt_state"]):
            want += (leaf.numel() * leaf.element_size()
                     // _factor(sharding.param_spec(path, leaf.shape, mesh),
                                mesh))
    else:
        for path, leaf in _leaves_with_paths(specs["caches"]):
            want += (leaf.numel() * leaf.element_size()
                     // _factor(sharding.cache_spec(mesh, path, leaf.shape,
                                                    sc.global_batch > 1),
                                mesh))
    n_data = mesh.size // mesh.shape["model"]
    for leaf in specs["batch"].values():
        want += leaf.numel() * leaf.element_size() // n_data
    got = meta["mem_per_device"]
    assert got["argument_bytes"] == want
    assert got["temp_bytes"] is None and got["fits"]
    assert meta["n_devices"] == mesh.size


def test_placing_on_the_production_mesh_raises():
    # meta devices and no process group: placement says how to launch
    with pytest.raises(ValueError, match="torch.distributed.run"):
        sharding.place({"w": torch.zeros(2)}, make_production_mesh())


# -- (g) the collective term against a closed form ---------------------------

def _closed_form(cfg, b, s, m, d):
    """{op@axis: (calls, output bytes a device)} of a "dots" train step of
    a dense config whose projections, embedding and head the rules split
    over a model axis of ``m`` and FSDP over a data axis of ``d``."""
    D, F, V, L = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_layers
    hd = cfg.resolved_head_dim
    Q, K = cfg.n_heads * hd, cfg.n_kv_heads * hd
    p4, cb = 4, 2                      # float32 parameters, bf16 compute
    big = [D * Q, Q * D, D * F, D * F, F * D]     # wq wo w_gate w_up w_down
    kv = [D * K, D * K]                           # wk wv
    layer = sum(big + kv) * p4 // m    # one layer's leaves after the gather
    act = b // d * s * D               # one data shard's (B, S, D)
    return {
        # FSDP: each layer gathered for the forward and again for its
        # recompute, the embedding once; the gradients reduce-scattered
        "all-gather@data": (
            2 * L * 7 + 1 + 2,
            2 * L * layer + V * D * p4 // m
            + b * s * 4 + b * s * 4),   # + the token ids, the token losses
        "reduce-scatter@data": (L * 7 + 1,
                                (L * layer + V * D * p4 // m) // d),
        # the row-parallel sums in float32: two a layer forward, attention's
        # again in the recompute; the embedding's sum, and the backward's
        # sums at the column-parallel inputs (two a layer, the head's), in
        # the compute dtype
        "all-reduce@model": (
            3 * L + 1 + 2 * L + 1 + 2,
            3 * L * act * 4 + (1 + 2 * L + 1) * act * cb
            + 2 * L * hd * p4),         # + the q and k norms' gradients
        # the label pick's whole vocabulary rows
        "all-gather@model": (1, b // d * s * V * 4),
        # the norm scales' gradients: ln1 and ln2 a layer, ln_f; the q and
        # k norms (stacked)
        "all-reduce@data": (2 * L + 1 + 2,
                            (2 * L + 1) * D * p4 + 2 * L * hd * p4),
    }


def test_collective_bytes_equal_the_closed_form(tiny_shapes):
    cfg = dataclasses.replace(get_config("qwen3-0.6b", reduced=True),
                              d_model=256, head_dim=64, d_ff=256)
    shape = TINY["tiny_train"]
    m = d = 2
    _, meta = dryrun.lower_cell("qwen3-0.6b", "tiny_train",
                                cfg_override=cfg, mesh=_stand_in((d, m)))
    got = meta["collectives"]["by_axis"]
    # the gradient norm's and the metrics' partial sums: float32 scalars
    scalars = {k: v for k, v in got.items() if k.startswith("all-reduce")}
    want = _closed_form(cfg, shape.global_batch, shape.seq_len, m, d)
    for key, (calls, nbytes) in want.items():
        row = dict(got[key])
        if key in scalars:             # take the scalars out
            n4 = row["calls"] - calls
            assert 0 < n4 <= 8, (key, row)
            row["calls"] -= n4
            row["bytes"] -= 4 * n4
        assert (row["calls"], row["bytes"]) == (calls, nbytes), key
    assert got.keys() == want.keys()
    wire = sum(dryrun.wire_bytes(key.split("@")[0], row["bytes"], 2)
               for key, row in got.items())
    assert meta["collectives"]["bytes"] == pytest.approx(wire, rel=1e-12)
    # four devices of one node: every group at NVLink's rate
    r = analyze_cell({"flops": 1, "bytes accessed": 1}, meta)
    assert r["t_collective"] == pytest.approx(wire / NVLINK_BW, rel=1e-12)


# -- (e) the --sam records against the reference's -----------------------------

SAM_ARGS = ["--sam", "x(i) = B(i,j)", "--sam-dims", "i=12,j=10",
            "--sam-density", "0.3"]


@pytest.fixture
def reference_launch(monkeypatch):
    """The reference's launch modules, imported after JAX's backend is
    up (their import rewrites ``XLA_FLAGS``, restored here)."""
    jax = pytest.importorskip("jax")
    jax.devices()
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    from repro.launch import dryrun as rdryrun
    from repro.launch import roofline_sweep as rsweep
    return rdryrun, rsweep


def test_sam_dryrun_equals_the_reference(reference_launch, tmp_path):
    rdryrun, _ = reference_launch
    rdryrun.main(SAM_ARGS + ["--json", str(tmp_path / "ref.json")])
    got = dryrun.main(SAM_ARGS + ["--device", "cpu",
                                  "--json", str(tmp_path / "port.json")])
    want = json.loads((tmp_path / "ref.json").read_text())
    assert got == json.loads((tmp_path / "port.json").read_text())
    assert 2 <= len(want) <= 6
    fields = ("expr", "formats", "engine_nnz", "cycles")
    assert ([{k: c[k] for k in fields} for c in got]
            == [{k: c[k] for k in fields} for c in want])
    assert all(c["equals_oracle"] for c in got)


def test_sam_sweep_equals_the_reference(reference_launch, tmp_path):
    _, rsweep = reference_launch
    args = ["--sam", "X(i,j) = B(i,j) * C(i,j)", "--sam-dims", "i=8,j=8",
            "--sam-density", "0.25", "--top-k", "3"]
    rsweep.main(args + ["--json", str(tmp_path / "ref.json")])
    got = roofline_sweep.main(args + ["--json", str(tmp_path / "port.json")])
    want = json.loads((tmp_path / "ref.json").read_text())
    fields = ("expr", "schedule", "formats", "hw", "cycles")
    assert len(want) >= 6
    assert ([{k: c[k] for k in fields} for c in got]
            == [{k: c[k] for k in fields} for c in want])


# -- (f) no GPU, no fallback ------------------------------------------------

def test_sam_dryrun_refuses_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU refusal is not reachable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(SAM_ARGS)


def test_lm_dryrun_cli_runs_without_gpu(tiny_shapes, capsys):
    """The LM cells need no device: the CLI's own loop over a small cell
    of qwen3-0.6b at its full width, on both meshes."""
    got = dryrun.main(["--arch", "qwen3-0.6b", "--shape", "tiny_decode",
                       "--both-meshes"])
    out = capsys.readouterr().out
    assert "of the H100's 80 GB" in out and "bottleneck=" in out
    assert [m["n_devices"] for m in got] == [256, 512]
    assert got[0]["flops"] == got[1]["flops"] > 0
    # the collective term, placed on each mesh: the (16, 16) mesh's model
    # groups span two 8-GPU nodes, so every group moves at the NIC's rate
    for m in got:
        r = m["roofline"]
        assert r["collective_bytes_per_device"] > 0
        assert r["t_collective"] == pytest.approx(
            r["collective_bytes_per_device"] / NIC_BW, rel=1e-9)
        assert f"collective={r['t_collective']:.3e}s" in out


# -- the examples ----------------------------------------------------------------

EXAMPLES = ["torch_quickstart.py", "torch_spmm_gustavson.py",
            "torch_serve_batch.py", "torch_autotune.py"]
_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|repro|benchmarks)\b"
                     r"(?!_)", re.M)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_imports_nothing_of_the_reference(name):
    text = (ROOT / "examples" / name).read_text()
    assert not _IMPORT.findall(text)
    assert "--device" in text


@pytest.mark.parametrize("name", EXAMPLES[:3])
def test_example_runs_on_the_cpu(name):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, str(ROOT / "examples" / name),
                          "--device", "cpu"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "OK" in out.stdout.splitlines()[-1]
