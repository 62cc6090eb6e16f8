"""The port's launch tools and examples, on the CPU.

* (a) ``roofline.probe``'s pure parts (``probe_configs``,
  ``layer_counts``, ``solve_and_extrapolate``'s extrapolated metrics)
  equal the reference's for every registered configuration, on
  synthetic probe records.
* (b) For a reduced configuration of each family, the probes'
  extrapolation equals the dry-run's direct count at full depth: FLOPs
  and bytes both exactly (every op's bytes grow linearly with depth).
* (c) The counted FLOPs of a dense forward equal the analytic sum of
  2·m·n·k over its products; a train step counts 3x the forward with
  remat "none", and with "full" one more forward of the checkpointed
  layers (not of the unembedding) but their last product, which torch's
  checkpoint does not recompute.
* (d) Per-device argument bytes equal the sum of each leaf's bytes over
  its shard factor, on the (16, 16) and (2, 16, 16) meshes.
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
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import input_specs
from repro_torch.models import model as M
from repro_torch.roofline import probe
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import make_train_step

ROOT = pathlib.Path(__file__).resolve().parent.parent

TINY = {"tiny_train": ShapeConfig("tiny_train", 16, 4, "train"),
        "tiny_decode": ShapeConfig("tiny_decode", 32, 32, "decode")}


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
    assert got["t_collective"] is None
    assert got["bottleneck"] in ("compute", "memory")


# -- (b) the probes' extrapolation equals the direct count --------------------

@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-v3-671b",
                                  "xlstm-125m", "zamba2-2.7b"])
@pytest.mark.parametrize("shape", ["tiny_train", "tiny_decode"])
def test_probe_extrapolation_equals_the_direct_count(arch, shape,
                                                     tiny_shapes):
    cfg = get_config(arch, reduced=True)
    got = probe.probe_cell(arch, shape, cfg_override=cfg)
    cost, meta = dryrun.lower_cell(arch, shape, cfg_override=cfg)
    n = meta["n_devices"]
    assert got["flops_per_device"] * n == cost["flops"]
    assert got["bytes_per_device"] * n == cost["bytes accessed"]
    assert cost["flops"] > 0 and cost["bytes accessed"] > 0


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
                                   cfg_override=cfg)
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
    assert all(m["roofline"]["t_collective"] is None for m in got)


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
