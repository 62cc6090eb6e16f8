"""The PyTorch port stands alone: it never loads ``jax`` or ``repro``.

* Importing every ``repro_torch`` module and ``chip_smoke`` in a fresh
  interpreter leaves ``jax`` and ``repro`` out of ``sys.modules``.
* A source scan finds no ``jax``/``repro`` import in the port.
* Entry points run on CUDA unless the caller asks for the CPU: with no
  GPU and no explicit device they raise instead of carrying on.
* ``chip_smoke.py`` exits non-zero and prints no result without a GPU,
  and also when it stands alone in a directory.
"""
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"


def _port_modules():
    mods = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(ROOT / "src").with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_importing_the_port_loads_neither_jax_nor_repro():
    mods = _port_modules()
    assert {"repro_torch.core.torch_backend", "repro_torch.kernels.ops",
            "repro_torch.core.bsr_bridge", "repro_torch.kernels.spmm_bsr",
            "repro_torch.kernels.sddmm_bsr",
            "repro_torch.kernels.bsr_attention", "repro_torch.core.simulator",
            "repro_torch.core.program",
            "repro_torch.kernels.coo_levels", "repro_torch.core.serving",
            "repro_torch.core.dist_exec", "repro_torch.launch.serve",
            "repro_torch.launch.mesh", "repro_torch.distributed.elastic",
            "repro_torch.distributed.fault_tolerance",
            "repro_torch.distributed.sharding", "repro_torch.configs",
            "repro_torch.configs.base", "repro_torch.models.common",
            "repro_torch.models.moe", "repro_torch.models.moe_blocks",
            "repro_torch.models.pruned_transformer",
            "repro_torch.models.model", "repro_torch.train.optimizer",
            "repro_torch.train.train_step", "repro_torch.data.pipeline",
            "repro_torch.distributed.checkpoint", "repro_torch.launch.specs",
            "repro_torch.launch.train", "repro_torch.launch.dryrun",
            "repro_torch.launch.roofline_sweep",
            "repro_torch.roofline.probe",
            "repro_torch.roofline.analysis"} <= set(mods)
    code = (
        "import importlib, json, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m == 'repro'\n"
        "             or m.startswith(('jax.', 'repro.', 'jaxlib')))\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|repro)\b(?!_)",
                     re.M)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]))
def test_source_imports_no_jax_or_repro(path):
    text = (ROOT / path).read_text()
    assert not _IMPORT.findall(text), f"{path} imports jax or repro"


_C_ENTRY = re.compile(r'extern "C" int (\w+)\(([^)]*)\)')


def _c_entries():
    text = "".join(p.read_text()
                   for p in sorted((PORT / "kernels" / "csrc").glob("*.cu")))
    return {m.group(1): len([a for a in m.group(2).split(",") if a.strip()])
            for m in _C_ENTRY.finditer(text)}


@pytest.mark.parametrize("name", sorted(_c_entries()))
def test_ctypes_signature_matches_the_c_entry(name):
    """Every C entry of the kernel library has a ctypes signature with one
    type a parameter, the stream included. An argument past the declared
    types is passed as a C int, so a missing pointer type leaves the upper
    half of a stack-passed stream handle undefined (``sam_coo_levels``
    crashed that way when launched from a worker thread)."""
    from repro_torch.kernels import _build

    assert len(_build._SIGNATURES[name]) == _c_entries()[name]


def _no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU refusal is not reachable")


def _entry_calls():
    from repro_torch.core import coord_ops as co
    from repro_torch.core.custard import lower
    from repro_torch.core.schedule import Format, Schedule
    from repro_torch.core.torch_backend import (CompiledExpr, compile_expr,
                                                compile_program, execute_expr,
                                                execute_graph)
    from repro_torch.core.dist_exec import dist_compile
    from repro_torch.core.serving import SamServer
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.mesh import make_host_mesh, make_local_mesh
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.configs.qwen3_0_6b import REDUCED
    from repro_torch.models.common import params_from_numpy
    from repro_torch.models.moe_blocks import MoEBlock, compile_moe_block
    from repro_torch.models.pruned_transformer import PrunedTransformer
    from repro_torch.configs import ShapeConfig
    from repro_torch.data.pipeline import batch_for_step
    from repro_torch.launch.train import main as train_main

    fmt = Format({"B": "cc", "c": "c"})
    sch = Schedule(loop_order=("i", "j"))
    dims = {"i": 2, "j": 3}
    arrays = {"B": np.eye(2, 3), "c": np.ones(3)}
    low = lower("x(i) = B(i,j) * c(j)", fmt, sch, dims)
    return {
        "compile_expr": lambda: compile_expr("x(i) = B(i,j) * c(j)", fmt,
                                             sch, dims),
        "compile_expr_bsr": lambda: compile_expr(
            "x(i,k) = B(i,j) * C(j,k)", Format({"B": "bb"}),
            Schedule(loop_order=("i", "j", "k")), {"i": 2, "j": 2, "k": 2}),
        "CompiledExpr": lambda: CompiledExpr("x(i) = B(i,j) * c(j)", fmt,
                                             sch, dims),
        "execute_expr": lambda: execute_expr("x(i) = B(i,j) * c(j)", fmt,
                                             sch, arrays, dims),
        "execute_graph": lambda: execute_graph(
            low.graph, low.build_inputs(arrays), low.dims, low.result_vars),
        "compile_program": lambda: compile_program(
            "T(i,k) = B(i,j) * C(j,k); x(i) = T(i,k) * d(k)", fmt,
            {"T": Schedule(loop_order=("i", "j", "k")),
             "x": Schedule(loop_order=("i", "k"))},
            {"i": 2, "j": 2, "k": 2}),
        "sam_primitive": lambda: kops.sam_primitive("mul_reduce"),
        "accumulate_coo": lambda: co.accumulate_coo(
            np.zeros(0, np.int64), np.zeros(0, np.float32),
            np.arange(3), np.ones(3)),
        "SamServer": lambda: SamServer(sync=True),
        "dist_compile": lambda: dist_compile(
            "x(i) = B(i,j) * c(j)", fmt,
            Schedule(loop_order=("i", "j"), tile={"j": 3}), dims),
        "make_host_mesh": lambda: make_host_mesh(),
        "make_local_mesh": lambda: make_local_mesh(),
        "serve": lambda: serve_main(["--sam", "x(i) = B(i,j) * c(j)",
                                     "--sam-dims", "i=2,j=3"]),
        "compile_moe_block": lambda: compile_moe_block(2, 2, 4, 3, 3),
        "MoEBlock": lambda: MoEBlock(2, 2, 4, 3, 3),
        "PrunedTransformer": lambda: PrunedTransformer(REDUCED, seq_len=8,
                                                       block=4),
        "params_from_numpy": lambda: params_from_numpy({"w": np.ones(2)}),
        "batch_for_step": lambda: batch_for_step(
            REDUCED, ShapeConfig("t", 8, 2, "train"), 0),
        "train": lambda: train_main(["--arch", "qwen3-0.6b", "--reduced",
                                     "--steps", "1"]),
    }


@pytest.mark.parametrize("entry", ["compile_expr", "compile_expr_bsr",
                                   "CompiledExpr", "execute_expr",
                                   "execute_graph", "compile_program",
                                   "sam_primitive", "accumulate_coo",
                                   "SamServer", "dist_compile",
                                   "make_host_mesh", "make_local_mesh",
                                   "serve",
                                   "compile_moe_block", "MoEBlock",
                                   "PrunedTransformer", "params_from_numpy",
                                   "batch_for_step", "train"])
def test_entry_points_refuse_without_gpu(entry):
    _no_gpu()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_calls()[entry]()


def test_explicit_cpu_device_runs():
    from repro_torch.core.schedule import Format, Schedule
    from repro_torch.core.torch_backend import compile_expr

    eng = compile_expr("x(i) = B(i,j) * c(j)", Format({"B": "cc", "c": "c"}),
                       Schedule(loop_order=("i", "j")), {"i": 2, "j": 3},
                       device="cpu")
    got = eng({"B": np.eye(2, 3), "c": np.ones(3)}).to_dense()
    np.testing.assert_array_equal(got, [1.0, 1.0])
    assert eng.device == torch.device("cpu")


def _ok_line(stdout: str) -> bool:
    return any(line.startswith('{"ok"') for line in stdout.splitlines())


def test_chip_smoke_fails_without_gpu():
    _no_gpu()
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert not _ok_line(out.stdout)


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert not _ok_line(out.stdout)
