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
            "repro_torch.kernels.coo_levels"} <= set(mods)
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
    from repro_torch.kernels import ops as kops

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
    }


@pytest.mark.parametrize("entry", ["compile_expr", "compile_expr_bsr",
                                   "CompiledExpr", "execute_expr",
                                   "execute_graph", "compile_program",
                                   "sam_primitive", "accumulate_coo"])
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
