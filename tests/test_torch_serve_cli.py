"""The port's ``launch/serve.py --sam`` on the CPU (``--device cpu``).

``main`` serves an expression, a program, an over-budget request
(out-of-core) and the same request with ``--workers 2`` (its tiles
distributed); the served results of the last dispatch equal numpy on the
operand sets ``serve_sam`` draws from its seed. The language-model mode
(no ``--sam``) serves on ``--device cpu`` and, with no GPU, refuses to
run without it; ``--devices 2 --device cpu`` serves on a CPU lane mesh
of two, ``--devices`` without a GPU raises, and a lane count that no
device subset divides is refused.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.autoschedule import random_operand
from repro_torch.launch.serve import main

MM = "X(i,j) = B(i,k) * C(k,j)"
# graph attention as an SDDMM -> SpMM program; serve's per-stage loop
# order (lhs, then contraction variables) materializes T
PROG = "T(i,j) = B(i,j) * C(i,f) * D(j,f); A(i,g) = T(i,j) * E(j,g)"
PROG_FMT = "B=cc,T=cc,C=dd,D=dd,E=dd,A=dd"


def _last_mm_sets(n, density, batch, reps, seed=0):
    """The operand sets ``serve_sam`` submits last: it draws B then C for
    each of ``batch * reps`` requests from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    sets = [(random_operand((n, n), density, rng),
             random_operand((n, n), density, rng))
            for _ in range(batch * reps)]
    return sets[-batch:]


def test_serve_expression():
    res = main(["--sam", MM, "--sam-order", "ikj", "--sam-formats",
                "B=cc,C=cc", "--sam-dims", "i=8,j=8,k=8", "--sam-density",
                "0.4", "--batch", "2", "--reps", "2", "--device", "cpu"])
    for got, (B, C) in zip(res, _last_mm_sets(8, 0.4, 2, 2)):
        assert np.array_equal(got.to_dense(), B @ C)


def test_serve_program(capsys):
    res = main(["--sam", PROG, "--sam-formats", PROG_FMT, "--sam-dims",
                "i=6,j=6,f=4,g=4", "--sam-density", "0.4", "--batch", "2",
                "--reps", "1", "--device", "cpu"])
    rng = np.random.default_rng(0)
    sets = [[random_operand(shape, 0.4, rng)
             for shape in ((6, 6), (6, 4), (6, 4), (6, 4))]
            for _ in range(2)]
    for got, (B, C, D, E) in zip(res, sets):
        T = B * (C @ D.T)
        assert set(got) == {"T", "A"}
        assert np.array_equal(got["T"].to_dense(), T)
        assert np.array_equal(got["A"].to_dense(), T @ E)
    out = capsys.readouterr().out
    assert "[serve-program] T: T -> A materialized" in out
    assert "[serve-program] 2 stages, outputs=A: 2 requests" in out


@pytest.mark.parametrize("workers", [0, 2])
def test_serve_out_of_core_and_distributed(capsys, workers):
    args = ["--sam", MM, "--sam-order", "ikj", "--sam-formats", "B=cc,C=dd",
            "--sam-dims", "i=24,j=24,k=24", "--sam-density", "0.1",
            "--mem-budget", "40KB", "--batch", "2", "--reps", "1",
            "--device", "cpu"]
    res = main(args + (["--workers", str(workers)] if workers else []))
    for got, (B, C) in zip(res, _last_mm_sets(24, 0.1, 2, 1)):
        assert np.array_equal(got.to_dense(), B @ C)
    out = capsys.readouterr().out
    assert "request routed OUT-OF-CORE -> tile=" in out
    assert ("DISTRIBUTED over 2 simulated worker(s)" in out) == bool(workers)
    assert "[serve-sam] 'X(i,j) = B(i,k) * C(k,j)': 2 requests" in out


def test_lm_mode_and_lanes_over_gpus_are_refused(capsys, monkeypatch):
    seqs = main(["--arch", "qwen3-0.6b", "--reduced", "--batch", "2",
                 "--prompt-len", "8", "--gen", "4", "--device", "cpu"])
    assert seqs.shape == (2, 12) and seqs.dtype == torch.int32
    assert "[serve] qwen3-0.6b: batch=2 prompt=8 gen=4 on cpu" in \
        capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--arch", "qwen3-0.6b", "--reduced"])
    # lanes over several devices: without a GPU and without --device cpu
    # the card's lane mesh raises; with --device cpu, --devices 2 is a CPU
    # lane mesh of two (test_torch_lanes_mesh.py holds its results), and a
    # mesh that no device subset divides is refused
    monkeypatch.setenv("SAM_LANE_DEVICES", "1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--sam", MM, "--split", "k=4", "--devices", "2"])
    res = main(["--sam", MM, "--split", "k=4", "--devices", "2",
                "--sam-dims", "i=16,j=16,k=16", "--batch", "2", "--reps",
                "1", "--device", "cpu"])
    assert "each request's lanes over a lane mesh of 2 devices (cpu, cpu)" \
        in capsys.readouterr().out and len(res) == 2
    with pytest.raises(SystemExit, match="no >1-device mesh fits 3"):
        main(["--sam", MM, "--split", "k=3", "--devices", "2",
              "--device", "cpu"])
