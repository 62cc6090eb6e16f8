"""The CUDA kernels and the engine on the card (skipped without a GPU).

Each kernel's wrapper on CUDA tensors must equal its plain PyTorch version
on the same inputs, exactly (integer-valued data: any atomic order is
exact), and must count one launch. The engine on CUDA must return the
same FiberTree as the engine on the CPU. This file needs no JAX, so it
runs on a GPU machine as it is:

    python -m pytest -q tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.schedule import Format, Schedule
from repro_torch.core.torch_backend import CompiledExpr
from repro_torch.kernels import ops as kops
from repro_torch.kernels.fused_stream import (fused_imr_workspace,
                                              fused_imr_workspace_plain)
from repro_torch.kernels.scatter_workspace import (scatter_workspace,
                                                   scatter_workspace_plain)
from repro_torch.kernels.segment_reduce import (segment_reduce,
                                                segment_reduce_plain)

PAD_KEY = torch.iinfo(torch.int64).max


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("mul_pair", [False, True])
def test_scatter_workspace_equals_plain(cuda, mul_pair):
    g = torch.Generator().manual_seed(1)
    n, slots = 100_000, 5000
    ids = torch.randint(0, slots + 1, (n,), generator=g, dtype=torch.int32)
    cols = torch.randint(-4, 5, (n, 3 if mul_pair else 2), generator=g
                         ).float()
    if mul_pair:
        cols[::7, 0] = float("nan")            # garbage at masked rows
        cols[::7, 2] = 0.0
    before = scatter_workspace.launches
    got = scatter_workspace(ids.to(cuda), cols.to(cuda), num_slots=slots,
                            mul_pair=mul_pair)
    assert scatter_workspace.launches == before + 1
    want = scatter_workspace_plain(ids, cols, num_slots=slots,
                                   mul_pair=mul_pair)
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("d,dtype", [(1, torch.float32), (3, torch.float32),
                                     (1, torch.float64), (2, torch.float16)])
@pytest.mark.parametrize("ids_sorted", [False, True])
def test_segment_reduce_equals_plain(cuda, d, dtype, ids_sorted):
    g = torch.Generator().manual_seed(2)
    n, s = 50_000, 777
    ids = torch.randint(0, s + 1, (n,), generator=g, dtype=torch.int32)
    if ids_sorted:      # long runs of one id, as the sort-merge produces
        ids = torch.sort(ids).values
        ids[-5000:] = s                         # a padding run
    vals = torch.randint(-4, 5, (n, d), generator=g).to(dtype)
    before = segment_reduce.launches
    got = segment_reduce(vals.to(cuda), ids.to(cuda), num_segments=s)
    assert segment_reduce.launches == before + 1
    want = segment_reduce_plain(vals, ids, num_segments=s)
    assert got.dtype == dtype and torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_fused_imr_equals_plain(cuda):
    rng = np.random.default_rng(5)
    na, nb, slots = 20_000, 9_000, 4096
    a_key = np.full(na, PAD_KEY, np.int64)
    a_key[:15_000] = np.sort(rng.choice(60_000, 15_000, replace=False))
    b_key = np.full(nb, PAD_KEY, np.int64)
    b_key[:8_000] = np.sort(rng.choice(60_000, 8_000, replace=False))
    args = [torch.as_tensor(a_key),
            torch.as_tensor(rng.integers(-4, 5, na).astype(np.float32)),
            torch.as_tensor(rng.integers(0, slots, na)),
            torch.as_tensor(b_key),
            torch.as_tensor(np.where(np.arange(nb) < 8_000,
                                     rng.integers(-4, 5, nb), 0
                                     ).astype(np.float32))]
    before = fused_imr_workspace.launches
    got = fused_imr_workspace(*[x.to(cuda) for x in args], num_slots=slots)
    assert fused_imr_workspace.launches == before + 1
    want = fused_imr_workspace_plain(*args, num_slots=slots)
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("expr,order,fmts", [
    ("x(i) = B(i,j) * c(j)", "ij", {"B": "cc", "c": "c"}),
    ("X(i,j) = B(i,k) * C(k,j)", "ikj", {"B": "cc", "C": "cc"}),
    ("X(i,j) = B(i,j) + C(i,j) + D(i,j)", "ij",
     {"B": "cc", "C": "cc", "D": "cc"}),
    ("x = B(i,j) * C(i,j)", "ij", {"B": "cc", "C": "cc"})])
def test_engine_on_the_card_equals_the_cpu(cuda, expr, order, fmts):
    rng = np.random.default_rng(6)
    dims = {"i": 40, "j": 30, "k": 20}
    arrays = {}
    for name, acc in (("B", "ij" if "k" not in expr else "ik"),
                      ("C", "ij" if "k" not in expr else "kj"),
                      ("D", "ij"), ("c", "j")):
        shape = tuple(dims[v] for v in acc)
        arrays[name] = ((rng.random(shape) < 0.3)
                        * rng.integers(1, 9, shape)).astype(float)
    sch = Schedule(loop_order=tuple(order))
    kops.reset_launch_counts()
    got = CompiledExpr(expr, Format(fmts), sch, dims)(arrays)
    if not expr.startswith("x ="):       # a scalar result reduces n=0 only
        assert sum(kops.launch_counts().values()) > 0
    want = CompiledExpr(expr, Format(fmts), sch, dims, device="cpu")(arrays)
    np.testing.assert_array_equal(got.to_dense(), want.to_dense())
