"""The CUDA kernels and the engine on the card (skipped without a GPU).

Each kernel's wrapper on CUDA tensors must equal its plain PyTorch version
on the same inputs, exactly on integer-valued data (any summation order is
exact there), and must count one launch. The block-sparse kernels are
also held at block sizes 1 to 128, in bfloat16, with ``causal``, with a
fully masked q block (zeros), and at extents that are not multiples of
128; attention on random data within a stated tolerance. The engines on
CUDA must return the same FiberTree as on the CPU, and under split lanes
or in a batch they must launch the reduce kernels. ``coo_to_levels`` must
equal its plain version bit for bit, under capacity overflow too, and a
fused program on the card must equal the same program on the CPU.
``spmm_bsr``, ``sddmm_bsr`` and ``bsr_flash_attention`` choose between a
tensor-core and a CUDA-core kernel by shape; each case checks which
route's counter advanced, and ``spmm_bsr`` and ``sddmm_bsr`` on
standard-normal float32 must stay within the per-element worst case of
3xTF32. ``coo_to_levels`` is also held at extents that are not powers of
two, with negative keys and invalid rows in the middle. A ``TiledExpr`` on the
card must return the CPU's FiberTree (its tile merge on ``scatter_workspace``
and on ``segment_reduce``), a budgeted tiled call must peak within its budget
and free every tile's tensors, and ``schedule="auto"`` must run on
the card. This file needs no JAX, so it runs on a GPU machine as it is:

    python -m pytest -q tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.bsr_bridge import BsrEngine
from repro_torch.core.schedule import Format, Schedule
from repro_torch.core.torch_backend import (CompiledExpr, compile_expr,
                                            compile_program)
from repro_torch.kernels import bsr_attention as attn_mod
from repro_torch.kernels import ops as kops
from repro_torch.kernels import sddmm_bsr as sddmm_mod
from repro_torch.kernels import spmm_bsr as spmm_mod
from repro_torch.kernels.bsr_attention import (bsr_flash_attention,
                                               bsr_flash_attention_plain)
from repro_torch.kernels.coo_levels import coo_to_levels, coo_to_levels_plain
from repro_torch.kernels.fused_stream import (fused_imr_workspace,
                                              fused_imr_workspace_plain)
from repro_torch.kernels.scatter_workspace import (scatter_workspace,
                                                   scatter_workspace_plain)
from repro_torch.kernels.sddmm_bsr import sddmm_bsr, sddmm_bsr_plain
from repro_torch.kernels.segment_reduce import (segment_reduce,
                                                segment_reduce_mul,
                                                segment_reduce_mul_plain,
                                                segment_reduce_plain)
from repro_torch.kernels.spmm_bsr import spmm_bsr, spmm_bsr_plain

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
@pytest.mark.parametrize("d,dtype", [(1, torch.float32), (2, torch.float32),
                                     (3, torch.float32), (1, torch.float64),
                                     (2, torch.float64), (2, torch.float16)])
@pytest.mark.parametrize("ids_kind", ["random", "sorted", "runs", "wide"])
@pytest.mark.parametrize("n", [50_000, 300_000, (1 << 22) + 5])
def test_segment_reduce_equals_plain(cuda, d, dtype, ids_kind, n):
    """Under 2^18 rows the kernel runs a row a thread; above, tiles of 1024
    rows (4096 from 2^22). Random ids take the row path (warp
    aggregation where a run shows); sorted ids and long runs of one id the
    shared-memory tiles; ids spread over a million segments with runs
    among them, both."""
    g = torch.Generator().manual_seed(2)
    s = 777
    if ids_kind == "wide":
        s = 1 << 20
    ids = torch.randint(0, s + 1, (n,), generator=g, dtype=torch.int32)
    if ids_kind != "random":   # sorted runs, as the sort-merge produces
        ids = torch.sort(ids).values
        ids[-5000:] = s                         # a padding run
    if ids_kind in ("runs", "wide"):
        ids[1000:30_000] = 5                    # one hot segment
        ids[30_000:30_100] = -3                 # dropped in the middle
        ids[n // 2:n // 2 + 9000] = s - 1       # a run across tiles
    vals = torch.randint(-4, 5, (n, d), generator=g).to(dtype)
    before = segment_reduce.launches
    got = segment_reduce(vals.to(cuda), ids.to(cuda), num_segments=s)
    assert segment_reduce.launches == before + 1
    want = segment_reduce_plain(vals, ids, num_segments=s)
    assert got.dtype == dtype and torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("with_b", [True, False])
@pytest.mark.parametrize("keys_kind", ["random", "blocks"])
@pytest.mark.parametrize("n", [120_000, 300_000, (1 << 22) + 3])
def test_segment_reduce_mul_equals_plain(cuda, dtype, with_b, keys_kind, n):
    """The [a*b, 1] mode on int64 keys with a mask: garbage (inf, nan) at
    masked rows and keys outside [0, S) never reach the sums. "blocks"
    keys are runs of contiguous keys repeated, as a product stream's;
    the lengths take the row path, 1024-row and 4096-row tiles."""
    g = torch.Generator().manual_seed(3)
    s = 3000
    if keys_kind == "random":
        keys = torch.randint(-5, s + 40, (n,), generator=g)
    else:
        keys = (torch.arange(n) % 1024 + 1024 * (torch.arange(n) // 8192)
                ).to(torch.int64) % (s + 50)
        keys[60_000:61_000] = 17                # one hot key
    valid = torch.rand(n, generator=g) < 0.8
    a = torch.randint(-4, 5, (n,), generator=g).to(dtype)
    b = torch.randint(-4, 5, (n,), generator=g).to(dtype)
    a[~valid] = float("nan")
    b[~valid] = float("inf")
    bb = b if with_b else None
    before = segment_reduce.launches
    got = segment_reduce_mul(keys.to(cuda), a.to(cuda),
                             None if bb is None else bb.to(cuda),
                             valid.to(cuda), num_segments=s)
    assert segment_reduce.launches == before + 1
    want = segment_reduce_mul_plain(keys, a, bb, valid, num_segments=s)
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


def _imr_case(kind, dtype=np.float32):
    """Streams for ``fused_imr_workspace`` (CPU tensors) exercising one
    corner of the tiled merge: 2048 elements of *a* a tile, a window of up
    to 1024 *b* keys staged in shared memory."""
    rng = np.random.default_rng(len(kind))
    na, nb, slots, space, offset = 20_000, 9_000, 4096, 60_000, 0
    if kind == "ragged":             # NA and NB not multiples of the tile
        na, nb = 3 * 2048 + 5, 1037
    if kind == "beyond int32":
        offset = 1 << 40
    if kind == "long window":        # sparse a over dense b: windows of
        space = 400_000              # ~40k keys, searched in place
        nb = 300_000
    a_key = np.sort(rng.choice(space, na, replace=False)) + offset
    if kind == "long window":
        a_key = np.sort(rng.choice(space, 2500, replace=False)) + offset
        na = a_key.size
    a_key[rng.random(na) < 0.25] = PAD_KEY      # padding anywhere in a
    if kind == "padding tiles":      # whole tiles of padding, and a tile
        a_key[2048:3 * 2048] = PAD_KEY          # with one valid key
        a_key[4 * 2048:5 * 2048] = PAD_KEY
        a_key[4 * 2048 + 700] = np.int64(space // 2)
    if kind == "a shuffled":         # the kernel assumes no order of a
        rng.shuffle(a_key)
    n_valid = 0 if kind == "b all padding" else nb - 37
    b_key = np.full(nb, PAD_KEY, np.int64)
    b_key[:n_valid] = np.sort(rng.choice(space, n_valid, replace=False)
                              ) + offset
    b_vals = np.where(np.arange(nb) < n_valid, rng.integers(-4, 5, nb), 0)
    return [torch.as_tensor(a_key.astype(np.int64)),
            torch.as_tensor(rng.integers(-4, 5, na).astype(dtype)),
            torch.as_tensor(rng.integers(0, slots, na)),
            torch.as_tensor(b_key),
            torch.as_tensor(b_vals.astype(dtype))], slots


@pytest.mark.gpu
@pytest.mark.parametrize("kind,dtype", [
    ("padding anywhere", np.float32), ("padding tiles", np.float32),
    ("long window", np.float32), ("b all padding", np.float32),
    ("beyond int32", np.float32), ("ragged", np.float32),
    ("a shuffled", np.float32), ("padding anywhere", np.float64)])
def test_fused_imr_tiled_merge_equals_plain(cuda, kind, dtype):
    args, slots = _imr_case(kind, dtype)
    before = fused_imr_workspace.launches
    got = fused_imr_workspace(*[x.to(cuda) for x in args], num_slots=slots)
    assert fused_imr_workspace.launches == before + 1
    want = fused_imr_workspace_plain(*args, num_slots=slots)
    assert got.dtype == want.dtype and torch.equal(got.cpu(), want)
    if kind != "b all padding":
        assert want[:, 1].sum() > 0              # the case has hits


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


@pytest.mark.gpu
def test_lanes_and_batches_on_the_card_launch_the_reduce_kernels(cuda):
    rng = np.random.default_rng(9)
    dims = {"i": 40, "j": 30, "k": 20}
    expr, fmt = "X(i,j) = B(i,k) * C(k,j)", Format({"B": "cc", "C": "cc"})
    sets = [{"B": ((rng.random((40, 20)) < 0.3)
                   * rng.integers(1, 9, (40, 20))).astype(float),
             "C": ((rng.random((20, 30)) < 0.3)
                   * rng.integers(1, 9, (20, 30))).astype(float)}
            for _ in range(3)]
    lanes = Schedule(loop_order=("i", "k", "j"), split={"i": 4},
                     parallelize={"i": 4})
    kops.reset_launch_counts()
    got = CompiledExpr(expr, fmt, lanes, dims)(sets[0])
    counts = kops.launch_counts()
    assert counts["segment_reduce"] + counts["scatter_workspace"] > 0
    want = CompiledExpr(expr, fmt, lanes, dims, device="cpu")(sets[0])
    np.testing.assert_array_equal(got.to_dense(), want.to_dense())
    eng = CompiledExpr(expr, fmt, Schedule(loop_order=("i", "k", "j")), dims)
    kops.reset_launch_counts()
    outs = eng.execute_batch(sets)
    counts = kops.launch_counts()
    assert counts["segment_reduce"] + counts["scatter_workspace"] > 0
    for out, arrays in zip(outs, sets):
        np.testing.assert_array_equal(out.to_dense(),
                                      arrays["B"] @ arrays["C"])


# -- the block-sparse kernels -------------------------------------------------

def _ints(rng, shape, dtype):
    return torch.as_tensor(rng.integers(-3, 4, shape).astype(np.float32)
                           ).to(dtype)


def _spmm_case(bs, n, dtype, k_cut=0, seed=None, normal=False,
               keep_first=True):
    """(blk_map, col_idx, blocks, c) on the CPU: about 30% of the blocks
    kept (block (0, 0) always when keep_first), block row 1 all pad slots,
    C with K = n_bcol * bs - k_cut rows (a ragged last block column when
    k_cut > 0)."""
    rng = np.random.default_rng(bs + n + k_cut if seed is None else seed)
    n_brow, n_bcol = max(2, 256 // bs), max(3, 384 // bs)
    keep = rng.random((n_brow, n_bcol)) < 0.3
    keep[0, 0] |= keep_first
    keep[1] = False                             # a block row of pad slots
    rows, cols = np.nonzero(keep)
    bm, ci, bp = kops.bsr_from_block_coords(
        rows, cols, np.zeros((len(rows), bs, bs), np.float32), n_brow)
    k_dim = n_bcol * bs - k_cut
    if normal:
        blocks = torch.as_tensor(rng.standard_normal(bp.shape).astype(
            np.float32)).to(dtype)
        c = torch.as_tensor(rng.standard_normal((k_dim, n)).astype(
            np.float32)).to(dtype)
    else:
        blocks, c = _ints(rng, bp.shape, dtype), _ints(rng, (k_dim, n), dtype)
    blocks[-1] = 0                              # the appended zero block
    return [torch.as_tensor(bm), torch.as_tensor(ci), blocks, c]


def _check_spmm_equals_plain(cuda, args, bs, n, dtype):
    before = spmm_bsr.launches
    routes = dict(spmm_bsr.route_launches)
    got = spmm_bsr(*[a.to(cuda) for a in args])
    assert spmm_bsr.launches == before + 1
    way = spmm_mod.route(bs, n, dtype)
    assert spmm_bsr.route_launches[way] == routes[way] + 1
    want = spmm_bsr_plain(*args)
    assert got.dtype == dtype and torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("bs,n,dtype", [
    (1, 200, torch.float32), (8, 96, torch.float32),
    (64, 256, torch.float32), (128, 300, torch.float32),
    (128, 128, torch.bfloat16), (8, 40, torch.bfloat16)])
def test_spmm_bsr_equals_plain(cuda, bs, n, dtype):
    # (128, 300) and (128, 128) draw no block: every slot is a pad slot
    args = _spmm_case(bs, n, dtype, keep_first=False)
    _check_spmm_equals_plain(cuda, args, bs, n, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("bs,n,dtype,k_cut", [
    (4, 100, torch.float32, 3), (4, 104, torch.bfloat16, 1),
    (16, 200, torch.float32, 5), (16, 72, torch.bfloat16, 0),
    (64, 96, torch.bfloat16, 17), (64, 258, torch.float32, 0),
    (128, 302, torch.float32, 40), (128, 264, torch.float32, 100),
    (128, 136, torch.bfloat16, 9), (256, 264, torch.float32, 0),
    (256, 136, torch.bfloat16, 200), (256, 130, torch.float32, 7)])
def test_spmm_bsr_equals_plain_with_ragged_k(cuda, bs, n, dtype, k_cut):
    args = _spmm_case(bs, n, dtype, k_cut)
    _check_spmm_equals_plain(cuda, args, bs, n, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("bs,n,want", [(4, 128, "cuda_cores"),
                                       (128, 130, "cuda_cores"),
                                       (16, 128, "tensor_cores"),
                                       (128, 256, "tensor_cores")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spmm_bsr_takes_its_route_by_shape(cuda, bs, n, want, dtype):
    args = _spmm_case(bs, n, dtype)
    out = []
    way = _route_advanced(spmm_bsr, lambda: out.append(
        spmm_bsr(*[a.to(cuda) for a in args])))
    assert way == want == spmm_mod.route(bs, n, dtype)
    assert torch.equal(out[0].cpu(), spmm_bsr_plain(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("bs,n,k_cut", [(64, 200, 0), (128, 256, 0),
                                        (128, 132, 50), (256, 128, 0)])
def test_spmm_bsr_normal_data_within_the_3xtf32_bound(cuda, bs, n, k_cut):
    """Non-integer float32 runs 3xTF32 on the tensor cores: each element
    within (3 * 2^-22 + K * 2^-24) * sum_k |a_k c_k| of the float64
    product, K the row's live slots times bs."""
    bm, ci, bp, c = _spmm_case(bs, n, torch.float32, k_cut, seed=bs * n,
                               normal=True)
    out = []
    way = _route_advanced(spmm_bsr, lambda: out.append(spmm_bsr(
        bm.to(cuda), ci.to(cuda), bp.to(cuda), c.to(cuda))))
    assert way == "tensor_cores"
    dense = torch.zeros((bm.shape[0] * bs, -(-c.shape[0] // bs) * bs),
                        dtype=torch.float64)
    for r, s in zip(*np.nonzero((bm < bp.shape[0] - 1).numpy())):
        col = int(ci[r, s]) * bs
        dense[r * bs:(r + 1) * bs, col:col + bs] += bp[bm[r, s]].double()
    dense = dense[:, :c.shape[0]]
    exact = dense @ c.double()
    live = (bm < bp.shape[0] - 1).sum(1).double() * bs
    limit = ((3 * 2.0 ** -22 + live.repeat_interleave(bs)[:, None]
              * 2.0 ** -24) * (dense.abs() @ c.double().abs()))
    got = out[0].cpu().double()
    assert torch.isfinite(got).all()
    assert ((got - exact).abs() <= limit).all()


@pytest.mark.gpu
@pytest.mark.parametrize("bs,k,dtype", [
    (1, 40, torch.float32), (8, 72, torch.float32),
    (64, 128, torch.float32), (128, 200, torch.float32),
    (128, 64, torch.bfloat16), (8, 24, torch.bfloat16),
    (16, 96, torch.float32), (32, 40, torch.bfloat16),
    (64, 130, torch.float32)])
def test_sddmm_bsr_equals_plain(cuda, bs, k, dtype):
    rng = np.random.default_rng(bs + k)
    m_blk, n_blk = max(2, 384 // bs), max(3, 256 // bs)
    rows, cols = np.nonzero(rng.random((m_blk, n_blk)) < 0.4)
    args = [torch.as_tensor(rows.astype(np.int32)),
            torch.as_tensor(cols.astype(np.int32)),
            _ints(rng, (m_blk * bs, k), dtype),
            _ints(rng, (n_blk * bs, k), dtype)]
    before = sddmm_bsr.launches
    routes = dict(sddmm_bsr.route_launches)
    got = sddmm_bsr(*[a.to(cuda) for a in args], bs)
    assert sddmm_bsr.launches == before + 1
    way = sddmm_mod.route(bs, k, dtype)
    assert sddmm_bsr.route_launches[way] == routes[way] + 1
    want = sddmm_bsr_plain(*args, bs)
    assert got.dtype == dtype and torch.equal(got.cpu(), want)


def _route_advanced(fn, call):
    """The route whose counter ``call`` advanced by one (and no other)."""
    before = dict(fn.route_launches)
    call()
    moved = {k: fn.route_launches[k] - before[k] for k in before}
    assert sorted(moved.values()) == [0, 1], moved
    return max(moved, key=moved.get)


@pytest.mark.gpu
@pytest.mark.parametrize("bs,want", [(8, "cuda_cores"),
                                     (128, "tensor_cores")])
def test_sddmm_bsr_takes_its_route_by_block_size(cuda, bs, want):
    rng = np.random.default_rng(bs)
    rows, cols = np.nonzero(rng.random((3, 2)) < 0.7)
    args = [torch.as_tensor(rows.astype(np.int32)),
            torch.as_tensor(cols.astype(np.int32)),
            _ints(rng, (3 * bs, 128), torch.float32),
            _ints(rng, (2 * bs, 128), torch.float32)]
    out = []
    way = _route_advanced(sddmm_bsr, lambda: out.append(
        sddmm_bsr(*[a.to(cuda) for a in args], bs)))
    assert way == want == sddmm_mod.route(bs, 128, torch.float32)
    assert torch.equal(out[0].cpu(), sddmm_bsr_plain(*args, bs))


@pytest.mark.gpu
@pytest.mark.parametrize("bs", [64, 128])
@pytest.mark.parametrize("k", [128, 200])
def test_sddmm_bsr_normal_data_within_the_3xtf32_bound(cuda, bs, k):
    """Non-integer float32 runs 3xTF32 on the tensor cores: each element
    within (3 * 2^-22 + K * 2^-24) * sum_k |a_k b_k| of the float64
    product (a single TF32 pass fails this many times over)."""
    rng = np.random.default_rng(bs * k)
    m_blk, n_blk = 384 // bs, 256 // bs
    rows, cols = np.nonzero(rng.random((m_blk, n_blk)) < 0.6)
    a = rng.standard_normal((m_blk * bs, k)).astype(np.float32)
    b = rng.standard_normal((n_blk * bs, k)).astype(np.float32)
    out = []
    way = _route_advanced(sddmm_bsr, lambda: out.append(sddmm_bsr(
        torch.as_tensor(rows.astype(np.int32)).to(cuda),
        torch.as_tensor(cols.astype(np.int32)).to(cuda),
        torch.as_tensor(a).to(cuda), torch.as_tensor(b).to(cuda), bs)))
    assert way == "tensor_cores"
    a3 = a.astype(np.float64).reshape(-1, bs, k)[rows]
    b3 = b.astype(np.float64).reshape(-1, bs, k)[cols]
    exact = a3 @ b3.transpose(0, 2, 1)
    limit = ((3 * 2.0 ** -22 + k * 2.0 ** -24)
             * (np.abs(a3) @ np.abs(b3).transpose(0, 2, 1)))
    got = out[0].cpu().double().numpy()
    assert np.isfinite(got).all()
    assert (np.abs(got - exact) <= limit).all()


@pytest.mark.gpu
@pytest.mark.parametrize("bs,d,causal,dtype", [
    (1, 32, False, torch.float32), (8, 64, True, torch.float32),
    (64, 128, False, torch.float32), (128, 128, True, torch.float32),
    (128, 100, False, torch.float32), (64, 256, True, torch.float32),
    (128, 128, True, torch.bfloat16), (8, 64, False, torch.bfloat16),
    (16, 64, True, torch.float32), (32, 40, False, torch.bfloat16),
    (32, 72, True, torch.float32)])
def test_bsr_attention_equals_plain(cuda, bs, d, causal, dtype):
    rng = np.random.default_rng(bs + d)
    bh, n_blk = 2, max(4, 512 // bs)
    s = n_blk * bs
    kv_idx = kops.sliding_window_kv_idx(n_blk, n_blk, 3, causal=causal)
    kv_idx[2] = n_blk                           # a fully masked q block
    q, k, v = (torch.as_tensor(rng.standard_normal((bh, s, d)).astype(
        np.float32)).to(dtype) for _ in range(3))
    before = bsr_flash_attention.launches
    routes = dict(bsr_flash_attention.route_launches)
    got = bsr_flash_attention(q.to(cuda), k.to(cuda), v.to(cuda),
                              torch.as_tensor(kv_idx).to(cuda), bq=bs,
                              bkv=bs, causal=causal).cpu()
    assert bsr_flash_attention.launches == before + 1
    way = attn_mod.route(bs, bs, d)
    assert bsr_flash_attention.route_launches[way] == routes[way] + 1
    want = bsr_flash_attention_plain(q, k, v, torch.as_tensor(kv_idx),
                                     bq=bs, bkv=bs, causal=causal)
    assert got.dtype == dtype
    assert not got[:, 2 * bs:3 * bs].any()
    # float32: summation order only; bfloat16: one rounding of the output
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("bs,d,want", [(8, 64, "cuda_cores"),
                                       (128, 100, "cuda_cores"),
                                       (128, 128, "tensor_cores")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bsr_attention_takes_its_route_by_shape(cuda, bs, d, want, dtype):
    rng = np.random.default_rng(bs + d)
    n_blk = max(2, 256 // bs)
    s = n_blk * bs
    kv_idx = torch.as_tensor(kops.sliding_window_kv_idx(n_blk, n_blk, 2))
    q, k, v = (torch.as_tensor(rng.standard_normal((2, s, d)).astype(
        np.float32)).to(dtype) for _ in range(3))
    out = []
    way = _route_advanced(bsr_flash_attention, lambda: out.append(
        bsr_flash_attention(q.to(cuda), k.to(cuda), v.to(cuda),
                            kv_idx.to(cuda), bq=bs, bkv=bs)))
    assert way == want == attn_mod.route(bs, bs, d)
    want_out = bsr_flash_attention_plain(q, k, v, kv_idx, bq=bs, bkv=bs)
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(out[0].cpu().float(), want_out.float(),
                               rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["spmm", "sddmm", "attention"])
def test_bsr_engine_on_the_card_equals_the_cpu(cuda, kind):
    rng = np.random.default_rng(7)
    n, e = 256, 64
    keep = np.kron(np.tril(np.ones((4, 4))), np.ones((64, 64)))
    if kind == "spmm":
        expr, fmts = "x(i,k) = B(i,j) * C(j,k)", {"B": "bb", "x": "dd"}
        dims = {"i": n, "j": n, "k": 96}
        arrays = {"B": keep * rng.integers(-3, 4, (n, n)),
                  "C": rng.integers(-3, 4, (n, 96))}
    elif kind == "sddmm":
        expr = "X(i,j) = M(i,j) * A(i,k) * C(j,k)"
        fmts, dims = {"M": "bb", "X": "dd"}, {"i": n, "j": n, "k": e}
        arrays = {"M": keep * rng.integers(1, 4, (n, n)),
                  "A": rng.integers(-3, 4, (n, e)),
                  "C": rng.integers(-3, 4, (n, e))}
    else:
        expr = "O(i,d) = M(i,j) * Q(i,e) * K(j,e) * V(j,d)"
        fmts, dims = {"M": "bb", "O": "dd"}, {"i": n, "j": n, "e": e, "d": e}
        arrays = {"M": keep, **{t: rng.standard_normal((n, e))
                                for t in "QKV"}}
    arrays = {t: a.astype(np.float32) for t, a in arrays.items()}
    sch = Schedule(loop_order=tuple(dims))
    eng = compile_expr(expr, Format(fmts), sch, dims)
    assert isinstance(eng, BsrEngine) and eng.device.type == "cuda"
    kops.reset_launch_counts()
    got = eng(arrays).to_dense()
    name = {"spmm": "spmm_bsr", "sddmm": "sddmm_bsr",
            "attention": "bsr_attention"}[kind]
    assert kops.launch_counts()[name] == 1
    # SpMM and SDDMM block at the largest power of two dividing the
    # extents (capped at 128); attention at the mask's uniform blocks
    assert eng.stats["fallback_calls"] == 0
    assert eng.stats["block_size"] == (64 if kind == "attention" else 128)
    want = compile_expr(expr, Format(fmts), sch, dims,
                        device="cpu")(arrays).to_dense()
    if kind == "attention":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        np.testing.assert_array_equal(got, want)


# -- the program path ---------------------------------------------------------

def _coo_case(kind):
    """(keys, valid, dims, caps) of one coo_to_levels case: sorted unique
    keys with PAD_KEY rows after them."""
    rng = np.random.default_rng(len(kind))
    dims, n_pad = [6, 7, 5], 3
    if kind in ("empty", "all_pad"):             # N = 0, or no valid row
        keys = np.zeros(0, np.int64)
        n_pad = 0 if kind == "empty" else 3
    elif kind == "one_row":
        keys = np.asarray([17], np.int64)
    elif kind == "dense":
        keys = np.arange(210, dtype=np.int64)
    elif kind == "big_extent":                   # an extent >= 2**24
        dims = [5, (1 << 24) + 3, 4]
        keys = np.unique(rng.integers(0, 5 * ((1 << 24) + 3) * 4, 3000))
    else:                    # "ragged": N not a multiple of the 1024-row tile
        dims = [300, 64, 9]
        keys = np.unique(rng.integers(0, 300 * 64 * 9, 5000))
        n_pad = 1000
    keys = np.concatenate([np.asarray(keys, np.int64),
                           np.full(n_pad, PAD_KEY, np.int64)])
    valid = keys != PAD_KEY
    live = keys[valid]
    counts, p = [], live
    for d in reversed(dims):
        counts.insert(0, len(np.unique(p)))
        p = p // d
    return torch.as_tensor(keys), torch.as_tensor(valid), dims, counts


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["empty", "all_pad", "one_row", "dense",
                                  "big_extent", "ragged"])
@pytest.mark.parametrize("overflow", [False, True])
def test_coo_to_levels_equals_plain(cuda, kind, overflow):
    keys, valid, dims, counts = _coo_case(kind)
    caps = ([max(c // 2, 1) for c in counts] if overflow
            else [max(8, c + 5) for c in counts])
    before = coo_to_levels.launches
    got = coo_to_levels(keys.to(cuda), valid.to(cuda), dims, caps)
    assert coo_to_levels.launches == before + 1
    want = coo_to_levels_plain(keys, valid, dims, caps)
    for part, dtype in enumerate((torch.int32, torch.int32, torch.int64)):
        for lvl, (g, w) in enumerate(zip(got[part], want[part])):
            assert g.dtype == w.dtype == dtype and g.shape == w.shape
            assert torch.equal(g.cpu(), w), (part, lvl)
    assert [int(c) for c in got[2]] == counts


@pytest.mark.gpu
@pytest.mark.parametrize("dims", [[7, 13, 5], [4099, 33554393, 7],
                                  [3, 1, 5, 1]])
@pytest.mark.parametrize("overflow", [False, True])
def test_coo_to_levels_odd_extents_negative_key_invalid_rows(cuda, dims,
                                                             overflow):
    """Extents that are not powers of two (the kernel's multiply-shift
    quotients), negative valid keys (its floor-division branch), invalid
    rows in the middle holding any key, over several 4096-row tiles;
    overflow at every level."""
    rng = np.random.default_rng(sum(dims))
    space = int(np.prod(dims))
    keys = np.unique(rng.integers(-space // 8, space, 20_000))
    valid = rng.random(keys.size) > 0.1
    valid[0] = True                              # the most negative key
    keys[~valid] = rng.integers(-2 ** 62, 2 ** 62, int((~valid).sum()))
    keys = np.concatenate([keys, np.full(5, PAD_KEY)]).astype(np.int64)
    valid = np.concatenate([valid, np.zeros(5, bool)])
    keys_t, valid_t = torch.as_tensor(keys), torch.as_tensor(valid)
    assert (keys[valid] < 0).any()
    counts = [int(c) for c in
              coo_to_levels_plain(keys_t, valid_t, dims, [1] * len(dims))[2]]
    caps = ([max(c // 2, 1) for c in counts] if overflow
            else [c + 7 for c in counts])
    got = coo_to_levels(keys_t.to(cuda), valid_t.to(cuda), dims, caps)
    want = coo_to_levels_plain(keys_t, valid_t, dims, caps)
    for part in range(3):
        for lvl, (g, w) in enumerate(zip(got[part], want[part])):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert torch.equal(g.cpu(), w), (part, lvl)


@pytest.mark.gpu
def test_coo_to_levels_refuses_extents_beyond_int64(cuda):
    keys = torch.zeros(1, dtype=torch.int64, device=cuda)
    valid = torch.ones(1, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="int64"):
        coo_to_levels(keys, valid, [2 ** 32, 2 ** 32], [1, 1])


@pytest.mark.gpu
@pytest.mark.parametrize("fuse", [True, False])
def test_program_on_the_card_equals_the_cpu(cuda, fuse):
    rng = np.random.default_rng(8)
    n, f = 64, 8
    text = "T(i,j) = B(i,j) * C(i,f) * D(j,f); A(i,g) = T(i,j) * E(j,g)"
    fmt = Format({"B": "cc", "T": "cc", "C": "dd", "D": "dd", "E": "dd",
                  "A": "dd"})
    sch = {"T": Schedule(loop_order=("i", "j", "f")),
           "A": Schedule(loop_order=("i", "j", "g"))}
    dims = {"i": n, "j": n, "f": f, "g": f}
    arrays = {"B": ((rng.random((n, n)) < 0.2)
                    * rng.integers(-3, 4, (n, n))).astype(float),
              **{t: rng.integers(-3, 4, (n, f)).astype(float)
                 for t in "CDE"}}
    kops.reset_launch_counts()
    cp = compile_program(text, fmt, sch, dims, fuse=fuse)
    assert cp.device.type == "cuda"
    got = cp(arrays)
    if fuse:
        assert cp.stats["fused_stages"] == 2
        assert kops.launch_counts()["coo_to_levels"] >= 1
    want = compile_program(text, fmt, sch, dims, fuse=fuse,
                           device="cpu")(arrays)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].to_dense(), want[k].to_dense())


# -- tiled out-of-core execution and "auto" on the card -----------------------

def _spmm_dense_c(rng, ni, nk, nj, density):
    return {"B": ((rng.random((ni, nk)) < density)
                  * rng.integers(1, 9, (ni, nk))).astype(float),
            "C": rng.integers(1, 9, (nk, nj)).astype(float)}


@pytest.mark.gpu
@pytest.mark.parametrize("dims,merge", [
    ({"i": 64, "j": 48, "k": 40}, "scatter_workspace"),     # 3072 keys
    ({"i": 2048, "j": 1024, "k": 16}, "segment_reduce"),   # 2**21 keys
    ({"i": 4096, "j": 1024, "k": 16}, "segment_reduce")])  # 2**22 keys
def test_tiled_expr_on_the_card_equals_the_cpu(cuda, dims, merge,
                                               monkeypatch):
    """A 2 x 2 tile grid (row tiles concatenate, contraction tiles reduce)
    on the card returns the CPU's FiberTree. Each reduce takes its route
    by key bound: a tile's ``mul_reduce`` (half the rows' keys) runs on
    the workspace kernel up to 2^20 keys and as one dense
    ``segment_reduce`` above; the tile merge runs on the workspace kernel
    up to 2^20 keys and on the sort-merge, whose inner sum is
    ``segment_reduce``, above."""
    from repro_torch.core import coord_ops as co
    from repro_torch.core.torch_backend import TiledExpr

    routes = {"segment_dense": 0, "sort": 0}

    def spy(route, fn):
        def counted(*args, **kw):
            routes[route] += 1
            return fn(*args, **kw)
        return counted

    monkeypatch.setattr(kops, "_segment_workspace",
                        spy("segment_dense", kops._segment_workspace))
    monkeypatch.setattr(co, "keyed_union_reduce",
                        spy("sort", co.keyed_union_reduce))
    arrays = _spmm_dense_c(np.random.default_rng(12), dims["i"], dims["k"],
                           dims["j"], 0.2)
    expr, fmt = "X(i,j) = B(i,k) * C(k,j)", Format({"B": "cc", "C": "dd"})
    sch = Schedule(loop_order=("i", "k", "j"), tile={"i": 2, "k": 2})
    eng = compile_expr(expr, fmt, sch, dims)
    assert isinstance(eng, TiledExpr) and eng.device.type == "cuda"
    m0, h0 = eng.engine.stats["plan_misses"], eng.engine.stats["plan_hits"]
    kops.reset_launch_counts()
    got = eng(arrays)
    counts = kops.launch_counts()
    assert counts[merge] >= 1
    tile_dense = dims["i"] // 2 * dims["j"] > co.DENSE_REDUCE_BOUND
    merge_dense = dims["i"] * dims["j"] <= co.DENSE_REDUCE_BOUND
    # each of the four tiles reduces at least once (its first also in
    # the eager pass that records the plan's capacities)
    assert (routes["segment_dense"] >= 4 if tile_dense
            else routes["segment_dense"] == 0)
    assert (routes["sort"] > 0) == (not merge_dense)
    assert (counts["scatter_workspace"] > 0) == (not tile_dense
                                                 or merge_dense)
    assert (counts["segment_reduce"]
            >= routes["segment_dense"] + routes["sort"])
    assert eng.engine.stats["plan_misses"] - m0 == 1
    assert eng.engine.stats["plan_hits"] - h0 == 3
    monkeypatch.undo()
    want = compile_expr(expr, fmt, sch, dims, device="cpu")(arrays)
    np.testing.assert_array_equal(got.to_dense(), want.to_dense())
    np.testing.assert_array_equal(got.to_dense(), arrays["B"] @ arrays["C"])


@pytest.mark.gpu
def test_tiled_expr_peak_memory_below_the_untiled_estimate(cuda):
    """Under a budget that forces tiles, the tiled call's peak allocation
    stays within the budget (below the untiled call's estimate), on the
    first call and warm, with each tile run in pieces, and no tile's
    uploads or plan outputs outlive the call."""
    from repro_torch.core import tiling

    dims = {"i": 2048, "j": 256, "k": 2048}
    dens = {"B": 0.01, "C": 1.0}
    expr, fmt = "X(i,j) = B(i,k) * C(k,j)", Format({"B": "cc", "C": "dd"})
    sch = Schedule(loop_order=("i", "k", "j"))
    untiled = tiling.estimate_call_bytes(expr, fmt, sch, dims,
                                         densities=dens)
    budget = untiled // 3
    eng = compile_expr(expr, fmt, sch, dims, mem_budget=budget,
                       sparsity=dens)
    assert eng.n_tiles >= 4 and eng.pieces > 1
    arrays = _spmm_dense_c(np.random.default_rng(13), 2048, 2048, 256, 0.01)
    for _ in ("first call", "warm call"):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = eng(arrays)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - before
        assert peak <= budget < untiled, (peak, budget, eng.pieces)
        assert torch.cuda.memory_allocated() == before
        np.testing.assert_array_equal(got.to_dense(),
                                      arrays["B"] @ arrays["C"])


@pytest.mark.gpu
def test_auto_schedule_runs_on_the_card(cuda, tmp_path, monkeypatch):
    monkeypatch.setenv("SAM_SCHEDULE_CACHE", str(tmp_path / "s.json"))
    rng = np.random.default_rng(14)
    dims = {"i": 40, "j": 30, "k": 20}
    arrays = {"B": ((rng.random((40, 20)) < 0.3)
                    * rng.integers(1, 9, (40, 20))).astype(float),
              "C": ((rng.random((20, 30)) < 0.3)
                    * rng.integers(1, 9, (20, 30))).astype(float)}
    expr, fmt = "X(i,j) = B(i,k) * C(k,j)", Format({"B": "cc", "C": "cc"})
    eng = compile_expr(expr, fmt, "auto", dims, sparsity=0.3)
    assert eng.device.type == "cuda"
    kops.reset_launch_counts()
    got = eng(arrays)
    assert sum(kops.launch_counts().values()) > 0
    cpu = compile_expr(expr, fmt, "auto", dims, sparsity=0.3, device="cpu")
    assert cpu.schedule == eng.schedule          # one cached pick
    np.testing.assert_array_equal(got.to_dense(), cpu(arrays).to_dense())
    np.testing.assert_array_equal(got.to_dense(), arrays["B"] @ arrays["C"])
