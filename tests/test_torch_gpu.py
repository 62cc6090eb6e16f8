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


def _workspace_ids(kind, n, g):
    """Ids of ``kind`` for ``test_scatter_workspace_equals_plain`` and
    their slot count. Every kind also aims rows at the dropped slot."""
    if kind in ("random", "sorted"):
        slots = 5000
        ids = torch.randint(0, slots + 1, (n,), generator=g,
                            dtype=torch.int32)
        if kind == "sorted":
            ids = torch.sort(ids).values
        return ids, slots
    if kind == "runs":
        # a model block's down stage: under each (e, c) bucket the ids of
        # its 512 slots repeated under 7 values of f, then 300 dropped rows
        # between one bucket and the next
        buckets, width, reps, gap = 24, 512, 7, 300
        slots = buckets * width
        per = width * reps + gap
        r = torch.arange(n) % (buckets * per)
        b, off = r // per, r % per
        ids = torch.where(off < width * reps, b * width + off % width, slots)
        return ids.to(torch.int32), slots
    if kind == "hot":
        # sorted ids and one slot whose run crosses many tiles
        slots = 3000
        ids = torch.sort(torch.randint(0, slots + 1, (n,), generator=g,
                                       dtype=torch.int32)).values
        hot = min(n // 3, 600_000)
        ids[n // 3:n // 3 + hot] = 1234
        return ids, slots
    # "wide": ids spread over 2^20 slots, wider than any window, with runs
    # of one id among them
    slots = 1 << 20
    ids = torch.randint(-2, slots + 3, (n,), generator=g, dtype=torch.int32)
    ids[1000:30_000] = 5
    ids[n // 2:n // 2 + 9000] = slots - 1
    return ids, slots


@pytest.mark.gpu
@pytest.mark.parametrize("c,dtype", [(2, torch.float32),
                                     ("mul_pair", torch.float32),
                                     (1, torch.float32), (3, torch.float32),
                                     (5, torch.float32),
                                     (2, torch.float64),
                                     ("mul_pair", torch.float64),
                                     ("mul_pair", torch.float16),
                                     (1, torch.float16)])
@pytest.mark.parametrize("ids_kind", ["random", "sorted", "runs", "hot",
                                      "wide"])
@pytest.mark.parametrize("n", [100_000, (1 << 18) + 1, (1 << 22) + 5,
                               (1 << 24) + 4097])
def test_scatter_workspace_equals_plain(cuda, c, dtype, ids_kind, n):
    """Up to 2^18 rows the kernel runs a row a thread; above, tiles of
    1024 rows, and above 2^22 rows a block keeps its shared-memory window
    over several tiles. Random ids over 5000 slots
    fit the window of one float32 column, not of two or three; sorted ids,
    a model block's bucketed runs (dropped rows between the buckets) and
    one hot slot across tiles take the window; ids over 2^20 slots, the
    row path. mul_pair rows carry NaN where they are masked. Integer
    values, so the sums are exact in any order."""
    g = torch.Generator().manual_seed(1)
    mul_pair = c == "mul_pair"
    ids, slots = _workspace_ids(ids_kind, n, g)
    cols = torch.randint(-4, 5, (n, 3 if mul_pair else c), generator=g
                         ).to(dtype)
    if mul_pair:
        cols[::7, 0] = float("nan")            # garbage at masked rows
        cols[::7, 2] = 0.0
    ids, cols = ids.to(cuda), cols.to(cuda)
    before = scatter_workspace.launches
    got = scatter_workspace(ids, cols, num_slots=slots, mul_pair=mul_pair)
    assert scatter_workspace.launches == before + 1
    want = scatter_workspace_plain(ids, cols, num_slots=slots,
                                   mul_pair=mul_pair)
    assert got.dtype == want.dtype and torch.equal(got, want)


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


def _attention_f64(q, k, v, kv_idx, bs, causal):
    """float64 block-masked softmax attention (zeros for a row with no
    allowed key), the oracle both sides are held to below."""
    bh, s, d = q.shape
    n_blk = k.shape[1] // bs
    allow = np.zeros((s // bs, n_blk), bool)
    for qi, row in enumerate(kv_idx):
        allow[qi, row[(row >= 0) & (row < n_blk)]] = True
    allow = np.kron(allow, np.ones((bs, bs), bool))
    if causal:
        allow &= np.tri(s, k.shape[1], dtype=bool)
    out = np.zeros((bh, s, d))
    for h in range(bh):
        sc = q[h].astype(np.float64) @ k[h].astype(np.float64).T / d ** 0.5
        sc = np.where(allow, sc, -np.inf)
        m = sc.max(1, keepdims=True)
        p = np.exp(sc - np.where(np.isfinite(m), m, 0.0))
        l = p.sum(1, keepdims=True)
        out[h] = np.where(l > 0, p @ v[h].astype(np.float64)
                          / np.where(l > 0, l, 1.0), 0.0)
    return out


@pytest.mark.gpu
def test_bsr_attention_cuda_core_case_twenty_times_in_a_row(cuda):
    """The case that once differed from its plain version (ROADMAP queue 3,
    item 5): block size 1, head dim 32, float32 on the CUDA-core kernel,
    launched 20 times in a row from fresh uploads. Each launch must equal
    the plain version within the file's float32 tolerance, and both must
    stay within it of a float64 oracle, so a failure names the side that
    moved; the launches must agree bit for bit."""
    bs, d = 1, 32
    rng = np.random.default_rng(bs + d)
    n_blk = 512
    kv_idx = kops.sliding_window_kv_idx(n_blk, n_blk, 3, causal=False)
    kv_idx[2] = n_blk
    q, k, v = (rng.standard_normal((2, n_blk, d)).astype(np.float32)
               for _ in range(3))
    assert attn_mod.route(bs, bs, d) == "cuda_cores"
    oracle = _attention_f64(q, k, v, kv_idx, bs, False)
    want = bsr_flash_attention_plain(*map(torch.as_tensor, (q, k, v)),
                                     torch.as_tensor(kv_idx), bq=bs, bkv=bs)
    tol = 2e-5
    np.testing.assert_allclose(want.double().numpy(), oracle, rtol=tol,
                               atol=tol, err_msg="the plain version")
    first = None
    for rep in range(20):
        got = bsr_flash_attention(*(torch.as_tensor(x).to(cuda)
                                    for x in (q, k, v, kv_idx)),
                                  bq=bs, bkv=bs).cpu()
        np.testing.assert_allclose(got.double().numpy(), oracle, rtol=tol,
                                   atol=tol, err_msg=f"the kernel, {rep}")
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)
        first = got if first is None else first
        assert torch.equal(got, first), f"launch {rep} differs from launch 0"


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


@pytest.mark.gpu
def test_threaded_server_on_the_card_equals_execute_batch(cuda):
    """Four submitter threads through a threaded ``SamServer`` on the
    card: every result equals the same engine's ``execute_batch`` of the
    same members bit for bit and numpy, the reduce kernels launch from the
    dispatch thread, and one pipeline of four threads serves them."""
    import threading

    from repro_torch.core.serving import Request, SamServer

    expr, fmt = "X(i,j) = B(i,k) * C(k,j)", {"B": "cc", "C": "cc"}
    n = 256
    sets = [{m: ((rng.random((n, n)) < 0.02)
                 * rng.integers(1, 9, (n, n))).astype(float) for m in "BC"}
            for rng in map(np.random.default_rng, range(20, 36))]
    srv = SamServer(max_batch=4)
    assert srv.device.type == "cuda"
    kops.reset_launch_counts()
    out = [None] * len(sets)

    def submit(t):
        hs = [(i, srv.submit(Request(expr, sets[i], formats=fmt,
                                     order="ikj")))
              for i in range(t, len(sets), 4)]
        for i, h in hs:
            out[i] = h.result(timeout=60)

    threads = [threading.Thread(target=submit, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    names = sorted(t.name for t in srv._threads)
    st = srv.stats()
    srv.shutdown()
    assert names == ["sam-serve-batcher", "sam-serve-decode",
                     "sam-serve-dispatch", "sam-serve-encode"]
    assert st["completed"] == len(sets) and st["failed"] == 0
    assert kops.launch_counts()["scatter_workspace"] > 0
    eng = compile_expr(expr, Format(fmt),
                       Schedule(loop_order=("i", "k", "j")),
                       {"i": n, "j": n, "k": n})
    for got, ref, s in zip(out, eng.execute_batch(sets), sets):
        assert np.array_equal(got.vals, ref.vals)
        assert all(np.array_equal(a.crd, b.crd) and np.array_equal(a.seg,
                                                                   b.seg)
                   for a, b in zip(got.levels, ref.levels))
        np.testing.assert_array_equal(got.to_dense(), s["B"] @ s["C"])


@pytest.mark.gpu
def test_distributed_tiles_on_the_card_equal_tiled_under_a_fault(cuda):
    """``DistTiledExpr`` over two workers on the card (threaded), tile 1
    failing on its first attempt: retried, and bit-identical to the
    ``TiledExpr`` it drives and to numpy."""
    from repro_torch.core.dist_exec import DistTiledExpr, InjectedFault

    dims = {"i": 512, "j": 128, "k": 512}
    arrays = _spmm_dense_c(np.random.default_rng(15), 512, 512, 128, 0.02)
    eng = compile_expr("X(i,j) = B(i,k) * C(k,j)",
                       Format({"B": "cc", "C": "dd"}),
                       Schedule(loop_order=("i", "k", "j"),
                                tile={"i": 2, "k": 2}), dims)
    ref = eng(arrays)
    dist = DistTiledExpr(eng, workers=2, overlap=True, faults=[
        InjectedFault(tile=1, worker=w, attempt=0) for w in (0, 1)])
    kops.reset_launch_counts()
    got = dist(arrays)
    assert dist.stats["retries"] == 1 and dist.stats["tiles"] == 4
    assert sum(kops.launch_counts().values()) > 0
    assert np.array_equal(got.vals, ref.vals)
    assert all(np.array_equal(a.crd, b.crd) and np.array_equal(a.seg, b.seg)
               for a, b in zip(got.levels, ref.levels))
    np.testing.assert_array_equal(got.to_dense(), arrays["B"] @ arrays["C"])


@pytest.mark.gpu
def test_threaded_server_runs_a_fused_program_on_the_card(cuda):
    """A fused program served from the dispatch thread launches
    ``coo_to_levels`` there (its stream handle once reached the kernel
    library as a truncated C int, and the launch crashed off the main
    thread) and equals the same program called on the main thread."""
    from repro_torch.core.serving import Request, SamServer

    prog = "T(i,j) = B(i,j) * C(i,f) * D(j,f); A(i,g) = T(i,j) * E(j,g)"
    fmt = {"B": "cc", "T": "cc", "C": "dd", "D": "dd", "E": "dd", "A": "dd"}
    order = {"T": ("i", "j", "f"), "A": ("i", "j", "g")}
    rng = np.random.default_rng(16)
    n, f = 512, 16
    arrays = {"B": ((rng.random((n, n)) < 0.02)
                    * rng.integers(1, 4, (n, n))).astype(float),
              **{t: rng.integers(-3, 4, (n, f)).astype(float)
                 for t in "CDE"}}
    dims = {"i": n, "j": n, "f": f, "g": f}
    schedules = {k: Schedule(loop_order=o) for k, o in order.items()}
    cp = compile_program(prog, Format(fmt), schedules, dims)
    assert cp.stats["fused_stages"] == 2
    want = cp(arrays)["A"].to_dense()
    kops.reset_launch_counts()
    with SamServer(max_batch=2) as srv:
        hs = [srv.submit(Request(prog, arrays, formats=fmt,
                                 schedule=schedules, dims=dims))
              for _ in range(3)]
        got = [h.result(timeout=60)["A"].to_dense() for h in hs]
    assert kops.launch_counts()["coo_to_levels"] >= 3
    for g in got:
        np.testing.assert_array_equal(g, want)
    T = arrays["B"] * (arrays["C"] @ arrays["D"].T)
    np.testing.assert_array_equal(want, T @ arrays["E"])


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.gpu
def test_pruned_transformer_on_the_card_equals_the_cpu(cuda, tmp_path,
                                                      monkeypatch):
    """The pruned transformer of ``chip_smoke.py`` (s) at a small size:
    attention blocks of 16 with head dim 16 take the tensor-core
    ``bsr_attention`` route; the card's forward equals the CPU's and the
    float64 oracle within 1e-5, relative to the largest magnitude."""
    from repro_torch.configs.qwen3_0_6b import REDUCED
    from repro_torch.models.pruned_transformer import PrunedTransformer

    monkeypatch.setenv("SAM_SCHEDULE_CACHE", str(tmp_path / "s.json"))
    x = np.random.default_rng(17).standard_normal(
        (64, REDUCED.d_model)).astype(np.float32)
    kw = {"seq_len": 64, "block": 16, "window_blocks": 2}
    with PrunedTransformer(REDUCED, device="cpu", **kw) as cpu_model:
        want = cpu_model(x)
        oracle = cpu_model.reference(x)
    kops.reset_launch_counts()
    with PrunedTransformer(REDUCED, **kw) as model:
        got = model(x)
        stats = model.stats()
    counts = kops.launch_counts()
    assert counts["bsr_attention"] == 8
    assert kops.route_counts()["bsr_attention"]["tensor_cores"] == 8
    assert counts["scatter_workspace"] + counts["segment_reduce"] >= 1
    assert stats["server"]["completed"] == 8
    assert stats["server"]["dispatches"] == 2
    assert _rel(got, want) < 1e-5 and _rel(got, oracle) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_apply_moe_on_the_card_equals_the_cpu(cuda, dtype, tol):
    """``apply_moe`` with shared experts, both dispatches, on the card
    against the CPU from the same parameters (``chip_smoke.py`` (t))."""
    from repro_torch.models import moe

    g = torch.Generator(device="cpu").manual_seed(18)
    p = moe.init_moe(g, 32, 16, 8, n_shared=2)
    x = torch.randn((2, 40, 32), generator=g)
    p_gpu = {k: ({kk: vv.cuda() for kk, vv in v.items()}
                 if isinstance(v, dict) else v.cuda()) for k, v in p.items()}
    for dispatch, cf in (("sam", 0.5), ("sam", 8.0), ("dense", 1.25)):
        want = moe.apply_moe(p, x, k=2, dispatch=dispatch,
                             capacity_factor=cf, compute_dtype=dtype)
        got = moe.apply_moe(p_gpu, x.cuda(), k=2, dispatch=dispatch,
                            capacity_factor=cf, compute_dtype=dtype)
        assert got.device.type == "cuda" and got.dtype == dtype
        assert _rel(got.float().cpu(), want.float()) <= tol


@pytest.mark.gpu
def test_moe_blocks_on_the_card_equal_the_cpu(cuda):
    """``MoEBlock`` (with drops) within 1e-5 of the CPU, the same
    ``last_dropped``; ``compile_moe_block`` fused and staged on integer
    data equal to the CPU's and to ``moe_linear_reference`` exactly, the
    fused chain handing its intermediates over on ``coo_to_levels``."""
    from repro_torch.models.moe_blocks import (MoEBlock, compile_moe_block,
                                               moe_linear_reference,
                                               routing_tensors)

    e, cap, t, d, f, k = 8, 2, 12, 32, 16, 3
    rng = np.random.default_rng(19)
    p = {"router": rng.standard_normal((d, e)).astype(np.float32),
         "w_gate": rng.standard_normal((e, d, f)),
         "w_up": rng.standard_normal((e, d, f)),
         "w_down": rng.standard_normal((e, f, d))}
    x = rng.standard_normal((t, d))
    cpu_block = MoEBlock(e, cap, t, d, f, device="cpu")
    want = cpu_block(p, x, k=k)
    kops.reset_launch_counts()
    block = MoEBlock(e, cap, t, d, f)
    got = block(p, x, k=k)
    assert block.last_dropped == cpu_block.last_dropped > 0
    assert kops.launch_counts()["coo_to_levels"] >= 2
    assert _rel(got, want) < 1e-5

    ids = np.stack([rng.choice(e, k, replace=False) for _ in range(t)])
    G, S, dropped = routing_tensors(np.ones((t, k)), ids, e, cap)
    arrays = {"G": G, "S": S,
              "X": rng.integers(-1, 2, (t, d)).astype(float),
              "Wu": rng.integers(-1, 2, (e, d, f)).astype(float),
              "Wd": rng.integers(-1, 2, (e, f, d)).astype(float)}
    lin = moe_linear_reference(G, S, arrays["X"], arrays["Wu"],
                               arrays["Wd"])
    for fuse in (True, False):
        kops.reset_launch_counts()
        out = compile_moe_block(e, cap, t, d, f, fuse=fuse)(arrays)
        counts = kops.launch_counts()
        ref = compile_moe_block(e, cap, t, d, f, fuse=fuse,
                                device="cpu")(arrays)
        assert (counts["coo_to_levels"] >= 1) == fuse
        assert counts["scatter_workspace"] + counts["segment_reduce"] >= 1
        for name in out:
            np.testing.assert_array_equal(out[name].to_dense(),
                                          ref[name].to_dense())
            np.testing.assert_array_equal(out[name].to_dense(), lin[name])


# -- the language-model path -------------------------------------------------

LM_TOL = 1e-5       # float32 compute on both devices: summation order only


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "paligemma-3b",
                                  "musicgen-large", "moonshot-v1-16b-a3b",
                                  "deepseek-v3-671b", "xlstm-125m",
                                  "zamba2-2.7b"])
def test_lm_forward_on_the_card_equals_the_cpu(cuda, arch):
    """One architecture of each family at its reduced config, float32
    compute and float32 caches: ``forward`` over 8 tokens, then a cached
    prefill of 6 and two ``decode_step``s, on the card within ``LM_TOL``
    of the CPU's logits (relative to the largest) on the same parameters;
    the stubs get frames, or patches with every step."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.model import (decode_step, forward, init_caches,
                                          init_params, tree_map)

    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              compute_dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    on_card = tree_map(lambda t: t.to(cuda), params)
    rng = np.random.default_rng(0)
    batch = {}
    if cfg.frontend == "encodec_stub":
        batch["frames"] = torch.tensor(
            rng.normal(size=(2, 8, cfg.d_model)), dtype=torch.float32)
    else:
        batch["tokens"] = torch.tensor(rng.integers(0, cfg.vocab, (2, 8)),
                                       dtype=torch.int32)
    patches = {}
    if cfg.frontend == "siglip_stub":
        patches["patches"] = torch.tensor(
            rng.normal(size=(2, cfg.n_patches, cfg.patch_dim)),
            dtype=torch.float32)

    def rel(got, want):
        got, want = got.double().cpu(), want.double()
        assert got.shape == want.shape and torch.isfinite(got).all()
        return float((got - want).abs().max() / want.abs().max())

    def on(dev, b):
        return {k: v.to(dev) for k, v in b.items()}

    want, _ = forward(cfg, params, dict(batch, **patches))
    got, _ = forward(cfg, on_card, on(cuda, dict(batch, **patches)))
    assert got.device.type == "cuda" and rel(got, want) <= LM_TOL
    runs = [[params, torch.device("cpu"), None], [on_card, cuda, None]]
    for run in runs:
        run[2] = init_caches(cfg, 2, 64, dtype=torch.float32, device=run[1])
    for i, (lo, hi) in enumerate([(0, 6), (6, 7), (7, 8)]):
        step = dict({k: v[:, lo:hi] for k, v in batch.items()}, **patches)
        outs = []
        for run in runs:
            p, dev, c = run
            if i == 0:
                out, run[2] = forward(cfg, p, on(dev, step), c)
            else:
                out, run[2] = decode_step(cfg, p, c, on(dev, step))
            outs.append(out)
        assert rel(outs[1], outs[0]) <= LM_TOL


@pytest.mark.gpu
def test_train_step_on_the_card_equals_the_cpu(cuda):
    """qwen3-0.6b's reduced config in float32 compute, one AdamW step
    (``make_train_step``, remat "dots") on the same parameters and batch:
    the card's loss within 1e-5 and ``grad_norm`` within 1e-4 (relative)
    of the CPU's, each new parameter within ``2 * lr`` of the CPU's (a
    gradient near zero may take the other sign, and Adam's step then
    moves it by about ``lr`` the other way) and 99% of them within 1e-5
    of their leaf's largest magnitude."""
    import dataclasses

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data.pipeline import batch_for_step
    from repro_torch.models.model import init_params, tree_leaves, tree_map
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step

    cfg = dataclasses.replace(get_config("qwen3-0.6b", reduced=True),
                              compute_dtype="float32")
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    step = make_train_step(cfg, opt, remat="dots")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    outs = {}
    for dev in (torch.device("cpu"), cuda):
        p = tree_map(lambda t: t.to(dev), params)
        batch = batch_for_step(cfg, ShapeConfig("t", 16, 4, "train"), 0,
                               device=dev)
        outs[dev.type] = step(p, init_opt_state(opt, p), batch)
    (pc, _, mc), (pg, og, mg) = outs["cpu"], outs["cuda"]
    assert og["m"]["embed"].device.type == "cuda"
    assert abs(float(mg["loss"]) - float(mc["loss"])) <= 1e-5 * abs(
        float(mc["loss"]))
    assert abs(float(mg["grad_norm"]) - float(mc["grad_norm"])) <= 1e-4 * \
        float(mc["grad_norm"])
    close = total = 0
    for got, want in zip(tree_leaves(pg), tree_leaves(pc)):
        d = (got.cpu().double() - want.double()).abs()
        assert float(d.max()) <= 2 * opt.lr
        close += int((d <= 1e-5 * float(want.abs().max())).sum())
        total += d.numel()
    assert close >= 0.99 * total


@pytest.mark.gpu
def test_checkpoint_of_cuda_tensors_restores_onto_the_card(cuda, tmp_path):
    """An async save copies the CUDA leaves to the host before it returns
    (an in-place change right after does not reach the file); restore
    puts each leaf on its template's device in its dtype."""
    from repro_torch.distributed.checkpoint import Checkpointer
    from repro_torch.models.model import tree_map

    state = {"w": torch.arange(12.0, device=cuda).reshape(3, 4),
             "m": torch.full((5,), 0.3, dtype=torch.bfloat16, device=cuda),
             "step": torch.tensor(7, dtype=torch.int32, device=cuda)}
    want = tree_map(lambda t: t.clone(), state)
    ck = Checkpointer(str(tmp_path))
    ck.save(7, state)
    state["w"].add_(1.0)
    ck.wait()
    got, step = ck.restore(tree_map(torch.zeros_like, state))
    assert step == 7
    for k, v in want.items():
        assert got[k].device.type == "cuda" and got[k].dtype == v.dtype
        assert torch.equal(got[k], v), k


@pytest.mark.gpu
def test_train_main_runs_on_the_card_by_default(cuda, tmp_path, capsys):
    """``launch.train.main`` without ``--device`` trains on the card."""
    from repro_torch.launch.train import main

    losses = main(["--arch", "qwen3-0.6b", "--reduced", "--steps", "3",
                   "--batch", "2", "--seq", "16", "--ckpt-dir",
                   str(tmp_path), "--ckpt-every", "2"])
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert "[train] qwen3-0.6b steps=3" in capsys.readouterr().out
