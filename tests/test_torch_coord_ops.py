"""Differential fuzz: the port's ``coord_ops`` against the reference's.

Every primitive of ``repro_torch.core.coord_ops`` runs on the same numpy
inputs as ``repro.core.coord_ops`` (JAX on the CPU), mirroring
``tests/test_coord_ops_fuzz.py``, ``tests/test_accumulate_fuzz.py`` and
the property tests of ``tests/test_jax_backend.py``. Integer-valued data
must match bit for bit (any summation order is exact there); real-valued
data is held to ``rtol=1e-5, atol=1e-6``, because only the summation
order differs. ``locate_keys`` is held to the reference only on
single-fiber levels: on levels with several fibers the reference misses
coordinates (it searches the whole ``crd`` array, sorted only inside each
fiber), so there the port is held to a numpy oracle.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import coord_ops as rco  # noqa: E402
from repro.core.fibertree import FiberTree as RFiberTree  # noqa: E402
from repro_torch.core import coord_ops as co  # noqa: E402
from repro_torch.core.convert import tree_from_arrays  # noqa: E402
from repro_torch.core.fibertree import canonical_tree  # noqa: E402

SEEDS = range(6)
RTOL, ATOL = 1e-5, 1e-6


def t(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def j(a, dtype=None):
    return jnp.asarray(np.asarray(a), dtype)


def assert_same(ref, got, exact=True, msg=""):
    """Element-wise equality of two result tuples (or single arrays)."""
    if not isinstance(ref, (tuple, list)):
        ref, got = (ref,), (got,)
    assert len(ref) == len(got), msg
    for k, (a, b) in enumerate(zip(ref, got)):
        a = np.asarray(a)
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.shape == b.shape, f"{msg}[{k}]: {a.shape} != {b.shape}"
        if exact or a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=f"{msg}[{k}]")
        else:
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{msg}[{k}]")


def keyed(seed, n=48, bound=24, real=False):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, bound, n).astype(np.int64)
    vals = (rng.normal(size=n) if real
            else rng.integers(-3, 4, n)).astype(np.float32)
    valid = rng.random(n) < 0.75
    return keys, vals, valid


# -- compact / exclusive_cumsum ---------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_compact(seed):
    rng = np.random.default_rng(seed)
    n = 40
    mask = rng.random(n) < 0.4
    a = rng.integers(0, 100, n).astype(np.int64)
    b = rng.normal(size=(n, 3)).astype(np.float32)
    for cap in (8, 32, 64):
        ref = rco.compact(j(mask), (j(a), j(b)), cap, fill=7)
        got = co.compact(t(mask), (t(a), t(b)), cap, fill=7)
        assert_same(ref[0] + (ref[1],), got[0] + (got[1],), msg=f"cap {cap}")
    assert_same(rco.exclusive_cumsum(j(a)), co.exclusive_cumsum(t(a)))


def test_compact_empty_mask():
    ref = rco.compact(j(np.zeros(0, bool)), (j(np.zeros(0, np.int64)),), 8,
                      fill=3)
    got = co.compact(t(np.zeros(0, bool)), (t(np.zeros(0, np.int64)),), 8,
                     fill=3)
    assert_same(ref[0] + (ref[1],), got[0] + (got[1],))


# -- scan_level -------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_scan_level(seed):
    rng = np.random.default_rng(seed)
    nf = 6
    lens = rng.integers(0, 5, nf)
    seg = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    crd = rng.integers(0, 100, int(seg[-1])).astype(np.int32)
    refs = rng.integers(-1, nf, 5).astype(np.int32)     # -1: a union hole
    pvalid = rng.random(5) < 0.8
    for cap in (8, 32):
        ref = rco.scan_level(j(seg), j(crd), j(refs), j(pvalid), cap)
        got = co.scan_level(t(seg), t(crd), t(refs), t(pvalid), cap)
        assert_same(ref, got, msg=f"cap {cap}")
        assert got[0].dtype == got[1].dtype == got[2].dtype == torch.int32


def test_scan_level_empty_level():
    seg = np.zeros(4, np.int32)
    crd = np.zeros(0, np.int32)
    refs = np.arange(3, dtype=np.int32)
    ref = rco.scan_level(j(seg), j(crd), j(refs), j(np.ones(3, bool)), 8)
    got = co.scan_level(t(seg), t(crd), t(refs), t(np.ones(3, bool)), 8)
    assert_same(ref, got)


# -- intersect / union ------------------------------------------------------

def sorted_keys(rng, n, hi, pad):
    """Sorted unique keys padded with PAD_KEY to a fixed length n + pad
    (fixed shapes keep the reference's JAX compiles to one per test)."""
    k = np.unique(rng.integers(0, hi, n)).astype(np.int64)
    live = len(k)
    k = np.concatenate([k, np.full(n + pad - live, co.PAD_KEY, np.int64)])
    return k, np.arange(n + pad) < live


@pytest.mark.parametrize("seed", SEEDS)
def test_intersect_keys(seed):
    rng = np.random.default_rng(seed)
    ak, av = sorted_keys(rng, 20, 40, 3)
    bk, bv = sorted_keys(rng, 20, 40, 2)
    av = av & (rng.random(len(av)) < 0.9)
    ref = rco.intersect_keys(j(ak), j(av), j(bk), j(bv))
    got = co.intersect_keys(t(ak), t(av), t(bk), t(bv))
    assert_same(ref, got)
    live = set(ak[av].tolist()) & set(bk[bv].tolist())
    assert set(ak[got[0].numpy()].tolist()) == live


@pytest.mark.parametrize("seed", SEEDS)
def test_union_keys(seed):
    rng = np.random.default_rng(seed)
    ak, av = sorted_keys(rng, 15, 30, 2)
    bk, bv = sorted_keys(rng, 15, 30, 1)
    for cap in (8, 64):
        ref = rco.union_keys(j(ak), j(av), j(bk), j(bv), cap)
        got = co.union_keys(t(ak), t(av), t(bk), t(bv), cap)
        assert_same(ref, got, msg=f"cap {cap}")


# -- locate_keys ------------------------------------------------------------

def fiber_level(rng, nf, dim, density=0.5):
    segs, crds = [0], []
    for _ in range(nf):
        c = np.flatnonzero(rng.random(dim) < density)
        crds.extend(c.tolist())
        segs.append(len(crds))
    return (np.asarray(segs, np.int32), np.asarray(crds, np.int32))


@pytest.mark.parametrize("seed", SEEDS)
def test_locate_keys_single_fiber_matches_reference(seed):
    rng = np.random.default_rng(seed)
    seg, crd = fiber_level(rng, 1, 30)
    probe = rng.integers(0, 30, 24).astype(np.int32)
    pref = np.where(rng.random(24) < 0.1, -1, 0).astype(np.int32)
    valid = rng.random(24) < 0.8
    ref = rco.locate_keys(j(seg), j(crd), j(pref), j(probe), j(valid))
    got = co.locate_keys(t(seg), t(crd), t(pref), t(probe), t(valid))
    assert_same(ref, got)


@pytest.mark.parametrize("seed", SEEDS)
def test_locate_keys_multi_fiber_matches_oracle(seed):
    rng = np.random.default_rng(seed)
    nf, dim = 5, 12
    seg, crd = fiber_level(rng, nf, dim)
    n = 40
    pref = rng.integers(-1, nf, n).astype(np.int32)
    probe = rng.integers(0, dim, n).astype(np.int32)
    valid = rng.random(n) < 0.85
    found, idx = co.locate_keys(t(seg), t(crd), t(pref), t(probe), t(valid))
    for r in range(n):
        lo = seg[max(pref[r], 0)]
        hi = seg[max(pref[r], 0) + 1]
        hits = np.flatnonzero(crd[lo:hi] == probe[r])
        want = bool(valid[r] and pref[r] >= 0 and len(hits))
        assert bool(found[r]) == want, r
        assert int(idx[r]) == (lo + hits[0] if want else 0), r


# -- segment sums -----------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("real", [False, True])
def test_default_segment_sum_drops_out_of_range_ids(seed, real):
    rng = np.random.default_rng(seed)
    n, s = 50, 9
    ids = rng.integers(-2, s + 3, n).astype(np.int32)
    vals = (rng.normal(size=n) if real
            else rng.integers(-4, 5, n)).astype(np.float32)
    ref = rco.default_segment_sum(j(vals), j(ids), s)
    got = co.default_segment_sum(t(vals), t(ids), s)
    assert_same(ref, got, exact=not real)


@pytest.mark.parametrize("seed", SEEDS)
def test_segment_sum(seed):
    rng = np.random.default_rng(seed)
    n, p = 40, 7
    vals = rng.integers(-4, 5, n).astype(np.float32)
    parent = np.sort(rng.integers(0, p, n)).astype(np.int32)
    valid = rng.random(n) < 0.8
    ref = rco.segment_sum(j(vals), j(parent), j(valid), p)
    got = co.segment_sum(t(vals), t(parent), t(valid), p)
    assert_same(ref, got)


# -- keyed reduces ----------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("key_bound", [None, 24, co.DENSE_REDUCE_BOUND + 1])
@pytest.mark.parametrize("real", [False, True])
def test_keyed_union_reduce(seed, key_bound, real):
    keys, vals, valid = keyed(seed, real=real)
    for cap in (8, 32, 64):       # 8 truncates: count still reports all
        ref = rco.keyed_union_reduce(j(keys), j(vals), j(valid), cap,
                                     key_bound=key_bound)
        got = co.keyed_union_reduce(t(keys), t(vals), t(valid), cap,
                                    key_bound=key_bound)
        assert_same(ref, got, exact=not real, msg=f"cap {cap}")
        assert got[0].dtype == torch.int64 and got[3].dtype == torch.int32


def test_keyed_union_reduce_keeps_explicit_zero_slots():
    keys = np.asarray([3, 3, 5], np.int64)
    vals = np.asarray([2.0, -2.0, 0.0], np.float32)
    valid = np.ones(3, bool)
    for bound in (None, 8):
        ref = rco.keyed_union_reduce(j(keys), j(vals), j(valid), 8,
                                     key_bound=bound)
        got = co.keyed_union_reduce(t(keys), t(vals), t(valid), 8,
                                    key_bound=bound)
        assert_same(ref, got)
        assert int(got[3]) == 2


def test_keyed_union_reduce_dense_branch_casts_keys_to_int32():
    """The dense branch casts keys to int32 before the segment sum, as the
    reference does; with in-bound keys the cast is exact."""
    seen = {}

    def spy(vals, ids, n):
        seen["dtype"] = ids.dtype
        return co.default_segment_sum(vals, ids, n)

    keys, vals, valid = keyed(0)
    co.keyed_union_reduce(t(keys), t(vals), t(valid), 32,
                          segment_sum_impl=spy, key_bound=24)
    assert seen["dtype"] == torch.int32


@pytest.mark.parametrize("key_bound", [None, 24])
def test_keyed_union_reduce_drops_padding_rows(key_bound):
    """Padding rows reach the segment sum with the dropped id, never a
    live segment: on the GPU, rows sharing one id serialize their atomics
    on one address."""
    calls = []

    def spy(vals, ids, n):
        calls.append((ids.clone(), n))
        return co.default_segment_sum(vals, ids, n)

    keys, vals, valid = keyed(0)
    assert not valid.all()
    co.keyed_union_reduce(t(keys), t(vals), t(valid), 32,
                          segment_sum_impl=spy, key_bound=key_bound)
    for ids, n in calls:
        assert int((ids == n).sum()) == int((~valid).sum())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("key_bound", [None, 24])
def test_mul_reduce(seed, key_bound):
    keys, a, valid = keyed(seed)
    b = np.random.default_rng(seed + 100).integers(-4, 5, len(a)).astype(
        np.float32)
    ref = rco.mul_reduce(j(keys), j(a), j(b), j(valid), 32,
                         key_bound=key_bound)
    got = co.mul_reduce(t(keys), t(a), t(b), t(valid), 32,
                        key_bound=key_bound)
    assert_same(ref, got)


def imr_case(seed):
    rng = np.random.default_rng(seed)
    ak, av = sorted_keys(rng, 24, 48, 4)
    bk, bv = sorted_keys(rng, 24, 48, 3)
    a_vals = rng.integers(1, 9, len(ak)).astype(np.float32)
    b_vals = rng.integers(1, 9, len(bk)).astype(np.float32)
    out_key = rng.integers(0, 16, len(ak)).astype(np.int64)
    return ak, av, a_vals, bk, bv, b_vals, out_key


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("key_bound", [None, 16])
def test_fused_intersect_mul_reduce(seed, key_bound):
    case = imr_case(seed)
    ref = rco.fused_intersect_mul_reduce(*map(j, case), 32,
                                         key_bound=key_bound)
    got = co.fused_intersect_mul_reduce(*map(t, case), 32,
                                        key_bound=key_bound)
    assert_same(ref, got)


# -- accumulate_coo ---------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("key_bound", [None, 64])
def test_accumulate_coo(seed, key_bound):
    rng = np.random.default_rng(seed)
    rk, rv = np.zeros(0, np.int64), np.zeros(0, np.float32)
    pk, pv = rk, rv
    for n in (0, 9, 9):                  # an empty partial is an identity
        keys = rng.integers(0, 64, n)
        vals = rng.integers(-3, 4, n).astype(np.float64)   # cast to f32
        rk, rv = rco.accumulate_coo(rk, rv, keys, vals, key_bound=key_bound)
        pk, pv = co.accumulate_coo(pk, pv, keys, vals, key_bound=key_bound,
                                   device="cpu")
        assert_same((rk, rv), (pk, pv))
        assert pv.dtype == np.float32 and pk.dtype == np.int64


# -- convert_level / canonical_tree -----------------------------------------

def _unpack(ft):
    """A reference tree as plain arrays (the ``tree_from_arrays`` form)."""
    return dict(shape=ft.shape, mode_order=ft.mode_order, vals=ft.vals,
                levels=[{"format": lv.format, "dim": lv.dim, "seg": lv.seg,
                         "crd": lv.crd, "words": lv.words}
                        for lv in ft.levels])


@pytest.mark.parametrize("fmt", ["hh", "mm", "dh", "cm", "bb", "ss", "sc",
                                 "hmc"])
def test_convert_level_and_canonical_tree(fmt):
    rng = np.random.default_rng(len(fmt) * 7 + ord(fmt[0]))
    shape = (5, 70, 3)[:len(fmt)]
    dense = ((rng.random(shape) < 0.3) * rng.integers(1, 9, shape)
             ).astype(float)
    ref_ft = RFiberTree.from_dense(dense, fmt)
    got_ft = tree_from_arrays(**_unpack(ref_ft))
    np.testing.assert_array_equal(got_ft.to_dense(), dense)
    if "s" not in fmt:
        num_parents = 1
        for rl, gl in zip(ref_ft.levels, got_ft.levels):
            rlv = rco.convert_level(rl, num_parents)
            glv = co.convert_level(gl, num_parents)
            assert glv.format == rlv.format
            for name in ("seg", "crd"):
                if getattr(rlv, name) is not None:
                    np.testing.assert_array_equal(getattr(glv, name),
                                                  getattr(rlv, name))
            num_parents = (num_parents * rlv.dim if rlv.format == "dense"
                           else len(rlv.crd))
    canon = canonical_tree(got_ft)
    assert set(canon.format_str) <= set("dc")
    np.testing.assert_array_equal(canon.to_dense(), dense)


# -- coo_to_levels ----------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_coo_to_levels(seed):
    rng = np.random.default_rng(seed)
    dims = [4, 5, 3]
    n = 20
    keys = np.unique(rng.integers(0, 60, n)).astype(np.int64)
    m = len(keys)
    valid = np.ones(m + 3, bool)
    valid[m:] = False
    keys = np.concatenate([keys, np.full(3, co.PAD_KEY, np.int64)])
    caps = [8, 32, 32]
    ref = rco.coo_to_levels(j(keys), j(valid), dims, caps)
    got = co.coo_to_levels(t(keys), t(valid), dims, caps)
    for part in range(3):
        for a, b in zip(ref[part], got[part]):
            assert_same(a, b, msg=f"part {part}")
