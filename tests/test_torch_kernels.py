"""The port's kernel modules against the reference's Pallas kernels.

Each kernel's plain PyTorch version (what a wrapper runs on a CPU tensor)
must equal the reference Pallas kernel run with ``interpret=True`` and the
reference's JAX fallback, bit for bit, on integer-valued data: tile edges,
empty inputs, all-padding rows, and the inf/nan garbage at masked rows
that ``mul_pair`` must not let through. The dispatch table keeps the
reference's fallback-first rule. The CUDA kernels themselves are held
against their plain versions on the card in ``test_torch_gpu.py``.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import coord_ops as rco  # noqa: E402
from repro.kernels import ops as rkops  # noqa: E402
from repro.kernels.fused_stream import fused_imr_workspace as r_fused  # noqa: E402
from repro.kernels.scatter_workspace import scatter_workspace as r_sw  # noqa: E402
from repro.kernels.segment_reduce import segment_reduce as r_seg  # noqa: E402
from repro_torch.core import coord_ops as co  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels.fused_stream import (  # noqa: E402
    fused_imr_workspace, fused_imr_workspace_plain)
from repro_torch.kernels.scatter_workspace import scatter_workspace  # noqa: E402
from repro_torch.kernels.segment_reduce import (  # noqa: E402
    segment_reduce, segment_reduce_mul, segment_reduce_plain)

I32_MAX = np.iinfo(np.int32).max


def t(a):
    return torch.as_tensor(np.asarray(a))


def same(ref, got, msg=""):
    a = np.asarray(ref)
    b = got.float().numpy() if got.dtype == torch.bfloat16 else got.numpy()
    assert a.shape == b.shape, f"{msg}: {a.shape} != {b.shape}"
    np.testing.assert_array_equal(a.astype(np.float64), b.astype(np.float64),
                                  err_msg=msg)


# -- scatter_workspace ------------------------------------------------------

SW_CASES = [  # (n, num_slots, mul_pair, pad_share or "runs")
    (1, 1, False, 0.0), (1023, 37, False, 0.2), (1025, 37, True, 0.2),
    (700, 5, True, 1.0),                   # every row aims at the pad slot
    (64, 64, False, 0.0),
    # a model block's down stage: each bucket's 16 slots repeated under 3
    # values of an outer index, dropped rows between the buckets
    (1100, 48, True, "runs"),
]


@pytest.mark.parametrize("n,slots,mul_pair,pad", SW_CASES)
def test_scatter_workspace_plain_equals_pallas(n, slots, mul_pair, pad):
    rng = np.random.default_rng(n + slots)
    if pad == "runs":
        width, reps, gap = 16, 3, 20
        r = np.arange(n) % (slots // width * (width * reps + gap))
        bucket, off = np.divmod(r, width * reps + gap)
        ids = np.where(off < width * reps, bucket * width + off % width,
                       slots).astype(np.int32)
    else:
        ids = rng.integers(0, slots, n).astype(np.int32)
        ids[rng.random(n) < pad] = slots
    c = 3 if mul_pair else 2
    cols = rng.integers(-4, 5, (n, c)).astype(np.float32)
    if mul_pair:
        cols[:, 2] = rng.random(n) < 0.7
    ref = r_sw(jnp.asarray(ids), jnp.asarray(cols), num_slots=slots,
               mul_pair=mul_pair, interpret=True)
    got = scatter_workspace(t(ids), t(cols), num_slots=slots,
                            mul_pair=mul_pair)
    assert got.dtype == torch.float32
    same(ref, got, "scatter_workspace")


def test_scatter_workspace_mul_pair_masks_garbage():
    """inf/nan at masked rows must not reach the sums: the mask comes
    before the product."""
    ids = np.asarray([0, 1, 2, 3], np.int32)
    cols = np.asarray([[2.0, 3.0, 1.0], [np.nan, np.inf, 0.0],
                       [np.inf, np.nan, 0.0], [4.0, 5.0, 1.0]], np.float32)
    ref = r_sw(jnp.asarray(ids), jnp.asarray(cols), num_slots=4,
               mul_pair=True, interpret=True)
    got = scatter_workspace(t(ids), t(cols), num_slots=4, mul_pair=True)
    same(ref, got, "nan masking")
    assert torch.isfinite(got).all()


def test_scatter_workspace_empty_input():
    got = scatter_workspace(torch.zeros(0, dtype=torch.int32),
                            torch.zeros((0, 2)), num_slots=6)
    assert got.shape == (6, 2) and not got.any()


# -- segment_reduce ---------------------------------------------------------

SEG_CASES = [  # (n, d, s, dtype)
    (1, 1, 1, np.float32), (511, 1, 7, np.float32),
    (513, 130, 5, np.float32),             # crosses t_tile=512 and d_tile=128
    (600, 3, 40, np.float16), (300, 2, 9, "bfloat16"),
]


@pytest.mark.parametrize("n,d,s,dtype", SEG_CASES)
def test_segment_reduce_plain_equals_pallas(n, d, s, dtype):
    rng = np.random.default_rng(n * d + s)
    ids = rng.integers(0, s + 1, n).astype(np.int32)    # s = padding id
    vals = rng.integers(-4, 5, (n, d)).astype(np.float32)
    if dtype == "bfloat16":
        jv, tv = jnp.asarray(vals, jnp.bfloat16), t(vals).to(torch.bfloat16)
    else:
        jv, tv = jnp.asarray(vals.astype(dtype)), t(vals.astype(dtype))
    ref = r_seg(jv, jnp.asarray(ids), num_segments=s, interpret=True)
    got = segment_reduce(tv, t(ids), num_segments=s)
    assert got.dtype == tv.dtype
    same(np.asarray(ref, np.float32), got, "segment_reduce")
    # and the reference's plain fallback (jax.ops.segment_sum)
    same(rco.default_segment_sum(jnp.asarray(vals), jnp.asarray(ids), s),
         segment_reduce_plain(t(vals), t(ids), num_segments=s), "fallback")


def test_segment_reduce_all_padding_and_empty():
    ids = np.full(20, 4, np.int32)
    vals = np.ones((20, 2), np.float32)
    ref = r_seg(jnp.asarray(vals), jnp.asarray(ids), num_segments=4,
                interpret=True)
    got = segment_reduce(t(vals), t(ids), num_segments=4)
    same(ref, got, "all padding")
    assert not got.any()
    empty = segment_reduce(torch.zeros((0, 3)), torch.zeros(0, dtype=torch.int32),
                           num_segments=5)
    assert empty.shape == (5, 3) and not empty.any()


def test_segment_reduce_float64_keeps_precision():
    vals = torch.tensor([[1.0], [1e-12], [3.0]], dtype=torch.float64)
    out = segment_reduce(vals, torch.tensor([0, 0, 1]), num_segments=2)
    assert out.dtype == torch.float64 and out[0, 0] == 1.0 + 1e-12


MUL_CASES = [(1, 1, True), (700, 9, True), (2049, 37, False)]  # (n, s, b)


@pytest.mark.parametrize("n,s,with_b", MUL_CASES)
def test_segment_reduce_mul_plain_equals_pallas(n, s, with_b):
    """The [a*b, 1] mode's plain version against the reference kernel
    (interpret mode) on the [a*b, 1] rows numpy forms from the same
    streams: masked rows carry inf/nan garbage in a and b, and keys
    outside [0, S) add nothing."""
    rng = np.random.default_rng(n + s)
    keys = rng.integers(-2, s + 3, n).astype(np.int64)
    valid = rng.random(n) < 0.7
    a = rng.integers(-4, 5, n).astype(np.float32)
    b = rng.integers(-4, 5, n).astype(np.float32)
    a[~valid] = np.nan
    b[~valid] = np.inf
    live = valid & (keys >= 0) & (keys < s)
    with np.errstate(invalid="ignore"):
        prod = np.where(live, a * b if with_b else a, 0.0)
    rows = np.stack([prod, live], 1).astype(np.float32)
    ids = np.where(live, keys, s).astype(np.int32)
    ref = r_seg(jnp.asarray(rows), jnp.asarray(ids), num_segments=s,
                interpret=True)
    got = segment_reduce_mul(t(keys), t(a), t(b) if with_b else None,
                             t(valid), num_segments=s)
    same(ref, got, "segment_reduce_mul")


def test_kernels_refuse_integer_payloads():
    with pytest.raises(TypeError):
        segment_reduce(torch.ones((3, 1), dtype=torch.int32),
                       torch.zeros(3, dtype=torch.int32), num_segments=1)
    with pytest.raises(TypeError):
        scatter_workspace(torch.zeros(3, dtype=torch.int32),
                          torch.ones((3, 2), dtype=torch.int64), num_slots=1)


# -- fused_imr_workspace ----------------------------------------------------

def stream_pair(seed, na, nb, space, slots):
    """Level-scanner-shaped pair: valid keys strictly increasing, padding
    at the tail of each stream."""
    rng = np.random.default_rng(seed)
    la = int(rng.integers(0, min(na, space) + 1))
    lb = int(rng.integers(0, min(nb, space) + 1))
    a_key = np.full(na, co.PAD_KEY, np.int64)
    a_key[:la] = np.sort(rng.choice(space, la, replace=False))
    b_key = np.full(nb, co.PAD_KEY, np.int64)
    b_key[:lb] = np.sort(rng.choice(space, lb, replace=False))
    a_vals = rng.integers(-4, 5, na).astype(np.float32)
    b_vals = np.where(np.arange(nb) < lb,
                      rng.integers(-4, 5, nb), 0).astype(np.float32)
    out_key = rng.integers(0, slots, na).astype(np.int64)
    return a_key, a_vals, out_key, b_key, b_vals


@pytest.mark.parametrize("na,nb,slots", [(1, 1, 1), (511, 40, 16),
                                         (513, 300, 33), (64, 64, 8)])
def test_fused_imr_plain_equals_pallas(na, nb, slots):
    a_key, a_vals, out_key, b_key, b_vals = stream_pair(na + nb, na, nb,
                                                        1000, slots)
    # the Pallas kernel keys invalid rows with int32 max, the port int64 max
    r32 = (lambda k: np.where(k == co.PAD_KEY, I32_MAX, k).astype(np.int32))
    ref = r_fused(jnp.asarray(r32(a_key)), jnp.asarray(a_vals),
                  jnp.asarray(out_key), jnp.asarray(r32(b_key)),
                  jnp.asarray(b_vals), num_slots=slots, interpret=True)
    got = fused_imr_workspace(t(a_key), t(a_vals), t(out_key), t(b_key),
                              t(b_vals), num_slots=slots)
    same(ref, got, "fused_imr")
    same(ref, fused_imr_workspace_plain(t(a_key), t(a_vals), t(out_key),
                                        t(b_key), t(b_vals),
                                        num_slots=slots), "plain")


def test_fused_imr_keys_beyond_int32():
    """int64 keys are not narrowed (the reference casts them to int32)."""
    big = 1 << 40
    a_key = torch.tensor([big, big + 1, co.PAD_KEY])
    b_key = torch.tensor([big + 1, co.PAD_KEY])
    out = fused_imr_workspace(a_key, torch.tensor([2.0, 3.0, 9.0]),
                              torch.tensor([0, 1, 0]), b_key,
                              torch.tensor([5.0, 0.0]), num_slots=2)
    assert out.tolist() == [[0.0, 0.0], [15.0, 1.0]]


def test_fused_imr_empty_streams():
    got = fused_imr_workspace(torch.full((8,), co.PAD_KEY),
                              torch.ones(8), torch.zeros(8, dtype=torch.int64),
                              torch.zeros(0, dtype=torch.int64),
                              torch.zeros(0), num_slots=4)
    assert got.shape == (4, 2) and not got.any()


# -- the dispatch entries on CPU tensors (the wrappers' plain paths) --------

def keyed_stream(seed, n=80, bound=40):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, bound, n).astype(np.int64)
    vals = rng.integers(-4, 5, n).astype(np.float32)
    valid = rng.random(n) < 0.7
    return keys, vals, valid, bound


def assert_union_equal(ref, got, msg):
    for a, b, part in zip(ref, got, ("keys", "vals", "valid", "count")):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                      err_msg=f"{msg}: {part}")


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("dense", [True, False])
def test_union_reduce_entry_equals_reference(seed, dense):
    keys, vals, valid, bound = keyed_stream(seed)
    kb = bound if dense else co.DENSE_REDUCE_BOUND + 1
    args = (keys, vals, valid)
    got = kops._keyed_union_reduce_cuda(*map(t, args), 48, key_bound=kb)
    ref = rco.keyed_union_reduce(*map(jnp.asarray, args), 48, key_bound=kb)
    assert_union_equal(ref, got, "fallback")
    if dense:      # inside the reference's 4096-slot guard: Pallas runs
        pal = rkops._keyed_union_reduce_pallas(*map(jnp.asarray, args), 48,
                                               key_bound=kb)
        assert_union_equal(pal, got, "pallas")


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("dense", [True, False])
def test_mul_reduce_entry_equals_reference(seed, dense):
    keys, a, valid, bound = keyed_stream(seed)
    b = np.random.default_rng(seed + 9).integers(-4, 5, len(a)).astype(
        np.float32)
    a[~valid] = np.nan                       # garbage at masked rows
    kb = bound if dense else co.DENSE_REDUCE_BOUND + 1
    args = (keys, a, b, valid)
    got = kops._mul_reduce_cuda(*map(t, args), 48, key_bound=kb)
    ref = rco.mul_reduce(*map(jnp.asarray, args), 48, key_bound=kb)
    assert_union_equal(ref, got, "fallback")
    if dense:
        pal = rkops._mul_reduce_pallas(*map(jnp.asarray, args), 48,
                                       key_bound=kb)
        assert_union_equal(pal, got, "pallas")


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("entry", ["union", "mul"])
@pytest.mark.parametrize("bound", ["segment", "sort"])
def test_reduce_entries_by_key_bound_equal_reference(seed, entry, bound):
    """Beyond the workspace kernel's bound the entries reduce densely on
    segment_reduce up to SEGMENT_DENSE_BOUND keys, then by the sort-merge:
    either way the reference's sort-merge result, bit for bit."""
    keys, a, valid, _ = keyed_stream(seed + 20)
    kb = (kops.SEGMENT_DENSE_BOUND if bound == "segment"
          else kops.SEGMENT_DENSE_BOUND + 1)
    keys = keys * (kb // 64)                 # spread over the key space
    if entry == "union":
        args = (keys, a, valid)
        got = kops._keyed_union_reduce_cuda(*map(t, args), 48, key_bound=kb)
        ref = rco.keyed_union_reduce(*map(jnp.asarray, args), 48,
                                     key_bound=kb)
    else:
        b = np.random.default_rng(seed).integers(-4, 5, len(a)).astype(
            np.float32)
        args = (keys, a, b, valid)
        got = kops._mul_reduce_cuda(*map(t, args), 48, key_bound=kb)
        ref = rco.mul_reduce(*map(jnp.asarray, args), 48, key_bound=kb)
    assert_union_equal(ref, got, f"{entry} at key bound {kb}")


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("dense", [True, False])
def test_intersect_mul_reduce_entry_equals_reference(seed, dense):
    a_key, a_vals, out_key, b_key, b_vals = stream_pair(seed, 60, 50, 90, 24)
    a_valid = a_key != co.PAD_KEY
    b_valid = b_key != co.PAD_KEY
    kb = 24 if dense else co.DENSE_REDUCE_BOUND + 1
    args = (a_key, a_valid, a_vals, b_key, b_valid, b_vals, out_key)
    got = kops._fused_imr_cuda(*map(t, args), 32, key_bound=kb)
    ref = rco.fused_intersect_mul_reduce(*map(jnp.asarray, args), 32,
                                         key_bound=kb)
    assert_union_equal(ref, got, "fallback")
    if dense:
        pal = rkops._fused_imr_pallas(*map(jnp.asarray, args), 32,
                                      key_bound=kb)
        assert_union_equal(pal, got, "pallas")


def test_keyed_segment_sum_entry_equals_reference():
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 12, 90).astype(np.int64)
    vals = rng.integers(-4, 5, 90).astype(np.float32)
    got = kops._keyed_segment_sum_cuda(t(vals), t(ids), 12)
    same(rco.default_segment_sum(jnp.asarray(vals), jnp.asarray(ids), 12),
         got, "segsum")
    same(rkops._keyed_segment_sum_pallas(jnp.asarray(vals),
                                         jnp.asarray(ids.astype(np.int32)),
                                         12), got, "pallas")


# -- dispatch table -----------------------------------------------------------

def test_every_primitive_has_a_fallback():
    assert set(kops.SAM_PRIMITIVES) == set(rkops.SAM_PRIMITIVES)
    for name, impls in kops.SAM_PRIMITIVES.items():
        assert "fallback" in impls, name
        assert kops.sam_primitive(name, "cpu") is impls["fallback"]
    cuda = {n for n, impls in kops.SAM_PRIMITIVES.items() if "cuda" in impls}
    assert cuda == {"keyed_segment_sum", "keyed_union_reduce", "mul_reduce",
                    "intersect_mul_reduce", "coo_to_levels"}


def test_register_primitive_requires_fallback_first():
    with pytest.raises(ValueError):
        kops.register_primitive("nonexistent_prim", "cuda", lambda: None)
    assert "nonexistent_prim" not in kops.SAM_PRIMITIVES
    try:
        kops.register_primitive("nonexistent_prim", "fallback",
                                co.mul_reduce)
        kops.register_primitive("nonexistent_prim", "cuda", co.mul_reduce)
        assert kops.sam_primitive("nonexistent_prim", "cpu") is co.mul_reduce
    finally:
        kops.SAM_PRIMITIVES.pop("nonexistent_prim", None)


def test_cpu_tensors_never_launch():
    kops.reset_launch_counts()
    keys, vals, valid, bound = keyed_stream(1)
    kops._keyed_union_reduce_cuda(t(keys), t(vals), t(valid), 48,
                                  key_bound=bound)
    kops._mul_reduce_cuda(t(keys), t(vals), t(vals), t(valid), 48,
                          key_bound=co.DENSE_REDUCE_BOUND + 1)
    # the block-sparse wrappers on CPU tensors run their plain versions
    blk = torch.ones((2, 2, 2))
    kops.spmm_bsr(torch.zeros((1, 1), dtype=torch.int32),
                  torch.zeros((1, 1), dtype=torch.int32), blk, torch.ones(2, 3))
    kops.sddmm_bsr(torch.zeros(1, dtype=torch.int32),
                   torch.zeros(1, dtype=torch.int32), torch.ones(2, 3),
                   torch.ones(2, 3), 2)
    q = torch.ones((1, 2, 4))
    kops.bsr_flash_attention(q, q, q, torch.zeros((1, 1), dtype=torch.int32),
                             bq=2, bkv=2)
    kops.SAM_PRIMITIVES["coo_to_levels"]["cuda"](
        torch.tensor([1, 5]), torch.ones(2, dtype=torch.bool), [3, 2], [2, 2])
    assert kops.launch_counts() == {
        "scatter_workspace": 0, "segment_reduce": 0, "fused_imr": 0,
        "spmm_bsr": 0, "sddmm_bsr": 0, "bsr_attention": 0,
        "coo_to_levels": 0}


def test_build_is_lazy_and_keyed_by_source_hash():
    assert _build._LIB is None               # importing built nothing
    names = [p.name for p in _build.sources()]
    assert names == ["bsr_attention.cu", "coo_levels.cu", "fused_stream.cu",
                     "scatter_workspace.cu", "sddmm_bsr.cu",
                     "segment_reduce.cu", "spmm_bsr.cu"]
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libsam_kernels_")
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
