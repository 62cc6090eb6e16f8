"""The columns of a packed leaf that each model shard takes for its own
heads (``sharding.packed_columns``), against the reference's segment
slicing, and ``sharding.packed_path``'s byte rule. Pure, no processes.

Four leaves pack segments of unequal width along the axis the model axis
splits: mamba2's ``in_proj`` (``[z | x | B | C | dt]``) and ``conv_w``
(``[x | B | C]``), cut by ``repro.models.mamba2._split`` and its
``xbc`` slices, and mLSTM's ``w_up`` (``[xi | gate]``) and ``w_if``
(``[i | f]``), cut as ``repro.models.xlstm.mlstm`` cuts them. A column
vector of indices cut the reference's way, each per-head segment
reshaped to its heads and the shard's heads taken, must give the
helper's columns, at full width and at the placement tests' widths, on
model axes of 2 and 16.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

from test_torch_placement import WIDE  # noqa: E402

from repro.models import mamba2 as ref_mamba2  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402

CASES = {"zamba2-2.7b": ("zamba2-2.7b", {}),
         "xlstm-125m": ("xlstm-125m", {}),
         "zamba2-2.7b-tp": WIDE["zamba2-2.7b-tp"],
         "xlstm-125m-tp": WIDE["xlstm-125m-tp"]}
LEAVES = {"zamba2": ("in_proj", "conv_w"), "xlstm": ("w_up", "w_if")}
PAIRS = [(case, leaf) for case in CASES
         for leaf in LEAVES[case.split("-")[0]]]


def _cfg(case):
    arch, widths = CASES[case]
    return dataclasses.replace(get_config(arch, reduced=bool(widths)),
                               **widths)


def _heads(cols, n_heads, rank, size):
    """The columns of heads ``rank·H/size`` to ``(rank+1)·H/size`` of a
    segment of ``n_heads`` equal heads."""
    per = n_heads // size
    return cols.reshape(n_heads, -1)[rank * per:(rank + 1) * per].ravel()


def _reference_columns(leaf, cfg, rank, size):
    """``leaf``'s columns for model shard ``rank`` of ``size``, cut as the
    reference cuts its segments; with the widths and heads of each."""
    if leaf in ("in_proj", "conv_w"):
        d_inner = cfg.ssm_expand * cfg.d_model
        h = d_inner // cfg.ssm_headdim
        gn = cfg.ssm_state                                  # n_groups 1
        if leaf == "in_proj":
            z, xbc, dt = ref_mamba2._split(np.arange(2 * d_inner + 2 * gn + h),
                                           d_inner, gn)
            widths, heads = (d_inner, d_inner, gn, gn, h), (h, h, None,
                                                             None, h)
        else:
            xbc = np.arange(d_inner + 2 * gn)
            widths, heads = (d_inner, gn, gn), (h, None, None)
        x, b, c = (xbc[:d_inner], xbc[d_inner:d_inner + gn],
                   xbc[d_inner + gn:])
        parts = [_heads(x, h, rank, size), b, c]
        if leaf == "in_proj":
            parts = ([_heads(z, h, rank, size)] + parts
                     + [_heads(dt, h, rank, size)])
        return np.concatenate(parts), widths, heads
    h = cfg.n_heads
    d_inner = 2 * cfg.d_model                        # proj_factor 2.0
    if leaf == "w_up":
        up = np.arange(2 * d_inner)
        xi, gate = up[:d_inner], up[d_inner:]
        return (np.concatenate([xi, _heads(gate, h, rank, size)]),
                (d_inner, d_inner), (None, h))
    if_ = np.arange(2 * h)
    i, f = if_[:h], if_[h:]
    return (np.concatenate([_heads(i, h, rank, size),
                            _heads(f, h, rank, size)]), (h, h), (h, h))


@pytest.mark.parametrize("size", [2, 16])
@pytest.mark.parametrize("case,leaf", PAIRS)
def test_packed_columns_are_the_reference_segments_of_own_heads(
        case, leaf, size):
    cfg = _cfg(case)
    _, widths, heads = _reference_columns(leaf, cfg, 0, 1)
    n_heads = next(h for h in heads if h is not None)
    if n_heads % size:
        # the model axis does not divide the heads: the layer runs whole
        with pytest.raises(ValueError):
            sharding.packed_columns(widths, heads, 0, size)
        return
    seen = set()
    for rank in range(size):
        want, _, _ = _reference_columns(leaf, cfg, rank, size)
        got = sharding.packed_columns(widths, heads, rank, size)
        np.testing.assert_array_equal(got, want)
        seen.update(got.tolist())
    # every column reaches some shard; on one shard, every column in order
    assert seen == set(range(sum(widths)))
    np.testing.assert_array_equal(
        sharding.packed_columns(widths, heads, 0, 1), np.arange(sum(widths)))


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-125m"])
def test_packed_path_follows_its_byte_rule(arch, shape):
    """On (16, 16), a data shard's tokens: the float32 packed weight
    (``in_proj``, ``w_up``) gathered at train_4k (65,536 tokens), the
    bfloat16 product's output at decode_32k (8 tokens)."""
    cfg, sh = get_config(arch), SHAPES[shape]
    tokens = sh.global_batch * (1 if sh.kind == "decode" else sh.seq_len) // 16
    got = sharding.packed_path(cfg.d_model, tokens, 4, 2)
    rule = "weight" if cfg.d_model * 4 <= tokens * 2 else "activation"
    assert got == rule == {"train_4k": "weight",
                           "decode_32k": "activation"}[shape]
