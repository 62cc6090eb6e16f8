"""The division ``coo_to_levels``'s kernel runs, emulated on the CPU.

For a non-negative key the kernel (``kernels/csrc/coo_levels.cu``) takes
``floor(k / s)`` by every suffix product ``s`` of the level extents as a
shift or as ``umulhi(magic, k) >> shift`` with the (magic, shift) that the
wrapper's ``_divisor`` computes on the host. This file emulates that
integer arithmetic exactly in Python and holds it to ``k // s``: for every
divisor that the repo's tests and ``chip_smoke.py``'s phases give the
kernel, for 10^5 random pairs with ``k < 2**63``, and at the edges.
"""
import math

import numpy as np
import pytest

from repro_torch.kernels import coo_levels

INT64_MAX = (1 << 63) - 1

# the level extents of chip_smoke.py's (k), (l), (l2) and of the coo tests
# (test_torch_gpu, test_torch_program, test_torch_coord_ops)
DIMS_USED = [
    [16384, 16384],
    [4096, 1 << 25, 8],
    [4099, 33554393, 7],
    [6, 7, 5],
    [5, (1 << 24) + 3, 4],
    [300, 64, 9],
    [7, 13, 5],
    [4, 5, 3],
    [12, 12],
    [8, 8],
]


def device_quot(k: int, d: int) -> int:
    """What the kernel computes for 0 <= k < 2**63: 64-bit registers, the
    high half of a 64 x 64-bit product, then a shift."""
    magic, shift = coo_levels._divisor(d)
    assert 0 <= magic < 1 << 64 and 0 <= shift < 64
    if magic == 0:
        return k >> shift
    return ((magic * k) >> 64) >> shift


def _divisors_used():
    out = set()
    for dims in DIMS_USED:
        for j in range(len(dims) + 1):
            out.add(math.prod(dims[j:]))
    return sorted(out)


def _edge_keys(d: int):
    keys = {0, 1, d - 1, d, d + 1, INT64_MAX, INT64_MAX - 1, INT64_MAX - d}
    q_max = INT64_MAX // d
    for q in (1, 2, 3, q_max // 2, q_max - 1, q_max):
        keys |= {d * q - 1, d * q, d * q + 1}
    return sorted(k for k in keys if 0 <= k <= INT64_MAX)


@pytest.mark.parametrize("d", _divisors_used())
def test_divisors_the_repo_uses(d):
    rng = np.random.default_rng(d % (1 << 32))
    keys = _edge_keys(d) + [int(k) for k in rng.integers(0, INT64_MAX, 2000,
                                                         dtype=np.int64)]
    for k in keys:
        assert device_quot(k, d) == k // d, (k, d)


def test_random_pairs():
    rng = np.random.default_rng(15)
    # divisors of every magnitude, and keys of every magnitude below 2**63
    d_bits = rng.integers(1, 64, 100_000)
    k_bits = rng.integers(1, 64, 100_000)
    d_raw = rng.integers(0, INT64_MAX, 100_000, dtype=np.int64)
    k_raw = rng.integers(0, INT64_MAX, 100_000, dtype=np.int64)
    for db, kb, dr, kr in zip(d_bits, k_bits, d_raw, k_raw):
        d = max(int(dr) >> (63 - int(db)), 1)
        k = int(kr) >> (63 - int(kb))
        assert device_quot(k, d) == k // d, (k, d)


@pytest.mark.parametrize("d", [1, 2, 3, 5, 7, 1 << 20, (1 << 20) + 1,
                               (1 << 62) - 1, 1 << 62, (1 << 62) + 1,
                               INT64_MAX - 1, INT64_MAX])
def test_edges(d):
    for k in _edge_keys(d):
        assert device_quot(k, d) == k // d, (k, d)


@pytest.mark.parametrize("s", range(63))
def test_powers_of_two_are_shifts(s):
    assert coo_levels._divisor(1 << s) == (0, s)


def test_divisor_refuses_what_int64_does_not_hold():
    for d in (0, -3, 1 << 63):
        with pytest.raises(ValueError):
            coo_levels._divisor(d)
