"""Table 1, second half: see ``test_torch_table1.py``."""
import pytest

pytest.importorskip("jax")

from test_custard_table1 import CASES  # noqa: E402
from test_torch_table1 import HALF, check_table1_case  # noqa: E402


@pytest.mark.parametrize("name,expr,order,fmts,expected", CASES[HALF:],
                         ids=[c[0] for c in CASES[HALF:]])
def test_table1_matches_reference_simulator_and_numpy(name, expr, order,
                                                      fmts, expected):
    check_table1_case(name, expr, order, fmts)
