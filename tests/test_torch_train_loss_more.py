"""The port's loss and gradients against the reference's, on the CPU:
the other half of the registered architectures
(``tests/test_torch_train_loss.py`` holds the first half, the helpers
and the tolerances)."""
import pytest

pytest.importorskip("jax")

from test_torch_train_loss import (ARCHS, HALF,  # noqa: E402
                                   check_against_reference)


@pytest.mark.parametrize("arch", [a for a in ARCHS if a not in HALF])
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_loss_and_gradients_equal_the_reference(arch, compute):
    check_against_reference(arch, compute)
