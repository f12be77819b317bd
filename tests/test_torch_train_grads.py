"""`loss_fn`'s gradients against the reference's for the second half of
the architectures (the first half and the method: `test_torch_train.py`).
"""
import pytest

from test_torch_models import ARCHS
from test_torch_train import hold_grads


@pytest.mark.parametrize("arch", ARCHS[5:])
def test_loss_gradients_match_reference(arch):
    hold_grads(arch)
