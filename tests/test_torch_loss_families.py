"""The loss and its gradient against the reference (float32, the bars of
`test_torch_loss.py`) on the MoE, SSM, hybrid and encoder-decoder smoke
configs.  MoE routing is exact in float32 (`test_torch_moe.py`): a
flipped expert would move its gradients far past the bar."""
import jax  # noqa: F401  (the port's tests import both frameworks)
import pytest
import torch  # noqa: F401

import test_torch_lm_util as U


@pytest.mark.parametrize("arch", ["granite_moe_1b_a400m",
                                  "granite_moe_3b_a800m", "mamba2_130m",
                                  "recurrentgemma_9b", "whisper_base"])
def test_loss_and_grad_match_reference_float32(arch):
    U.check_loss_float32(arch)
