"""The loss and its gradient in bfloat16 compute against the reference,
one smoke config per family (here the SSM, hybrid and encoder-decoder
ones; dense, MoE and VLM in `test_torch_loss_bf16.py`), from the same
float32 parameters: the port's distance from the float32 loss and
gradient is held to 3x the reference's own bfloat16 distance
(`test_torch_lm_util.check_loss_bfloat16`).
"""
import jax  # noqa: F401  (the port's tests import both frameworks)
import pytest
import torch  # noqa: F401

import test_torch_lm_util as U


@pytest.mark.parametrize("arch", ["mamba2_130m", "recurrentgemma_9b",
                                  "whisper_base"])
def test_loss_and_grad_bfloat16_within_reference_distance(arch):
    U.check_loss_bfloat16(arch)
