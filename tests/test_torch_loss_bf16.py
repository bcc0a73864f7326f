"""The loss and its gradient in bfloat16 compute against the reference,
one smoke config per family (here dense, MoE and VLM; the SSM, hybrid
and encoder-decoder ones in `test_torch_loss_bf16_recurrent.py`), from
the same float32 parameters: the port's distance from the float32 loss
and gradient is held to 3x the reference's own bfloat16 distance
(`test_torch_lm_util.check_loss_bfloat16`; measured ratios 0.05–0.82 on
the loss and 0.89–1.42 on the gradient over the six configs).
"""
import jax  # noqa: F401  (the port's tests import both frameworks)
import pytest
import torch  # noqa: F401

import test_torch_lm_util as U


@pytest.mark.parametrize("arch", ["gemma3_1b", "granite_moe_1b_a400m",
                                  "internvl2_76b"])
def test_loss_and_grad_bfloat16_within_reference_distance(arch):
    U.check_loss_bfloat16(arch)
