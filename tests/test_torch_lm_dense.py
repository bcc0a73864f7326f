"""The remaining dense LMs of the port — internlm2-20b, deepseek-coder-33b
and h2o-danube-1.8b (sliding window on every layer) — against the
reference's, on the CPU, at their SMOKE sizes (2 layers, d 64, 4 q heads
on 2 KV of 16; h2o's window 8, so 24 tokens cross it and a 12-token prompt
wraps its ring).  No new layer code: the configurations reach the mixers
the earlier families run.

* Configurations: CONFIG and SMOKE field for field, `param_count`,
  `active_param_count`, the layer kinds, `get_config` by either spelling.
* Forward: the reference's `init_params` carried across with `convert`,
  the same tokens; the reference at ``attn_impl="dense"`` and at
  ``"pallas"`` (interpret mode), the port at its dense path and at its
  flash path (the kernel's plain version here).
* Prefill (float32, logits and every cache leaf), `decode_step` for 4
  tokens continuing the reference's own prefill cache, and the port's
  prefill + decode against its own forward at the reference's bar (1e-3,
  `tests/test_archs.py`).
* `init_params` and `init_cache` in the reference's layout.

Tolerances (`test_torch_lm_util`): float32 logits and cache leaves to
5e-5 (products summed in other orders); bfloat16 logits to 0.25 max, 0.02
mean and top-1 on 85% of positions, the bar of
`tests/test_torch_models.py`.
"""
import pytest

import test_torch_lm_util as U

ARCHS = ("internlm2_20b", "deepseek_coder_33b", "h2o_danube_1_8b")
DTYPES = ("float32", "bfloat16")


@pytest.mark.parametrize("name", ["CONFIG", "SMOKE"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch, name):
    U.check_config(arch, name)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ref_impl,port_impl", [
    ("dense", "dense"), ("dense", "auto"), ("pallas", "auto")])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, ref_impl, port_impl, dtype):
    U.check_forward(arch, ref_impl, port_impl, dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch):
    U.check_prefill(arch)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_on_reference_cache_matches_reference(arch, dtype):
    U.check_decode_on_ref_cache(arch, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_own_prefill_decode_matches_own_forward(arch, dtype):
    errs = U.own_generation_errors(arch, dtype)
    assert max(errs) <= 1e-3, errs


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_and_cache_in_reference_layout(arch):
    U.check_init_layout(arch)

