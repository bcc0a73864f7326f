"""`launch.roofline` against `repro.launch.roofline`: `model_flops`
exactly for the 11 configs x 4 shapes; `terms` equal to the reference's
formula once the reference module's three constants are set, in this
test only, to the card's (H100 SXM data sheet: 989 TFLOP/s bf16,
3.35 TB/s, 450 GB/s NVLink)."""
import pytest

import repro.configs as ref_configs
import repro.launch.roofline as ref_roofline
import repro.launch.specs as ref_specs
from repro_torch import configs
from repro_torch.launch import roofline, specs


@pytest.mark.parametrize("shape", list(specs.SHAPES))
def test_model_flops_equal_the_reference(shape):
    for arch in configs.ARCHS:
        cfg = specs.shape_overrides(configs.get_config(arch), shape)
        rcfg = ref_specs.shape_overrides(ref_configs.get_config(arch), shape)
        got = roofline.model_flops(cfg, specs.SHAPES[shape])
        assert got == ref_roofline.model_flops(rcfg,
                                               ref_specs.SHAPES[shape])
        assert got > 0


def test_constants_are_the_cards():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (
        989e12, 3.35e12, 450e9)


@pytest.mark.parametrize("flops, nbytes, coll", [
    (1e15, 1e9, 1e6), (1e9, 1e12, 1e6), (1e9, 1e9, 1e12), (0.0, 0.0, 0.0),
    (3.1e14, 1.2e12, 5.5e11)])
def test_terms_equal_the_reference_formula(monkeypatch, flops, nbytes,
                                           coll):
    monkeypatch.setattr(ref_roofline, "PEAK_FLOPS", roofline.PEAK_FLOPS)
    monkeypatch.setattr(ref_roofline, "HBM_BW", roofline.HBM_BW)
    monkeypatch.setattr(ref_roofline, "ICI_BW", roofline.LINK_BW)
    assert roofline.terms(flops, nbytes, coll) == \
        ref_roofline.terms(flops, nbytes, coll)
