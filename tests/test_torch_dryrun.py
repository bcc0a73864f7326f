"""`launch.dryrun` (ROADMAP §1 item 13) on internlm2's SMOKE model with
a (4, 2) ("data", "model") mesh over an 8-rank ``fake`` process group in
this process, against the reference's `repro.launch.dryrun.lower_cell`
lowering the same steps with the same shardings on 8 host devices (one
child process for its three cells): the per-chip argument bytes equal
`compiled.memory_analysis().argument_size_in_bytes` exactly,
`model_flops` exactly, and the flops per chip stand to the reference's
`hlo_cost` at the ratio measured here, within ±10% (whole heads per
rank in the port's attention; the reference's decode rewrites its
ring).  Then the depth
extrapolation against a deeper trace, and the CLI's skip record."""
import json
import os
import subprocess
import sys
import textwrap

import jax  # noqa: F401  (the reference runs beside the port)
import pytest
import torch  # noqa: F401
import torch.distributed as dist

from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")
ARCH = "internlm2_20b"
SHAPES = ("train_4k", "prefill_32k", "decode_32k")
# flops per chip, this port's over the reference's hlo_cost, as measured
# (torch 2.13 CPU, jax 0.9); all three outside 0.8-1.25 (ROADMAP §3 item
# 6): the port's attention runs with whole heads on every "model" rank
# (the batch split alone, which DTensor needs to fold (batch, heads) in
# torch 2.11), and the reference's decode rewrites and converts its whole
# KV ring every step
FLOPS_RATIO = {"train_4k": 1.667, "prefill_32k": 1.706, "decode_32k": 0.181}
TIMEOUT_S = 300

REFERENCE = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax
    import repro.launch.dryrun as D
    from repro.configs import get_smoke_config
    D.make_production_mesh = lambda multi_pod=False: jax.sharding.Mesh(
        np.array(jax.devices()[:8]).reshape(4, 2), ("data", "model"))
    D.get_config = get_smoke_config
    out = {}
    for shape in sys.argv[2].split(","):
        r = D.lower_cell(sys.argv[1], shape, verbose=False)
        out[shape] = dict(args=r["memory"]["argument_bytes"],
                          model_flops=r["model_flops_global"],
                          flops=r["flops_per_chip"])
    print("REF " + json.dumps(out))
""")


def test_cli_writes_the_skip_record(tmp_path):
    """Runs before the module's group exists: a skipped cell needs none,
    and the CLI leaves no group behind."""
    out = tmp_path / "dry.jsonl"
    recs = dryrun.main(["--arch", ARCH, "--shape", "long_500k", "--out",
                        str(out)])
    assert recs[0]["status"] == "skipped" and "sub-quadratic" in \
        recs[0]["reason"]
    assert json.loads(out.read_text()) == recs[0]
    assert not dist.is_initialized()


@pytest.fixture(scope="module")
def reference():
    """The reference child starts at once; its results are read when a
    test first needs them."""
    proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, ARCH, ",".join(SHAPES)],
        env=dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    cache = {}

    def get():
        if not cache:
            try:
                out, err = proc.communicate(timeout=TIMEOUT_S)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
            assert proc.returncode == 0, err[-4000:]
            line = [ln for ln in out.splitlines() if ln.startswith("REF ")]
            cache.update(json.loads(line[0][4:]))
        return cache
    yield get
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def mesh(reference):
    dryrun.fake_world(8)
    try:
        yield make_mesh((4, 2), ("data", "model"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("shape", SHAPES)
def test_cell_equals_the_reference(mesh, reference, shape):
    rec = dryrun.lower_cell(ARCH, shape, mesh=mesh,
                            config=configs.get_smoke_config, verbose=False)
    want = reference()[shape]
    assert rec["status"] == "ok" and rec["chips"] == 8
    assert rec["memory"]["argument_bytes"] == want["args"]
    assert rec["model_flops_global"] == want["model_flops"]
    ratio = rec["flops_per_chip"] / want["flops"]
    assert abs(ratio / FLOPS_RATIO[shape] - 1) <= 0.10, ratio
    assert rec["unparsed_loops"] == 0 and rec["lower_s"] is None
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"]
    assert rec["terms"]["dominant"] in ("compute", "memory", "collective")
    assert rec["hlo_flops_global"] == rec["flops_per_chip"] * 8
    if shape == "train_4k":
        assert rec["collective_detail"]["counts"]["reduce-scatter"] > 0


@pytest.mark.parametrize("shape", ["decode_32k", "prefill_32k"])
def test_depth_extrapolation_equals_a_deeper_trace(mesh, shape):
    """Traces at 1 and 2 cycles extrapolated to 3 equal a trace at 3:
    every count exactly, the peak of live bytes within 1% (the op at
    which the peak falls may move with depth: 0.49% at prefill)."""
    import dataclasses
    cfg, info, m, rules = dryrun.build_cell(
        ARCH, shape, multi_pod=False, mesh=mesh,
        config=configs.get_smoke_config)
    one, two, three = (dryrun._trace(
        dataclasses.replace(cfg, num_layers=k), info, m, rules, shape)
        for k in (1, 2, 3))
    got = dryrun._extrapolate(one, two, 3, three["argument_bytes"])
    for key in dryrun._ADDITIVE + ("coll_by_kind", "coll_counts"):
        assert got[key] == three[key], key
    assert abs(got["peak_live_bytes"] / three["peak_live_bytes"] - 1) \
        <= 0.01
