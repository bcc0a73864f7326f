"""`distributed.pipeline.pipeline_apply` (ROADMAP §1 item 13), mirroring
the reference's `tests/test_distributed.py::test_pipeline_parallel_8dev`:
S = 4 stages on 4 gloo CPU ranks, B 8, D 16, ``tanh(h @ W)``.  With 4
and 8 microbatches every rank's result equals the sequential loop and
the reference's `pipeline_apply` on the same NumPy inputs (4 host
devices, one child process for both runs) to 1e-5, after M + S - 1
ticks."""
import json
import os
import subprocess
import sys
import textwrap

import jax  # noqa: F401  (the reference runs beside the port)
import numpy as np
import pytest
import torch  # noqa: F401

from repro_torch.distributed.ranks import run_ranks
from repro_torch.scripts import smoke_pipeline as P

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")
S, B, D = 4, 8, 16
MICROBATCHES = (4, 8)
TIMEOUT_S = 240

REFERENCE = textwrap.dedent("""
    import json, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.distributed.pipeline import pipeline_apply
    from repro.launch.mesh import make_mesh
    W, x = np.load(sys.argv[1]), np.load(sys.argv[2])
    mesh = make_mesh((%d,), ("stage",))
    def fn(w, h):
        return jnp.tanh(h @ w)
    out = {}
    for m in %r:
        y = pipeline_apply(fn, jnp.asarray(W), jnp.asarray(x), mesh=mesh,
                           microbatches=m)
        out[m] = np.asarray(y).tolist()
    print("REF " + json.dumps(out))
""" % (S, MICROBATCHES))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's results for each microbatch count, by one child."""
    tmp = tmp_path_factory.mktemp("pipeline")
    W, x = P.inputs(S, B, D, seed=0)
    np.save(tmp / "W.npy", W)
    np.save(tmp / "x.npy", x)
    proc = subprocess.run(
        [sys.executable, "-c", REFERENCE, str(tmp / "W.npy"),
         str(tmp / "x.npy")],
        env=dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
                 XLA_FLAGS=f"--xla_force_host_platform_device_count={S}"),
        capture_output=True, text=True, timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("REF ")]
    return {int(k): np.asarray(v, np.float32)
            for k, v in json.loads(line[0][4:]).items()}


@pytest.mark.parametrize("microbatches", MICROBATCHES)
def test_pipeline_equals_the_loop_and_the_reference(reference,
                                                    microbatches):
    W, x = P.inputs(S, B, D, seed=0)
    want = P.sequential(W, x)
    ranks = run_ranks(P.pipeline_rank, S, args=(W, x, microbatches),
                      timeout=TIMEOUT_S)
    for r, res in enumerate(ranks):
        assert res["y"].shape == (B, D)
        np.testing.assert_allclose(res["y"], want, atol=1e-5)
        np.testing.assert_allclose(res["y"], reference[microbatches],
                                   atol=1e-5)
        st = res["stats"]
        assert st["ticks"] == microbatches + S - 1
        assert st["stages"] == S and st["microbatches"] == microbatches
        # every stage but the last hands on one activation a tick
        assert st["sends"] == (0 if r == S - 1 else st["ticks"] - 1)
        assert st["recvs"] == (0 if r == 0 else st["ticks"] - 1)


def test_smoke_passes():
    assert P.main(["--stages", "2", "--microbatches", "2", "--device",
                   "cpu"]) == 0


def test_batch_must_divide_into_microbatches():
    from repro_torch.distributed.pipeline import pipeline_apply

    class Mesh:
        mesh_dim_names = ("stage",)

        def size(self, dim):
            return 1

        def get_local_rank(self, name):
            return 0

        def get_group(self, name):
            return None
    with pytest.raises(ValueError, match="microbatches"):
        pipeline_apply(P.stage_fn, torch.zeros(1, 4, 4), torch.zeros(6, 4),
                       mesh=Mesh(), microbatches=4)
