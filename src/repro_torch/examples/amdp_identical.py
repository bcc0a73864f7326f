"""AMDP for identical jobs (paper §VI): the optimal DP schedule against
AMR^2 and Greedy-RRA when every request has the same shape, the
periodic-sensing workload (port of `examples/amdp_identical.py`).

Also the §VI-B remark (identical processing, heterogeneous communication
times: a sort-by-c_j greedy ES fill, then the CCKP), and the CCKP DP
through its CUDA kernel (`cckp_model_dp`) on the card against its plain
PyTorch version on the CPU.

    python -m repro_torch.examples.amdp_identical [--device cpu]
        [--sizes 30:2.0,100:4.0,300:8.0]
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None):
    from .._device import resolve_device
    from ..core.amdp import amdp, amdp_hetero_comm
    from ..core.amr2 import amr2
    from ..core.greedy import greedy_rra
    from ..core.oracle import brute_force
    from ..core.types import OffloadInstance
    from ..kernels.cckp_dp import ops as cckp_ops

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cpu, or cuda (the default: the card)")
    ap.add_argument("--sizes", default="30:2.0,100:4.0,300:8.0",
                    help="comma-separated n:T pairs of the sweep")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    sizes = [(int(n), float(T)) for n, T in
             (x.split(":") for x in args.sizes.split(","))]

    # ladder timings in the paper's range (Table II-like), identical jobs
    p_ed = np.array([0.010, 0.045])        # two ED models
    p_es = 0.35                            # comm + ES compute
    acc = np.array([0.395, 0.559, 0.771])  # Table I
    out = {"sweep": []}

    print(f"{'n':>5} {'T':>6} {'A_amdp':>8} {'A_amr2':>8} {'A_greedy':>9} "
          f"{'amdp_ms':>8} {'amr2_ms':>8}   on {dev}")
    for n, T in sizes:
        inst = OffloadInstance(p_ed=np.tile(p_ed, (n, 1)),
                               p_es=np.full(n, p_es), acc=acc, T=T)
        t0 = time.perf_counter()
        d = amdp(inst, device=dev)
        t1 = time.perf_counter()
        a = amr2(inst, device=dev)
        t2 = time.perf_counter()
        g = greedy_rra(inst)
        print(f"{n:5d} {T:6.1f} {d.total_accuracy:8.2f} "
              f"{a.total_accuracy:8.2f} {g.total_accuracy:9.2f} "
              f"{1e3*(t1-t0):8.1f} {1e3*(t2-t1):8.1f}"
              + (f"   (amr2 viol {100*a.violation:.0f}%)"
                 if a.violation > 0 else ""))
        # AMDP is optimal among T-feasible schedules; AMR^2 may beat it
        # only by exceeding T (its 2T allowance, Theorem 1)
        if a.violation == 0:
            assert d.total_accuracy >= a.total_accuracy - 1e-6
        assert d.violation == 0
        out["sweep"].append(dict(n=n, T=T, amdp=d.total_accuracy,
                                 amr2=a.total_accuracy,
                                 greedy=g.total_accuracy))

    # optimality spot-check against brute force
    inst = OffloadInstance(p_ed=np.tile(p_ed, (7, 1)),
                           p_es=np.full(7, p_es), acc=acc, T=1.0)
    opt = brute_force(inst)
    d = amdp(inst, device=dev)
    print(f"\nn=7 brute force: {opt.total_accuracy:.3f} == "
          f"AMDP {d.total_accuracy:.3f}")
    assert abs(opt.total_accuracy - d.total_accuracy) < 1e-9
    out["brute_force"] = (opt.total_accuracy, d.total_accuracy)

    # the DP on ``dev`` (the CUDA kernel on the card) against the plain
    # PyTorch version on the CPU
    inst = OffloadInstance(p_ed=np.tile(p_ed, (50, 1)),
                           p_es=np.full(50, p_es), acc=acc, T=2.0)
    n0 = cckp_ops.models_dp.launches
    d_dev = amdp(inst, device=dev)
    launched = cckp_ops.models_dp.launches - n0
    d_cpu = amdp(inst, device="cpu")
    print(f"CCKP DP on {dev} ({launched} kernel launches): "
          f"A={d_dev.total_accuracy:.3f} (plain version on the CPU "
          f"{d_cpu.total_accuracy:.3f})")
    assert np.array_equal(d_dev.assignment, d_cpu.assignment)
    out["dp"] = dict(device=d_dev.total_accuracy, cpu=d_cpu.total_accuracy,
                     launches=launched)

    # heterogeneous comm times (paper §VI-B remark)
    rng = np.random.default_rng(0)
    comm = rng.uniform(0.05, 0.6, size=40)
    h = amdp_hetero_comm(p_ed, p_es_proc=0.3, comm=comm, acc=acc, T=3.0,
                         device=dev)
    print(f"hetero-comm: A={h.total_accuracy:.2f} "
          f"offloaded={int((h.assignment == 2).sum())}/40 "
          f"ed={h.ed_makespan:.2f}s es={h.es_makespan:.2f}s (T=3.0)")
    out["hetero"] = h.total_accuracy
    return out


if __name__ == "__main__":
    main()
