"""The SSD scan kernels at mamba2-130m's shapes, to compare two trees of
the port in one call.

    python3 time_ssd.py [--src DIR] [--reps N]

A harness beside `chip_smoke.py`, outside the port's package.  Imports
`repro_torch` from ``--src`` (default: this checkout's ``src``), so that
one file times another checkout's kernels; run it on each tree in turns
(A, B, B, A) within one call.  The shapes are `chip_smoke.SSD_SHAPES`
(the forward's 8 x 2048 tokens and the prefill's 4 x 1000, 24 heads, P
64, N 128, chunk 256), in bfloat16 and float32, with the inputs of
`chip_smoke.ssd_inputs` (a seeded generator on the card).  For each row
(`chip_smoke.ssd_row`): the kernels against the float64 recurrence and
the plain version (the card phase's bars), the call's mean time over
``--reps`` calls after a warm one (CUDA events), the plain version's
time, the bound (`chip_smoke.ssd_work` and `bound_of` at the TF32 rate)
and its share, and each kernel's device time in one profiled call; with
``--forward``, mamba2-130m's forward (`forward_row`).  Prints the
library's ptxas report, one JSON line per row and a last line with the
card's name and power limit (``nvidia-smi``).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))


def forward_row(torch, cs, dev):
    """mamba2-130m's forward at `chip_smoke.py`'s shape (8 x 2048 tokens,
    random weights from its seed, bfloat16): the best of three
    synchronised walls after a warm-up, and in one profiled forward the
    device seconds, the busy share and the SSD kernels' device time."""
    import time

    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_params, logits_from_h
    cfg = get_config("mamba2_130m")
    params = init_params(cfg, cs.LM_SEED, device=dev)
    tokens = cs.lm_tokens(torch, dev, cfg, cs.SSM_BATCH, cs.SSM_SEQ)

    @torch.inference_mode()
    def run():
        return logits_from_h(params, forward(params, {"tokens": tokens},
                                             cfg, impl="pallas"), cfg)

    run()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    device_s, n_launch, top = cs.profiled(torch, run, keep=("ssd_",))
    ssd_ms = sum(d["ms"] for d in top if "ssd_" in d["name"])
    return dict(wall_s=min(walls), walls_s=walls, device_s=device_s,
                busy_share=device_s / min(walls), launches=n_launch,
                ssd_device_ms=ssd_ms,
                ssd_by_kernel={d["name"]: d["ms"] for d in top
                               if "ssd_" in d["name"]})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--forward", action="store_true",
                    help="also time mamba2-130m's forward")
    args = ap.parse_args(argv)
    src = os.path.abspath(args.src)
    sys.path.insert(0, src)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("time_ssd times the card: no CUDA card")
    import chip_smoke as cs
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    dev = torch.device("cuda", 0)
    _path, log = ssd_ops.LIBRARY.build()
    print(json.dumps({"time_ssd_build": {
        "src": src, "instances": cs.ptxas_instances(log)}}), flush=True)
    failed = []
    for shape, Bb, S, H in cs.SSD_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[-1]
            with torch.no_grad():
                row, errs, ok, per_kernel, _cum = cs.ssd_row(
                    torch, ssd_ops, ssd_ref, dev, Bb, S, H, dtype,
                    reps=args.reps)
            print(json.dumps({"time_ssd": dict(
                src=src, shape=shape, dtype=dname, ok=ok, errors=errs,
                device_us_by_kernel={d["name"]: d["ms"] * 1e3
                                     for d in per_kernel}, **row)}),
                flush=True)
            if not ok:
                failed.append((shape, dname))
    if args.forward:
        print(json.dumps({"time_ssd_forward": dict(
            src=src, **forward_row(torch, cs, dev))}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    if failed:
        print(f"time_ssd: outside the bars at {failed}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
