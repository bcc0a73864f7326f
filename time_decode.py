"""The flash-decode kernel at the generation paths' shapes, to compare two
trees of the port in one call.

    python3 time_decode.py [--src DIR] [--reps N] [--step | --step-only]

A harness beside `chip_smoke.py`, outside the port's package: it times
`scaled_dot_product_attention` as the yardstick, which the port never
calls.  Imports `repro_torch` from ``--src`` (default: this checkout's
``src``), so that one file times another checkout's kernel; run it on
each tree in turns (A, B, B, A) within one call.  The rows are
`chip_smoke.decode_cases()` (`DECODE_SHAPES` in bfloat16 and float32,
then `FAMILY_DECODE_SHAPES`), each made by `chip_smoke.decode_row` with
inputs from one seeded generator on the card: the kernel against the
tree's plain version (float32 to 1e-5, bfloat16 to 2^-7), the model
entry's mean time over ``--reps`` calls (``ms``), the same calls queued
behind a device sleep (``device_ms``), the host's time a call
(``host_us``), the kernels one call launches under `torch.profiler`,
SDPA's time, the plan and the bound (`chip_smoke.decode_work`,
`bound_of`).  With ``--step``, also gemma3-1b's decode step at the
generation run's shape (`step_row`); ``--step-only`` times the step
alone.  Prints the library's ptxas report,
one JSON line per row and a last line with the card's name and power
limit (``nvidia-smi``).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def step_row(torch, cs, dev, steps=16):
    """gemma3-1b at full width from `chip_smoke`'s seed, bfloat16: a
    prefill of `GEN_BATCH` x `GEN_PROMPT` tokens, then ``steps``
    synchronised `decode_step` calls (their walls, and the host's mean
    microseconds inside the flash-decode entry), and one more step under
    `torch.profiler` (device seconds, kernel launches, the flash-decode
    kernels' calls and device time)."""
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, layers, prefill
    cfg = get_config("gemma3_1b")
    entry = layers.decode_attention
    inside = [0.0, 0]                   # host seconds in the entry, calls

    def timed_entry(*a, **k):
        t0 = time.perf_counter()
        out = entry(*a, **k)
        inside[0] += time.perf_counter() - t0
        inside[1] += 1
        return out

    params = init_params(cfg, cs.LM_SEED, device=dev)
    max_seq = cs.GEN_PROMPT + steps + 1
    tokens = cs.lm_tokens(torch, dev, cfg, cs.GEN_BATCH, max_seq)
    walls = []
    with torch.inference_mode():
        cache, _lg = prefill(params, {"tokens": tokens[:, :cs.GEN_PROMPT]},
                             cfg, max_seq)
        layers.decode_attention = timed_entry
        for t in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _lg, cache = decode_step(
                params, tokens[:, cs.GEN_PROMPT + t:cs.GEN_PROMPT + t + 1],
                cache, cfg)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        layers.decode_attention = entry
        device_s, n_launch, top = cs.profiled(torch, lambda: decode_step(
            params, tokens[:, -1:], cache, cfg), keep=("decode_",))
    decode = [d for d in top if "decode_" in d["name"]]
    return dict(walls_s=walls, median_s=sorted(walls)[steps // 2],
                min_s=min(walls), device_s=device_s, launches=n_launch,
                decode_kernels=decode,
                decode_device_ms=sum(d["ms"] for d in decode),
                entry_host_us=inside[0] / max(inside[1], 1) * 1e6,
                entry_calls=inside[1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--step", action="store_true",
                    help="also time gemma3-1b's decode step")
    ap.add_argument("--step-only", action="store_true",
                    help="time gemma3-1b's decode step alone")
    args = ap.parse_args(argv)
    src = os.path.abspath(args.src)
    sys.path.insert(0, src)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("time_decode times the card: no CUDA card")
    import chip_smoke as cs
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention import ref as da_ref
    dev = torch.device("cuda", 0)
    _path, log = da_ops.LIBRARY.build()
    print(json.dumps({"time_decode_build": {
        "src": src, "instances": cs.ptxas_instances(log)}}), flush=True)
    g = torch.Generator(device=dev).manual_seed(23)
    failed = []
    for case in [] if args.step_only else cs.decode_cases():
        with torch.no_grad():
            row, ok = cs.decode_row(torch, da_ops, da_ref, dev, g, case,
                                    reps=args.reps)
        print(json.dumps({"time_decode": dict(
            src=src, shape=case[0], dtype=case[7], kv_dtype=case[8], ok=ok,
            **row)}), flush=True)
        if not ok:
            failed.append((case[0], case[7]))
    if args.step or args.step_only:
        print(json.dumps({"time_decode_step": dict(
            src=src, **step_row(torch, cs, dev))}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    if failed:
        print(f"time_decode: disagrees with the plain version at {failed}",
              file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
