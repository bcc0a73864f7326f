"""Prefill and decode times of one model on the card, to compare two
trees of the port in one call.

    python src/repro_torch/scripts/time_generation.py [--src DIR]

Imports `repro_torch` from ``--src`` (default: this checkout's ``src``),
so that one file times another checkout of the port; run it on each
tree in turns (A, B, B, A) within one call.  gemma3-1b at full width
and depth, random weights from seed 0, bfloat16 compute, the shapes of
`chip_smoke.py`'s ``lm_generate``; one warm-up generation (it builds the
kernels), then `REPEATS` generations, each a `prefill` of `BATCH`
prompts of `PROMPT` tokens and `STEPS` `decode_step` calls, the card
synchronised around each.  Prints one JSON line: the tree, the
card's name and power limit (``nvidia-smi``), each repeat's prefill
seconds and mean decode-step seconds, and their medians.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ARCH, SEED = "gemma3_1b", 0
BATCH, PROMPT, STEPS, REPEATS = 4, 1000, 32, 5


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    args = ap.parse_args(argv)
    src = os.path.abspath(args.src)
    sys.path.insert(0, src)
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("time_generation times the card: no CUDA card")
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, prefill
    dev = torch.device("cuda", 0)
    cfg = get_config(ARCH)
    params = init_params(cfg, SEED, device=dev)
    P, n = PROMPT, STEPS
    g = torch.Generator(device=dev).manual_seed(SEED)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, P + n),
                           generator=g, device=dev, dtype=torch.int32)

    def generate():
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cache, _ = prefill(params, {"tokens": tokens[:, :P]}, cfg, P + n)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for t in range(n):
                _, cache = decode_step(params, tokens[:, P + t:P + t + 1],
                                       cache, cfg)
            torch.cuda.synchronize()
            return t1 - t0, (time.perf_counter() - t1) / n
    generate()
    runs = [generate() for _ in range(REPEATS)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"time_generation": {
        "src": src, "arch": cfg.name, "batch": BATCH, "prompt": P,
        "decode_steps": n, "nvidia_smi": smi,
        "prefill_s": [r[0] for r in runs],
        "decode_step_s": [r[1] for r in runs],
        "median_prefill_s": statistics.median(r[0] for r in runs),
        "median_decode_step_s": statistics.median(r[1] for r in runs)}}),
        flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
