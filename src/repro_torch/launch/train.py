"""Fault-tolerant training driver of the port (`repro.launch.train`), on
one device.

Ties together: the config registry -> the train step (`launch.steps`,
optionally with int8 error-feedback gradients) -> the deterministic data
pipeline -> async manifest checkpoints -> preemption handling ->
straggler ticks.

Restart semantics: ``--resume`` picks up the latest published checkpoint
(parameters, optimizer state, data cursor) and continues bit-identically
— the data are a pure function of (seed, step).  A preemption (SIGTERM,
or the ``--preempt-file`` sentinel, which makes it testable) makes a
synchronous final save and exits with code 42 so that a supervisor can
reschedule.  The reference shards the step over a device mesh; sharding
is ROADMAP §1 item 13, so this driver runs on one device (``--device``,
the card unless ``cpu`` is named).

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
        --smoke --steps 20 --global-batch 8 --seq 64 --ckpt-dir CKPT \\
        [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import signal
import sys
import time
from typing import List, Optional

import torch

from .._device import resolve_device
from ..checkpoint import manager as ckpt
from ..configs import get_config, get_smoke_config
from ..data.pipeline import DataConfig, TokenPipeline
from ..distributed.compression import compress_tree
from ..models import init_params
from ..optim import adamw_init, cosine_schedule
from .steps import make_train_step

PREEMPTED = 42


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--preempt-file", default=None,
                    help="touch this file to simulate a preemption")
    ap.add_argument("--straggler-factor", type=float, default=3.0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None, *, params=None) -> List[float]:
    """Train; returns each step's loss.  ``params`` replaces the seeded
    `init_params` as the starting point (e.g. the reference's, carried
    over with `convert.model_params_from_numpy`); ``--resume`` from a
    checkpoint overrides both.  Exits with `PREEMPTED` (42) after the
    save on a preemption."""
    args = parse_args(argv)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dev = resolve_device(args.device)

    lr = cosine_schedule(args.lr, warmup=max(args.steps // 20, 1),
                         total=args.steps)
    grad_tx = None
    ef_error = {"v": None}
    if args.compress_grads:
        def grad_tx(g):  # noqa: E306
            out, ef_error["v"] = compress_tree(g, ef_error["v"])
            return out
    step_fn = make_train_step(cfg, lr=lr, grad_tx=grad_tx)

    if params is None:
        params = init_params(cfg, args.seed, device=dev)
    opt = adamw_init(params)
    start_step = 0
    if args.resume and args.ckpt_dir:
        latest = ckpt.latest_step(args.ckpt_dir)
        if latest is not None:
            (params, opt), meta = ckpt.restore(args.ckpt_dir, latest,
                                               (params, opt))
            start_step = int(meta["step"]) + 1
            print(f"[train] resumed from step {latest} "
                  f"(data cursor {start_step})", flush=True)

    pipe = TokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.global_batch, seed=args.seed))
    writer = ckpt.AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None

    preempted = {"flag": False}

    def _sig(_s, _f):
        preempted["flag"] = True
    previous = signal.signal(signal.SIGTERM, _sig)
    try:
        ema = None
        losses = []
        for step in range(start_step, args.steps):
            t0 = time.time()
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in pipe.batch_at(step).items()}
            params, opt, loss = step_fn(params, opt, batch)
            losses.append(float(loss))
            dt = time.time() - t0
            ema = dt if ema is None else 0.9 * ema + 0.1 * dt
            if dt > args.straggler_factor * ema and step > start_step + 3:
                print(f"[train] straggler tick at step {step}: "
                      f"{dt:.2f}s vs ema {ema:.2f}s — at fleet scale this "
                      f"triggers re-profiling/eviction", flush=True)
            if step % args.log_every == 0:
                print(f"[train] step {step} loss {losses[-1]:.4f} "
                      f"({dt:.2f}s)", flush=True)
            if writer and step % args.ckpt_every == 0 and step > start_step:
                writer.submit(step, (params, opt), {"step": step})
            if args.preempt_file and os.path.exists(args.preempt_file):
                preempted["flag"] = True
            if preempted["flag"]:
                print(f"[train] preemption at step {step}: saving + "
                      f"exiting", flush=True)
                if writer:
                    writer.wait()
                if args.ckpt_dir:
                    ckpt.save(args.ckpt_dir, step, (params, opt),
                              {"step": step})
                sys.exit(PREEMPTED)

        if writer:
            writer.submit(args.steps - 1, (params, opt),
                          {"step": args.steps - 1})
            writer.wait()
    finally:
        signal.signal(signal.SIGTERM, previous)
    if losses:
        print(f"[train] done: loss {losses[0]:.4f} -> {losses[-1]:.4f}",
              flush=True)
    return losses


if __name__ == "__main__":
    main()
