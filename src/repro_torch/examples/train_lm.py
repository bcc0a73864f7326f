"""End-to-end training example: mamba2's smoke config on the synthetic
stream with async checkpoints, int8 error-feedback gradients and a
preemption mid-run, then a resume to completion — the fault-tolerance
path of `launch.train` (the port of the reference's
`examples/train_lm.py`).

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 200] \\
        [--preempt-after 30] [--ckpt-dir DIR] [--device cpu]

The first run is preempted by touching its ``--preempt-file`` sentinel
``--preempt-after`` seconds after it starts (0: before its first step
ends) and exits with 42 after a synchronous save; the second resumes
from the latest checkpoint.  Both run in this process.
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import threading
from typing import List, Tuple

from ..launch import train


def _run(args, extra: List[str]) -> Tuple[int, List[float]]:
    """(exit code, losses) of one `launch.train.main` run."""
    argv = ["--arch", "mamba2-130m", "--smoke", "--steps", str(args.steps),
            "--global-batch", "8", "--seq", "64",
            "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "25",
            "--compress-grads"] + extra
    if args.device:
        argv += ["--device", args.device]
    try:
        return 0, train.main(argv)
    except SystemExit as e:
        return int(e.code), []


def main(argv=None) -> Tuple[int, int, List[float]]:
    """Returns (the first run's exit code, the resumed run's, the resumed
    run's losses)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: a new temporary directory")
    ap.add_argument("--preempt-after", type=float, default=30.0,
                    help="seconds before the sentinel is touched")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.ckpt_dir is None:
        args.ckpt_dir = tempfile.mkdtemp(prefix="repro_train_lm_")
    shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    os.makedirs(args.ckpt_dir)

    # phase 1: run and "preempt" by touching the sentinel after a while
    sentinel = os.path.join(args.ckpt_dir, "PREEMPT")

    def preempt():
        open(sentinel, "w").close()

    timer = threading.Timer(args.preempt_after, preempt)
    if args.preempt_after <= 0:
        preempt()
    else:
        timer.start()
    try:
        rc1, _ = _run(args, ["--preempt-file", sentinel])
    finally:
        timer.cancel()
    print(f"[example] first run exited rc={rc1} (42 = preempted+saved)")

    # phase 2: resume to completion
    if os.path.exists(sentinel):
        os.remove(sentinel)
    rc2, losses = _run(args, ["--resume"])
    print(f"[example] resumed run exited rc={rc2}")
    return rc1, rc2, losses


if __name__ == "__main__":
    main()
