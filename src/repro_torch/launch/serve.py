"""Serving launcher of the port: the paper's experiment (§VII) on an LM
ladder — two width-scaled variants of `paper_edge` on the ED tier (the
MobileNet-alpha analogue) and the full model on the ES tier (the ResNet
analogue) — planned every period by the front door and executed with
measured wall times and per-job top-1 next-token accuracy.

    PYTHONPATH=src python -m repro_torch.launch.serve --periods 4 --n 16 \\
        [--policy auto|amr2|amdp|greedy] [--t-factor 0.8] \\
        [--fail-period 2] [--train-steps 20] [--device cuda|cpu]

The port of `repro.launch.serve.main` and of `build_models` /
`make_apply` from the reference's `examples/serve_offload.py`.  The
models are initialised from a seed (or take carried-over parameters) and
trained briefly on the synthetic stream (``--train-steps``, 20 by
default as in the reference; model i of the ladder for ``train_steps ·
(i + 1)`` AdamW steps at lr 3e-3, with dense attention under autograd),
so that their accuracies are ordered by capacity (a_1 <= a_2 <= a_es,
the paper's Table I).  Serving then runs the forward under
`torch.inference_mode`, on the kernels.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..configs.paper_edge import CONFIG as ES_CFG
from ..configs.paper_edge import ED_VARIANTS
from ..data.pipeline import DataConfig, TokenPipeline
from ..models import ModelConfig, forward, init_params, logits_from_h
from ..optim import adamw_init
from .steps import make_train_step
from ..serving import (PeriodStats, ServingRuntime, TierProfile,
                       measure_latency)

LADDER = tuple(ED_VARIANTS) + (ES_CFG,)
SEQ_LEN = 64


TRAIN_LR = 3e-3
TRAIN_BATCH = 8


def build_models(configs: Sequence[ModelConfig] = LADDER, *, seed: int = 0,
                 device: DeviceLike = None,
                 params: Optional[Sequence] = None,
                 train_steps: int = 0) -> List[Tuple]:
    """``(cfg, params)`` per model: model i initialised from ``seed + i``
    on ``device``, or the given ``params`` (e.g. carried over from the
    reference with `convert.model_params_from_numpy`), then trained for
    ``train_steps · (i + 1)`` AdamW steps at lr 3e-3 on
    ``TokenPipeline(seq_len=64, global_batch=8, seed=seed)`` with
    ``attn_impl="dense"``, as the reference's `build_models` does (more
    steps for bigger models, so accuracy follows capacity).  The
    returned configs are the given ones: serving keeps their attention
    implementation."""
    dev = resolve_device(device)
    if params is None:
        params = [init_params(cfg, seed + i, device=dev)
                  for i, cfg in enumerate(configs)]
    elif len(params) != len(configs):
        raise ValueError("one parameter tree per config")
    models = []
    for i, (cfg, p) in enumerate(zip(configs, params)):
        if train_steps:
            p = _train(cfg, p, train_steps * (i + 1), seed, dev)
        models.append((cfg, p))
    return models


def _train(cfg: ModelConfig, params, steps: int, seed: int,
           dev: torch.device):
    """``steps`` train steps of ``cfg`` (dense attention) from
    ``params``."""
    step = make_train_step(dataclasses.replace(cfg, attn_impl="dense"),
                           lr=TRAIN_LR)
    opt = adamw_init(params)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=SEQ_LEN,
                                    global_batch=TRAIN_BATCH, seed=seed))
    for s in range(steps):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in pipe.batch_at(s).items()}
        params, opt, _ = step(params, opt, batch)
    return params


def make_apply(cfg: ModelConfig, params) -> Callable[[list], List[float]]:
    """``apply(jobs) -> [accuracy per job]``: one batched forward of the
    jobs' tokens on the parameters' device, each job's accuracy its
    top-1 next-token hit rate.  The batch is padded to the next power of
    two (zero tokens), as the reference does to keep its jit shapes."""
    device = params["embed"].device

    @torch.inference_mode()
    def fwd(tokens: torch.Tensor) -> torch.Tensor:
        h = forward(params, {"tokens": tokens}, cfg)
        logits = logits_from_h(params, h, cfg)
        pred = torch.argmax(logits[:, :-1], dim=-1)
        return (pred == tokens[:, 1:]).float().mean(dim=1)

    def apply(jobs) -> List[float]:
        toks = torch.as_tensor(np.stack([np.asarray(j) for j in jobs]),
                               device=device)
        n = toks.shape[0]
        bucket = 1 << (n - 1).bit_length()
        toks = torch.nn.functional.pad(toks, (0, 0, 0, bucket - n))
        return fwd(toks)[:n].tolist()
    return apply


def main(argv=None) -> List[PeriodStats]:
    """Run the period loop; returns each period's `PeriodStats`."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--periods", type=int, default=4)
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--policy", default="auto")
    ap.add_argument("--t-factor", type=float, default=0.8)
    ap.add_argument("--train-steps", type=int, default=20)
    ap.add_argument("--fail-period", type=int, default=-1,
                    help="simulate an ES outage in this period")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    models = build_models(LADDER, seed=0, device=dev,
                          train_steps=args.train_steps)
    applies = [make_apply(c, p) for c, p in models]
    pipe = TokenPipeline(DataConfig(vocab_size=ES_CFG.vocab_size,
                                    seq_len=SEQ_LEN,
                                    global_batch=max(args.n, 16), seed=7))
    test_jobs = [pipe.batch_at(0)["tokens"][i] for i in range(8)]
    accs = [float(np.mean(app(test_jobs))) for app in applies]
    lats = [measure_latency(lambda a=app: a(test_jobs[:1]), (), iters=8)
            for app in applies]
    profile = TierProfile(
        name="ladder", p_ed=np.array([[lats[0], lats[1]]]),
        p_es=np.array([lats[2] * 1.2]), acc=np.array(accs),
        classes=[SEQ_LEN])
    print(f"[serve] device {dev}: ladder accuracies {np.round(accs, 4)}, "
          f"latencies (s/job) {np.round(lats, 5)}", flush=True)

    T = args.n * lats[1] * args.t_factor
    rt = ServingRuntime(profile, applies[:2], applies[2], T=T,
                        policy=args.policy, device=dev)
    for period in range(args.periods):
        jobs = [pipe.batch_at(10 + period)["tokens"][i]
                for i in range(args.n)]
        s = rt.run_period(jobs, np.full(args.n, SEQ_LEN),
                          es_fail=(period == args.fail_period))
        print(f"[serve] period {period}: {s.policy} A={s.total_accuracy:.2f}"
              f" pred={s.predicted_makespan:.4f}s"
              f" wall={s.wall_makespan:.4f}s"
              f" viol={100 * s.violation:.0f}% dropped={s.n_dropped}"
              f"{' REPLANNED' if s.replanned else ''}", flush=True)
    return rt.history


if __name__ == "__main__":
    main()
