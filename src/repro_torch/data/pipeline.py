"""Deterministic synthetic token streams: the port of
`repro.data.pipeline` — `DataConfig`, `TokenPipeline` (pure NumPy, the
same tokens bit for bit) and the host `Prefetcher`.

Synthetic-but-structured rows (a mixture of Zipfian unigrams and
copy/induction motifs), a pure function of (seed, step) and sharded per
data-parallel rank, so a resumed run continues bit-identically.
`Prefetcher` double-buffers batches on a background thread.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    motif_frac: float = 0.3      # fraction of each row that is copy-motif
    zipf_a: float = 1.2


class TokenPipeline:
    """Stateless-per-step generator: batch(step) is a pure function of
    (config, step), so any rank can reproduce any step after preemption."""

    def __init__(self, cfg: DataConfig, *, rank: int = 0, world: int = 1):
        if cfg.global_batch % world:
            raise ValueError("global_batch must divide world size")
        self.cfg = cfg
        self.rank = rank
        self.world = world
        self.local_batch = cfg.global_batch // world

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rows = []
        for i in range(self.local_batch):
            row_idx = step * cfg.global_batch + self.rank * self.local_batch + i
            rng = np.random.default_rng(
                np.random.SeedSequence([cfg.seed, row_idx]))
            row = self._row(rng)
            rows.append(row)
        return {"tokens": np.stack(rows).astype(np.int32)}

    def _row(self, rng: np.random.Generator) -> np.ndarray:
        cfg = self.cfg
        S = cfg.seq_len
        # zipf background (clipped into vocab)
        toks = rng.zipf(cfg.zipf_a, size=S)
        toks = np.minimum(toks, cfg.vocab_size - 1)
        # induction motif: pick a span, repeat it later (teaches copying)
        span = max(4, int(S * cfg.motif_frac / 2))
        if S >= 4 * span:
            src = rng.integers(0, S // 2 - span)
            dst = rng.integers(S // 2, S - span)
            toks[dst:dst + span] = toks[src:src + span]
        return toks

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread double buffering around any step-indexed source:
    `next()` returns ``(step, batch)`` in step order from ``start_step``;
    `close()` stops the thread."""

    def __init__(self, pipeline: TokenPipeline, start_step: int = 0,
                 depth: int = 2):
        self.pipeline = pipeline
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.pipeline.batch_at(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)
