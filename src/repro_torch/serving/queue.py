"""Replayed request arrivals (port of `repro.serving.queue.RequestQueue`,
its `presample` replay only).

Each device has its own Poisson arrival stream (or a replayed count
trace) and a FIFO backlog; `presample` draws the whole trace up front from
the queue's seed, in the same NumPy order as the reference, so both sides
replay identical arrivals.  The live `poll` loop belongs to the host
`FleetEngine`, not ported yet (ROADMAP §1 item 7).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np


class RequestQueue:
    """Per-device arrival process: Poisson at ``rate`` per period, or the
    (periods, n_devices) count ``trace`` replayed cyclically; job classes
    drawn from ``classes`` (with ``class_probs``); at most ``batch_max``
    jobs released per device per period."""

    def __init__(self, n_devices: int, classes: Sequence[int], *,
                 rate: Union[float, Sequence[float]] = 8.0,
                 batch_max: int = 16, seed: int = 0,
                 trace: Optional[np.ndarray] = None,
                 class_probs: Optional[Sequence[float]] = None):
        if batch_max <= 0:
            raise ValueError("batch_max must be positive")
        self.n_devices = n_devices
        self.classes = np.asarray(classes)
        self.batch_max = batch_max
        self.rate = np.broadcast_to(np.asarray(rate, np.float64),
                                    (n_devices,))
        self.trace = None if trace is None else np.asarray(trace)
        if self.trace is not None and self.trace.shape[1] != n_devices:
            raise ValueError("trace must be (periods, n_devices)")
        self.class_probs = class_probs
        self.seed = seed

    def presample(self, periods: int):
        """The arrivals of ``periods`` periods from the queue's seed.

        Returns ``(counts (periods, n_devices) int64, stream (n_devices, S)
        int32)``: ``stream[d, k]`` is the class-table index of device d's
        k-th arrival, S the longest stream (shorter ones 0-padded; the
        padding is never released because releases never outrun
        arrivals)."""
        rng = np.random.default_rng(self.seed)
        counts = np.zeros((periods, self.n_devices), dtype=np.int64)
        streams: List[List[int]] = [[] for _ in range(self.n_devices)]
        lut = {int(c): i for i, c in enumerate(self.classes)}
        for t in range(periods):
            if self.trace is not None:
                if self.trace.shape[0]:
                    counts[t] = self.trace[t % self.trace.shape[0]]
            else:
                counts[t] = rng.poisson(self.rate)
            for d in range(self.n_devices):
                k = int(counts[t, d])
                if k:            # the live queue skips the draw when k == 0
                    fresh = rng.choice(self.classes, size=k,
                                       p=self.class_probs)
                    streams[d].extend(lut[int(c)] for c in fresh)
        S = max((len(s) for s in streams), default=0)
        stream = np.zeros((self.n_devices, max(S, 1)), dtype=np.int32)
        for d, s in enumerate(streams):
            stream[d, :len(s)] = s
        return counts, stream
