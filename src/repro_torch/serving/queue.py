"""Request arrivals of the fleet (port of
`repro.serving.queue.RequestQueue`).

Each device has its own Poisson arrival stream (or a replayed count
trace) and a FIFO backlog.  The host `FleetEngine` drains it live with
`poll`; the tensor engine replays the whole trace drawn up front by
`presample`.  Both draw from the queue's seed in the reference's NumPy
order, so the port and the reference see identical arrivals, and
`presample` equals what `poll(0) .. poll(periods - 1)` releases.
"""
from __future__ import annotations

from collections import deque
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
        self._rng = np.random.default_rng(seed)
        self._backlog: List[deque] = [deque() for _ in range(n_devices)]
        self.total_arrived = 0
        self.total_released = 0

    def _arrival_counts(self, period: int) -> np.ndarray:
        if self.trace is not None:
            if self.trace.shape[0] == 0:       # an empty trace: no arrivals
                return np.zeros(self.n_devices, dtype=np.int64)
            return self.trace[period % self.trace.shape[0]]
        return self._rng.poisson(self.rate)

    def poll(self, period: int) -> List[np.ndarray]:
        """Admit this period's arrivals, then release up to ``batch_max``
        jobs per device, oldest first.  Returns one job-class array per
        device."""
        counts = self._arrival_counts(period)
        released: List[np.ndarray] = []
        for d in range(self.n_devices):
            k = int(counts[d])
            q = self._backlog[d]
            if k:
                fresh = self._rng.choice(self.classes, size=k,
                                         p=self.class_probs)
                q.extend(fresh.tolist())
                self.total_arrived += k
            take = min(len(q), self.batch_max)
            released.append(np.array([q.popleft() for _ in range(take)],
                                     dtype=self.classes.dtype))
            self.total_released += take
        return released

    @property
    def backlog(self) -> int:
        """Jobs admitted but not yet released to any planner."""
        return sum(len(q) for q in self._backlog)

    def per_device_backlog(self) -> np.ndarray:
        return np.array([len(q) for q in self._backlog])

    def presample(self, periods: int):
        """The arrivals of ``periods`` periods from the queue's seed,
        without touching the live state.

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
                if k:            # poll() skips the draw when k == 0
                    fresh = rng.choice(self.classes, size=k,
                                       p=self.class_probs)
                    streams[d].extend(lut[int(c)] for c in fresh)
        S = max((len(s) for s in streams), default=0)
        stream = np.zeros((self.n_devices, max(S, 1)), dtype=np.int32)
        for d, s in enumerate(streams):
            stream[d, :len(s)] = s
        return counts, stream
