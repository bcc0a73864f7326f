"""The port's live request queue (`RequestQueue.poll`) against the
reference's, draw for draw, and against its own `presample` replay.

Tolerance: none — the same seed gives the same NumPy draws, so released
classes, backlogs and counters are equal.
"""
import numpy as np
import pytest

from repro.serving.queue import RequestQueue as RefQueue
from repro_torch.serving.queue import RequestQueue

CLASSES = (128, 512, 1024)
D, PERIODS = 17, 9


def _queues(**kw):
    return (RefQueue(D, CLASSES, batch_max=6, seed=4, **kw),
            RequestQueue(D, CLASSES, batch_max=6, seed=4, **kw))


@pytest.mark.parametrize("kw", [
    dict(rate=5.0),
    dict(rate=np.linspace(0.0, 9.0, D), class_probs=(0.5, 0.3, 0.2)),
    dict(trace=np.random.default_rng(0).integers(0, 9, (4, D))),
    dict(trace=np.zeros((0, D), np.int64))], ids=["poisson", "skewed",
                                                  "trace", "empty-trace"])
def test_poll_matches_reference_draw_for_draw(kw):
    ref, port = _queues(**kw)
    for t in range(PERIODS):
        want, got = ref.poll(t), port.poll(t)
        assert len(got) == D
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype
        assert port.backlog == ref.backlog
        np.testing.assert_array_equal(port.per_device_backlog(),
                                      ref.per_device_backlog())
    assert (port.total_arrived, port.total_released) == \
        (ref.total_arrived, ref.total_released)


def test_poll_releases_the_presampled_stream():
    """`presample` replays exactly what `poll` releases: per device, the
    released classes in order are the head of its presampled stream, and
    the backlog is arrivals minus releases."""
    port = RequestQueue(D, CLASSES, rate=8.0, batch_max=6, seed=9)
    counts, stream = RequestQueue(D, CLASSES, rate=8.0, batch_max=6,
                                  seed=9).presample(PERIODS)
    released = [[] for _ in range(D)]
    for t in range(PERIODS):
        for d, out in enumerate(port.poll(t)):
            released[d].extend(np.searchsorted(CLASSES, out).tolist())
    for d in range(D):
        k = len(released[d])
        assert released[d] == stream[d, :k].tolist()
        assert k + port.per_device_backlog()[d] == counts[:, d].sum()
    assert port.backlog > 0                   # the cap held some back
