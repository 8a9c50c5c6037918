"""Open loop: arrivals at a fixed mean rate, served as they come.

Parameters: ``rate_per_s`` and ``pool`` (the images drawn from, by a
seeded index).  The gaps between arrivals are the ``M`` quantiles
``-ln(1 - (i + 0.5) / M) / rate`` of the exponential law, ``M = rate x
seconds``, in an order drawn from the seed: every seed offers the same
gaps, and so the same load, in another order.  Each serve call takes the
requests that are due, at most one wave of them, in arrival order; when
none is due the loop waits for the next (a sleep to 1 ms before it, then
a spin), and how late it woke is the generator's lateness.  Requests that
are due in the window and still queued when it closes are served after
it; one not served within `DRAIN_S` of the close counts as failed.
"""
from __future__ import annotations

import sys
import time

import numpy as np

DRAIN_S = 60.0


def warm_sizes(traffic: dict, width: int) -> list[int]:
    sizes, n = [], 1
    while n < width:
        sizes.append(n)
        n *= 2
    return sizes + [width] * 2


def arrivals(rate: float, seconds: float, rng: np.random.Generator
             ) -> np.ndarray:
    """Due times in [0, seconds): the exponential quantile gaps in a
    seeded order."""
    m = max(1, int(round(rate * seconds)))
    gaps = -np.log1p(-(np.arange(m) + 0.5) / m) / rate
    due = np.cumsum(rng.permutation(gaps))
    return due[due < seconds]


def _wait_until(session, t: float) -> float:
    while True:
        now = session.elapsed()
        if now >= t:
            return now
        if t - now > 1e-3:
            time.sleep(t - now - 1e-3)


def run(session, traffic: dict, seconds: float,
        rng: np.random.Generator) -> dict:
    due = arrivals(traffic["rate_per_s"], seconds, rng)
    idx = rng.integers(0, len(session.images), len(due))
    late = []
    k, m, w = 0, len(due), session.width
    session.open()
    while k < m:
        now = session.elapsed()
        if now > seconds + DRAIN_S:
            break
        if due[k] > now:
            now = _wait_until(session, due[k])
            late.append(now - due[k])
        j = k + 1
        while j < m and j - k < w and due[j] <= now:
            j += 1
        session.call(idx[k:j], due[k:j])
        k = j
        if session.elapsed() >= seconds:
            session.tracer.stop()
    session.tracer.stop()
    lat = np.asarray(late) * 1e3
    print(f"generator: {m} arrivals at {traffic['rate_per_s']}/s, "
          f"{len(lat)} waits; lateness ms p50 "
          f"{np.percentile(lat, 50) if len(lat) else 0:.4f} p99 "
          f"{np.percentile(lat, 99) if len(lat) else 0:.4f} max "
          f"{lat.max() if len(lat) else 0:.4f}", file=sys.stderr)
    return {"attempted": m}
