"""Closed loop: serve calls back to back for the whole window.

Parameters: ``waves_per_call`` (each call gets that many full waves of
requests, so the lockstep run retires and backfills), ``pool`` (the
images drawn from, by a seeded index).  Every request of a call is due
at the call's start.  The last call starts before the window closes and
is counted whole.
"""
from __future__ import annotations

import numpy as np


def warm_sizes(traffic: dict, width: int) -> list[int]:
    return [traffic["waves_per_call"] * width] * 2


def run(session, traffic: dict, seconds: float,
        rng: np.random.Generator) -> dict:
    n = traffic["waves_per_call"] * session.width
    session.open()
    while session.elapsed() < seconds:
        idx = rng.integers(0, len(session.images), n)
        now = session.elapsed()
        session.call(idx, np.full(n, now))
    session.tracer.stop()
    return {"attempted": len(session.due)}
