"""One measured window: the serve calls a traffic generator makes, each
request's times, and the sample that the check compares.

Times are `time.perf_counter` seconds since the window opened.  A
request's latency runs from its due time to the return of the call that
served it; its queue wait from its due time to the start of that call.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from portbench.harness.check import Sampler
from portbench.harness.trace import Tracer

__all__ = ["Call", "Session"]


@dataclasses.dataclass
class Call:
    start: float
    end: float
    rows: list          # requests of each wave, in order
    delivered: int
    traced: bool


class Session:
    def __init__(self, program, images: np.ndarray, width: int,
                 sampler: Sampler, tracer: Tracer):
        self.program = program
        self.images = images
        self.width = width
        self.sampler = sampler
        self.tracer = tracer
        self.calls: list[Call] = []
        self.due: list = []
        self.start: list = []
        self.end: list = []
        self.ok: list = []
        self.next_rid = 0
        self.t_open = time.perf_counter()

    def open(self) -> None:
        self.t_open = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self.t_open

    def waves(self, n: int) -> list:
        """The lockstep run's waves for ``n`` requests: full waves while
        the queue lasts, then the rest."""
        w = self.width
        return [w] * (n // w) + ([n % w] if n % w else [])

    def call(self, idx: np.ndarray, due: np.ndarray) -> None:
        """One serve call of the images ``idx`` due at ``due``."""
        self.tracer.tick(self.elapsed())
        traced = self.tracer.active
        reqs = self.program.requests([self.images[i] for i in idx],
                                     self.next_rid)
        self.next_rid += len(reqs)
        t0 = self.elapsed()
        self.program.serve(reqs)
        t1 = self.elapsed()
        rows = self.waves(len(reqs))
        shape = min(self.width, 1 << max(rows[-1] - 1, 0).bit_length())
        n_ok = 0
        for r, i, d in zip(reqs, idx, due):
            ok = (r.outcome is not None and r.outcome.status == "delivered"
                  and r.logits is not None)
            n_ok += ok
            self.due.append(float(d))
            self.start.append(t0)
            self.end.append(t1)
            self.ok.append(ok)
            if ok:
                self.sampler.offer(int(i), r.logits,
                                   self.width if len(reqs) > self.width
                                   else shape)
        self.calls.append(Call(t0, t1, rows, n_ok, traced))

    def arrays(self) -> dict:
        return {"due": np.asarray(self.due), "start": np.asarray(self.start),
                "end": np.asarray(self.end),
                "ok": np.asarray(self.ok, bool)}
