"""Model-agnostic lockstep scheduler: queue, batch bucketing, slot
retirement, backfill.

The port's own copy of `repro/launch/scheduler.py`'s single-backend half
(`RequestOutcome`, `_deliver`, `_admit`, `_record`, `LockstepScheduler`);
the replica fleet (`FleetScheduler`) comes in a later slice.  The
scheduler owns *when* things run and a backend owns *what* runs.

Backend protocol (duck-typed)
-----------------------------
  bucket_key(req) -> hashable     requests sharing a key may share a batch
  sort_key(req) -> sortable       admission order within a bucket
  context() -> context manager    (optional) entered around one run
  start(reqs, width) -> (state, emissions | None)
  step(state, slots) -> (state, emissions)   one lockstep step; ``slots``
                                  is the width-long list of in-flight
                                  requests (None = idle lane)
  append(req, emission) -> bool   record an emission; True = finished
  can_backfill(state, req) -> bool
  backfill(state, slot, req) -> (state, emission | None)
  finish(state) -> dict           backend stats merged into the run's
  validate_request(req) -> str | None   (optional) admission-time refusal

A finished request frees its slot at once: the scheduler scans the bucket
queue first-fit and backfills in the same delivery pass.  A run ends when
every slot is idle.  Every admitted request ends in exactly one terminal
`RequestOutcome`; control flow never reads the clock.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable

__all__ = ["LockstepScheduler", "RequestOutcome"]


@dataclasses.dataclass
class RequestOutcome:
    """The single terminal outcome of one admitted request.

    ``status`` is ``"delivered"`` or ``"refused"``; refusals carry a
    machine-readable ``reason``.  ``wave`` is the delivery pass the outcome
    was decided at; ``attempts`` counts fault-driven re-placements.
    """

    rid: object
    status: str
    reason: str | None = None
    replica: int | None = None
    attempts: int = 0
    wave: int = 0


def _deliver(be: Any, state: Any, slots: list, queue: list,
             emis: list | None,
             on_finish: Callable[[Any], None] | None = None
             ) -> tuple[Any, int, int, int]:
    """One delivery pass: append emissions, retire finished requests,
    first-fit backfill from ``queue`` (consumed in place), chaining when a
    backfilled request finishes on its admission emission.  Returns
    ``(state, finished, backfills, emitted)``; ``slots`` mutates in place.
    """
    finished = backfills = emitted = 0
    for j in range(len(slots)):
        req = slots[j]
        e = None if emis is None else emis[j]
        while req is not None and e is not None:
            done = be.append(req, e)
            emitted += 1
            e = None
            if not done:
                break
            finished += 1
            if on_finish is not None:
                on_finish(req)
            req = None
            for qi, cand in enumerate(queue):
                if be.can_backfill(state, cand):
                    req = queue.pop(qi)
                    backfills += 1
                    state, e = be.backfill(state, j, req)
                    break
        slots[j] = req
    return state, finished, backfills, emitted


def _admit(be: Any, requests: list, outcomes: dict, *,
           max_queue: int | None = None, wave: int = 0) -> list:
    """Admission control: validate each request through the backend's
    optional ``validate_request`` and shed load beyond ``max_queue``.
    Refused requests get a structured `RequestOutcome`; the admitted
    remainder is returned in order."""
    validate = getattr(be, "validate_request", None)
    admitted = []
    for req in requests:
        reason = None
        if validate is not None:
            reason = validate(req)
            if reason is not None:
                reason = f"invalid:{reason}"
        if reason is None and max_queue is not None \
                and len(admitted) >= max_queue:
            reason = "queue_full"
        if reason is None:
            admitted.append(req)
        else:
            _record(outcomes, req, RequestOutcome(
                rid=getattr(req, "rid", None), status="refused",
                reason=reason, wave=wave))
    return admitted


def _record(outcomes: dict, req: Any, outcome: RequestOutcome) -> None:
    """Record a terminal outcome exactly once (first one wins)."""
    rid = outcome.rid
    if rid in outcomes:
        return
    outcomes[rid] = outcome
    req.outcome = outcome


class LockstepScheduler:
    """Generic lockstep serving loop over a pluggable model backend.

    ``max_queue`` bounds admission per `serve` call: requests beyond the
    depth are shed with a structured ``queue_full`` refusal.
    """

    def __init__(self, backend: Any, *, batch: int,
                 max_queue: int | None = None):
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        self.backend = backend
        self.batch = batch
        self.max_queue = max_queue
        self.outcomes: dict = {}

    def serve(self, requests: list) -> list[dict]:
        """Admission-check and bucket the queue, then run lockstep batches
        until it drains.  Returns one stats dict per lockstep run;
        per-request outcomes land in ``self.outcomes`` (and on each
        request's ``.outcome``)."""
        self.outcomes = {}
        admitted = _admit(self.backend, list(requests), self.outcomes,
                          max_queue=self.max_queue)
        buckets: dict = {}
        for r in admitted:
            buckets.setdefault(self.backend.bucket_key(r), []).append(r)
        stats = []
        for queue in buckets.values():
            queue.sort(key=self.backend.sort_key)
            while queue:
                stats.append(self.run_lockstep(queue))
        return stats

    def _on_finish(self, req: Any) -> None:
        _record(self.outcomes, req, RequestOutcome(
            rid=getattr(req, "rid", None), status="delivered"))

    def run_lockstep(self, queue: list) -> dict:
        """One lockstep run: admit up to ``batch`` requests, step until every
        slot retires, backfilling freed slots from ``queue`` (consumed in
        place).  Stats: steps, finished, backfills, emissions, start_s,
        run_s, plus whatever `backend.finish` adds."""
        be = self.backend
        if not queue:
            raise ValueError("run_lockstep needs at least one request")
        width = self.batch
        admitted = [queue.pop(0) for _ in range(min(width, len(queue)))]
        slots: list = admitted + [None] * (width - len(admitted))
        steps = finished = backfills = emitted = 0
        ctx = getattr(be, "context", None)
        with (ctx() if ctx else contextlib.nullcontext()):
            t0 = time.time()
            state, emis = be.start(admitted, width)
            start_s = time.time() - t0
            t1 = time.time()
            while True:
                state, f, b, e = _deliver(be, state, slots, queue, emis,
                                          self._on_finish)
                finished += f
                backfills += b
                emitted += e
                if all(s is None for s in slots):
                    break
                state, emis = be.step(state, slots)
                steps += 1
            run_s = time.time() - t1
        out = {
            "steps": steps,
            "finished": finished,
            "backfills": backfills,
            "emissions": emitted,
            "start_s": start_s,
            "run_s": run_s,
        }
        out.update(be.finish(state) or {})
        return out
