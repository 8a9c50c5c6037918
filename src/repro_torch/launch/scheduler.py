"""Model-agnostic lockstep scheduler: queue, batch bucketing, slot
retirement, backfill — plus the replica fleet and its fault tolerance.

The port's own copy of `repro/launch/scheduler.py`.  The scheduler owns
*when* things run and a backend owns *what* runs (`launch.serve`'s
`LMBackend` and `CNNBackend`).

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

Optional extensions (fault tolerance and admission control):

  validate_request(req) -> str | None
      Admission-time validation: a reason string refuses the request with
      a structured `RequestOutcome` before it can break a wave.
  check_emission(emission) -> bool
      Output guard: False means the emission is corrupt (non-finite
      logits).  The fleet quarantines the producing replica and re-serves
      the wave instead of delivering it.
  reset(req) -> None
      Clear a request's partial progress before it is re-served after a
      replica fault.  Without ``reset`` a partially delivered request is
      refused (``partial_stream_lost``) rather than duplicated.

A finished request frees its slot at once: the scheduler scans the bucket
queue first-fit and backfills in the same delivery pass.  A run ends when
every slot is idle; a bucket's leftover requests that never fit an
in-flight run get a fresh run of their own.

Replica fleet
-------------
`FleetScheduler` runs the same protocol over N data-parallel backend
replicas, one weight tree each (`launch.serve.ReplicaGroup`).  Each
bucket's sorted queue is cut into wave-sized chunks placed on the
least-loaded replica.  The run loop advances every replica's lockstep run
one step a tick, and an idle replica steals the tail half of the longest
queue still waiting on another.  Backends may split ``step`` into

  dispatch(state, slots) -> handle
  collect(state, handle, slots) -> (state, emissions)

so that one tick issues every replica's wave before it waits on any
(`CNNBackend`: on the card each replica replays its own CUDA graph, and
replica 1's host padding overlaps replica 0's replay).  A replica is
always collected before it is dispatched again.  Backends without the
split run the synchronous ``step``.  With one replica the placement,
admission order and step sequence are exactly `LockstepScheduler.serve`'s.

Fault tolerance
---------------
Every backend call in the fleet loop is guarded by the typed
`launch.faults.FAULT_TYPES` (never a bare ``except``).  Replica health
walks ``healthy -> suspect -> quarantined -> drained``:

  * a transient fault marks the replica *suspect* and re-queues its wave;
    ``suspect_limit`` transients quarantine it;
  * a non-transient fault (`ReplicaDead`, `CompileFault`, the
    `NonFiniteOutput` raised by the output guard) quarantines at once;
  * quarantine re-places the replica's in-flight slots and pending ladder
    on the surviving replicas (nothing that reached ``append`` is ever
    re-served), then marks the replica *drained* (terminal).

Per-request budgets count waves, never the clock: ``deadline_waves``
refuses a request still *queued* after that many fleet ticks,
``max_attempts`` bounds fault-driven re-placements, ``max_queue`` sheds
load at admission.  Every admitted request ends in exactly one terminal
`RequestOutcome` (delivered, or refused with a reason: ``queue_full``,
``invalid:*``, ``deadline_exceeded``, ``retry_budget_exhausted``,
``no_healthy_replicas``, ``partial_stream_lost``), and control flow never
reads the clock, so a faulty run replays exactly.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable

from repro_torch.launch.faults import FAULT_TYPES, NonFiniteOutput

__all__ = ["LockstepScheduler", "FleetScheduler", "RequestOutcome",
           "HEALTHY", "SUSPECT", "QUARANTINED", "DRAINED"]


# replica health states (fleet): healthy -> suspect -> quarantined -> drained
HEALTHY = "healthy"
SUSPECT = "suspect"
QUARANTINED = "quarantined"
DRAINED = "drained"


@dataclasses.dataclass
class RequestOutcome:
    """The single terminal outcome of one admitted request.

    ``status`` is ``"delivered"`` or ``"refused"``; refusals carry a
    machine-readable ``reason``.  ``wave`` is the fleet tick the outcome
    was decided at (0 under `LockstepScheduler`); ``attempts`` counts
    fault-driven re-placements the request survived.
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


class _ReplicaRun:
    """One resumable in-flight lockstep run on one fleet replica.

    The same lifecycle as `LockstepScheduler.run_lockstep`, unrolled so the
    fleet loop can advance many replicas' runs one step at a time: start +
    deliver on construction (the caller pops the admission wave so a
    failing ``start`` can re-queue it), then repeated ``dispatch`` /
    ``collect_and_deliver`` ticks until every slot is idle.  ``guard``
    (optional) validates each wave's emissions before delivery — it raises
    to reject the whole wave (output corruption), so corrupt emissions are
    never appended.
    """

    def __init__(self, replica: int, be: Any, admitted: list, queue: list,
                 width: int, *,
                 on_finish: Callable[[Any], None] | None = None,
                 guard: Callable[[list], None] | None = None):
        self.replica = replica
        self.be = be
        self.queue = queue
        self.on_finish = on_finish
        self.guard = guard
        self.slots: list = admitted + [None] * (width - len(admitted))
        self.steps = self.finished = self.backfills = self.emitted = 0
        self._handle = None
        with self._ctx():
            t0 = time.time()
            self.state, emis = be.start(admitted, width)
            self.start_s = time.time() - t0
            self._t1 = time.time()
            self._deliver(emis)

    def _ctx(self) -> Any:
        ctx = getattr(self.be, "context", None)
        return ctx() if ctx else contextlib.nullcontext()

    def _deliver(self, emis: list | None) -> None:
        if self.guard is not None and emis is not None:
            self.guard(emis)
        self.state, f, b, e = _deliver(
            self.be, self.state, self.slots, self.queue, emis,
            self.on_finish)
        self.finished += f
        self.backfills += b
        self.emitted += e

    def drained(self) -> bool:
        return all(s is None for s in self.slots)

    def in_flight(self) -> list:
        """Requests currently occupying slots (for fault re-placement)."""
        return [s for s in self.slots if s is not None]

    def dispatch(self) -> None:
        """Issue this replica's next step; backends with a dispatch/collect
        split return without waiting on the result."""
        fn = getattr(self.be, "dispatch", None)
        with self._ctx():
            if fn is not None:
                self._handle = ("pending", fn(self.state, self.slots))
            else:
                self._handle = ("ready", self.be.step(self.state, self.slots))
        self.steps += 1

    def collect_and_deliver(self) -> None:
        kind, h = self._handle
        self._handle = None
        with self._ctx():
            if kind == "pending":
                self.state, emis = self.be.collect(self.state, h, self.slots)
            else:
                self.state, emis = h
            self._deliver(emis)

    def finish(self) -> dict:
        out = {
            "replica": self.replica,
            "steps": self.steps,
            "finished": self.finished,
            "backfills": self.backfills,
            "emissions": self.emitted,
            "start_s": self.start_s,
            "run_s": time.time() - self._t1,
        }
        with self._ctx():
            out.update(self.be.finish(self.state) or {})
        return out


class FleetScheduler:
    """Data-parallel replica fleet: N backends, per-replica wave dispatch,
    replica health tracking and fault-driven re-placement.

    ``backends`` hold the same model behind the `LockstepScheduler` backend
    protocol, one weight tree each (see module docstring).  ``serve``
    returns one stats dict per lockstep run, tagged with the ``replica``
    that ran it; ``steals`` counts queues moved between replicas since
    construction.  Fault handling (see the module docstring's
    *Fault tolerance* section) is configured by:

      fault_types     exception types treated as replica faults (default
                      `launch.faults.FAULT_TYPES`); anything else
                      propagates — a bug should still fail fast;
      suspect_limit   transient faults a replica survives before
                      quarantine;
      max_attempts    fault-driven re-placements one request survives
                      before a ``retry_budget_exhausted`` refusal;
      deadline_waves  default per-request deadline in fleet ticks (a
                      request may override via its own ``deadline_waves``
                      attribute; None = no deadline);
      max_queue       bounded admission depth (load shedding).

    Health, fault events and per-request outcomes are exposed as
    ``self.health`` / ``self.fault_events`` / ``self.outcomes``.
    """

    def __init__(self, backends: list, *, batch: int,
                 max_queue: int | None = None,
                 deadline_waves: int | None = None,
                 max_attempts: int = 3, suspect_limit: int = 2,
                 fault_types: tuple = FAULT_TYPES):
        if not backends:
            raise ValueError("FleetScheduler needs at least one backend")
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        self.backends = list(backends)
        self.batch = batch
        self.max_queue = max_queue
        self.deadline_waves = deadline_waves
        self.max_attempts = max_attempts
        self.suspect_limit = suspect_limit
        self.fault_types = fault_types
        self.steals = 0
        self.waves = 0                       # fleet ticks since construction
        self.health = [HEALTHY] * len(self.backends)
        self.fault_counts = [0] * len(self.backends)
        self.fault_events: list[dict] = []
        self.outcomes: dict = {}
        self._attempts: dict = {}

    @property
    def replicas(self) -> int:
        return len(self.backends)

    def _live(self, i: int) -> bool:
        return self.health[i] in (HEALTHY, SUSPECT)

    def live_replicas(self) -> list[int]:
        return [i for i in range(self.replicas) if self._live(i)]

    # -- placement ----------------------------------------------------------

    def _place(self, requests: list) -> list[dict]:
        """Per-replica bucket ladders: each bucket's sorted queue is cut
        into wave-sized chunks placed on the least-loaded replica (by
        queued request count; ties to the lowest index, so one replica
        degenerates to `LockstepScheduler.serve`'s admission order)."""
        ladders: list[dict] = [{} for _ in self.backends]
        self._place_into(requests, ladders)
        return ladders

    def _place_into(self, requests: list, ladders: list[dict]) -> None:
        """Place (or re-place) ``requests`` onto the live replicas'
        ladders, least-loaded first."""
        be0 = self.backends[0]
        live = self.live_replicas()
        if not live:
            raise RuntimeError("_place_into needs at least one live replica")
        buckets: dict = {}
        for r in requests:
            buckets.setdefault(be0.bucket_key(r), []).append(r)
        loads = [sum(len(q) for q in lad.values()) for lad in ladders]
        for key, q in buckets.items():
            q.sort(key=be0.sort_key)
            while q:
                chunk = q[: self.batch]
                del q[: self.batch]
                i = min(live, key=lambda j: (loads[j], j))
                ladders[i].setdefault(key, []).extend(chunk)
                loads[i] += len(chunk)

    def _claim(self, i: int, ladders: list[dict], runs: list
               ) -> list | None:
        """Next queue for replica ``i``: its own ladder first, then steal
        the tail half (ceil, so lone stragglers move too) of the longest
        queue still waiting on any other replica — a pending ladder queue,
        or the *queued* remainder of an in-flight run's backfill source
        (admitted slots never move; only requests still waiting do)."""
        ladder = ladders[i]
        for key in list(ladder):
            if ladder[key]:
                return ladder.pop(key)
            del ladder[key]
        victim = None
        for j, other in enumerate(ladders):
            if j != i:
                for q in other.values():
                    if q and (victim is None or len(q) > len(victim)):
                        victim = q
        for run in runs:
            if run is not None and run.replica != i:
                q = run.queue
                if q and (victim is None or len(q) > len(victim)):
                    victim = q
        if victim is None:
            return None
        n = -(-len(victim) // 2)
        stolen = victim[len(victim) - n:]
        del victim[len(victim) - n:]
        self.steals += 1
        return stolen

    def _retire(self, run: _ReplicaRun, ladders: list[dict],
                stats: list[dict]) -> None:
        """Record a drained run; leftover queued requests its backend
        refused to backfill go back on the replica's ladder for a fresh run
        (the `LockstepScheduler.serve` ``while queue`` loop, fleet-wise)."""
        stats.append(run.finish())
        if run.queue:
            key = self.backends[0].bucket_key(run.queue[0])
            ladders[run.replica].setdefault(key, []).extend(run.queue)
            run.queue.clear()

    # -- outcomes -----------------------------------------------------------

    def _refuse(self, req: Any, reason: str) -> None:
        _record(self.outcomes, req, RequestOutcome(
            rid=getattr(req, "rid", None), status="refused", reason=reason,
            attempts=self._attempts.get(id(req), 0), wave=self.waves))

    def _on_finish(self, replica: int) -> Callable[[Any], None]:
        def cb(req: Any) -> None:
            _record(self.outcomes, req, RequestOutcome(
                rid=getattr(req, "rid", None), status="delivered",
                replica=replica,
                attempts=self._attempts.get(id(req), 0), wave=self.waves))
        return cb

    def _guard(self, be: Any, replica: int
               ) -> Callable[[list], None] | None:
        """Output-validation guard for one replica's waves: reject a wave
        whose emissions fail the backend's ``check_emission`` by raising
        `NonFiniteOutput` — the tick loop quarantines the replica and
        re-serves the wave elsewhere, so corrupt values never reach
        ``append``."""
        check = getattr(be, "check_emission", None)
        if check is None:
            return None

        def guard(emis: list) -> None:
            bad = [j for j, e in enumerate(emis)
                   if e is not None and not check(e)]
            if bad:
                raise NonFiniteOutput(
                    f"replica {replica} emitted non-finite output in "
                    f"slot(s) {bad}")
        return guard

    # -- fault handling -----------------------------------------------------

    def _log_fault(self, i: int, exc: BaseException) -> None:
        self.fault_events.append({
            "wave": self.waves,
            "replica": i,
            "fault": type(exc).__name__,
            "transient": bool(getattr(exc, "transient", False)),
            "health": self.health[i],
            "error": str(exc),
        })

    def _degrade(self, i: int, exc: BaseException) -> None:
        """Walk replica ``i``'s health state for one fault."""
        if getattr(exc, "transient", False):
            self.fault_counts[i] += 1
            if self.health[i] == HEALTHY:
                self.health[i] = SUSPECT
            if self.fault_counts[i] >= self.suspect_limit:
                self.health[i] = QUARANTINED
        else:
            self.health[i] = QUARANTINED

    def _requeue(self, reqs: list, ladders: list[dict]) -> None:
        """Re-place fault-displaced requests on the surviving replicas.

        Each re-placement spends one retry-budget attempt; a request whose
        delivery already started (partial emissions) is only re-served if
        the backend can ``reset`` it — duplicate delivery is never an
        option.  With no live replica left, everything is refused."""
        be = self.backends[0]
        reset = getattr(be, "reset", None)
        survivors = []
        for req in reqs:
            n = self._attempts.get(id(req), 0) + 1
            self._attempts[id(req)] = n
            if n > self.max_attempts:
                self._refuse(req, "retry_budget_exhausted")
                continue
            if getattr(req, "out", None):
                if reset is None:
                    self._refuse(req, "partial_stream_lost")
                    continue
                reset(req)
            survivors.append(req)
        if not survivors:
            return
        if not self.live_replicas():
            for req in survivors:
                self._refuse(req, "no_healthy_replicas")
            return
        self._place_into(survivors, ladders)

    def _on_fault(self, i: int, exc: BaseException, displaced: list,
                  ladders: list[dict]) -> None:
        """One replica fault: log it, walk the health state, re-place the
        displaced requests, and — on quarantine — drain the replica's
        pending ladder onto the survivors."""
        self._log_fault(i, exc)
        self._degrade(i, exc)
        if self.health[i] == QUARANTINED:
            pending = []
            for q in ladders[i].values():
                pending.extend(q)
            ladders[i].clear()
            displaced = displaced + pending
            self._requeue(displaced, ladders)
            self.health[i] = DRAINED
        else:
            self._requeue(displaced, ladders)

    def _expire(self, ladders: list[dict], runs: list) -> None:
        """Deadline sweep: refuse requests still *queued* (not in-flight)
        after their wave budget.  ``deadline_waves`` counts fleet ticks
        since this serve() started; in-flight requests always complete."""
        default = self.deadline_waves
        age = self.waves - self._tick0
        queues = [q for lad in ladders for q in lad.values()]
        queues += [run.queue for run in runs if run is not None]
        for q in queues:
            keep = []
            for req in q:
                dl = getattr(req, "deadline_waves", None)
                dl = default if dl is None else dl
                if dl is not None and age >= dl:
                    self._refuse(req, "deadline_exceeded")
                else:
                    keep.append(req)
            q[:] = keep

    def _spawn(self, i: int, q: list, ladders: list[dict]
               ) -> _ReplicaRun | None:
        """Admit a wave from queue ``q`` on replica ``i``.  Returns the
        live `_ReplicaRun`, or None if ``start`` faulted (the wave is
        re-queued and the replica's health degraded)."""
        be = self.backends[i]
        admitted = [q.pop(0) for _ in range(min(self.batch, len(q)))]
        try:
            return _ReplicaRun(i, be, admitted, q, self.batch,
                               on_finish=self._on_finish(i),
                               guard=self._guard(be, i))
        except self.fault_types as e:
            self._on_fault(i, e, admitted + q, ladders)
            return None

    # -- serve --------------------------------------------------------------

    def serve(self, requests: list) -> list[dict]:
        """Admission-check the queue, place it on per-replica ladders, then
        drain every replica with interleaved per-replica wave dispatch (one
        step per replica per tick; each tick dispatches all replicas before
        collecting any, so split backends overlap their device work).
        Faulting replicas degrade and drain per the module docstring; the
        serve always returns — degraded service is structured refusals in
        ``self.outcomes``, not an exception."""
        self.outcomes = {}
        self._attempts = {}
        self._tick0 = self.waves
        admitted = _admit(self.backends[0], list(requests), self.outcomes,
                          max_queue=self.max_queue, wave=self.waves)
        if not self.live_replicas():
            for req in admitted:
                self._refuse(req, "no_healthy_replicas")
            return []
        ladders = self._place(admitted)
        runs: list = [None] * self.replicas
        stats: list[dict] = []
        while True:
            self._expire(ladders, runs)
            for i in range(self.replicas):
                while self._live(i) and runs[i] is None:
                    q = self._claim(i, ladders, runs)
                    if q is None:
                        break
                    if not q:
                        continue
                    run = self._spawn(i, q, ladders)
                    if run is None:
                        continue
                    if run.drained():  # instant finish (e.g. max_new=1 LM)
                        self._retire(run, ladders, stats)
                    else:
                        runs[i] = run
            active = [r for r in runs if r is not None]
            if not active:
                # queued work with no live replica to run it: refuse it
                leftovers = [r for lad in ladders
                             for q in lad.values() for r in q]
                for req in leftovers:
                    self._refuse(req, "no_healthy_replicas")
                return stats
            self.waves += 1
            faulted: list = []
            for run in active:
                try:
                    run.dispatch()
                except self.fault_types as e:
                    faulted.append((run, e))
            for i, run in enumerate(runs):
                if run is None:
                    continue
                exc = next((e for r, e in faulted if r is run), None)
                if exc is None:
                    try:
                        run.collect_and_deliver()
                    except self.fault_types as e:
                        exc = e
                if exc is not None:
                    runs[i] = None
                    self._on_fault(i, exc, run.in_flight() + run.queue,
                                   ladders)
                    continue
                if run.drained():
                    self._retire(run, ladders, stats)
                    runs[i] = None
