"""Deterministic fault injection for the serving fleet.

The port's own copy of `repro/launch/faults.py`.  The fault-tolerance
contract of `launch.scheduler.FleetScheduler` (replica quarantine and
drain, request re-placement, deadlines, the non-finite output guard) is
only trustworthy if the failure paths can be exercised, and only
debuggable if a failing chaos run can be replayed.  Both come from the
scheduler's design rule: no clock reads.  A `FaultPlan` is a pure function
of its seed, indexed by ``(replica, wave)`` where ``wave`` is the
replica's own count of ``start`` and ``dispatch`` calls, so the same plan
against the same request queue injects the same failures on every run (a
seed gives the reference's plan: the same numpy generator and draws).

`ChaosBackend` wraps any scheduler backend (see the protocol in
`launch.scheduler`) and fires the planned faults around the real
dispatch/collect calls:

  ``die_dispatch``   the replica raises `ReplicaDead` when dispatching the
                     wave and stays dead (permanent hardware loss);
  ``die_collect``    dispatch succeeds, the replica dies before its results
                     can be collected (in-flight work lost; on the card the
                     wave's graph replay runs and its output is never read);
  ``transient``      one retryable `TransientFault` at dispatch (driver
                     hiccup; the replica survives);
  ``start_fail``     `CompileFault` when admitting a run (a bucket whose
                     graph cannot be built);
  ``nan``            the wave computes but every emission is corrupted to
                     non-finite values (caught by the scheduler's output
                     guard, never delivered);
  ``stall``          the wave produces nothing for ``ticks`` scheduler
                     ticks (slow replica; other replicas keep retiring and
                     may steal its queue).

Fault exceptions form a typed hierarchy under `ReplicaFault`: a scheduler
catches exactly `FAULT_TYPES`, never a bare ``except``, so a real
programming error (TypeError, ValueError, ...) still fails fast and an
injected fault cannot be swallowed by an overbroad handler.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Sequence

import numpy as np

__all__ = [
    "ReplicaFault", "ReplicaDead", "TransientFault", "CompileFault",
    "NonFiniteOutput", "FAULT_TYPES", "KINDS", "Fault", "FaultPlan",
    "ChaosBackend",
]


class ReplicaFault(Exception):
    """Base of every injectable (and scheduler-handled) replica failure."""

    transient = False


class ReplicaDead(ReplicaFault):
    """Permanent replica loss: quarantine, drain, never dispatch again."""


class TransientFault(ReplicaFault):
    """One-shot retryable failure: the replica survives (suspect)."""

    transient = True


class CompileFault(ReplicaFault):
    """A run could not be admitted (e.g. a bucket's executable fails to
    build on this replica)."""


class NonFiniteOutput(ReplicaFault):
    """A wave produced non-finite outputs; raised by the scheduler's
    output-validation guard, never by the backend math itself."""


# what a scheduler catches around backend calls
FAULT_TYPES: tuple[type[BaseException], ...] = (ReplicaFault,)

KINDS = ("die_dispatch", "die_collect", "transient", "start_fail", "nan",
         "stall")


@dataclasses.dataclass(frozen=True)
class Fault:
    """One planned failure: fire ``kind`` on ``replica`` at its local wave
    counter ``wave`` (counting `start` and `dispatch` calls from 0).
    ``ticks`` is the stall duration for ``kind == 'stall'``."""

    kind: str
    replica: int
    wave: int
    ticks: int = 2

    def __post_init__(self) -> None:
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {KINDS}")
        if self.wave < 0 or self.replica < 0 or self.ticks < 1:
            raise ValueError(f"invalid fault coordinates: {self}")


class FaultPlan:
    """A replayable failure schedule: ``(replica, wave) -> faults``.

    Deterministic by construction — built either from an explicit fault
    list or from a seed (`FaultPlan.random`), and indexed only by counters
    the scheduler already maintains.  Contains no clock, no randomness at
    fire time, and no mutable state, so the same plan replayed against the
    same queue reproduces the exact wave/steal/retire/refusal trajectory.
    """

    def __init__(self, faults: Iterable[Fault] = ()):
        self.faults: tuple[Fault, ...] = tuple(faults)
        self._at: dict[tuple[int, int], list[Fault]] = {}
        for f in self.faults:
            self._at.setdefault((f.replica, f.wave), []).append(f)

    @classmethod
    def random(cls, seed: int, *, replicas: int, horizon: int = 16,
               rate: float = 0.15,
               kinds: Sequence[str] = KINDS) -> "FaultPlan":
        """A seeded schedule: each (replica, wave) cell in the horizon
        independently draws one fault with probability ``rate``."""
        rng = np.random.default_rng(seed)
        faults = []
        for r in range(replicas):
            for w in range(horizon):
                if rng.random() < rate:
                    kind = kinds[int(rng.integers(len(kinds)))]
                    faults.append(Fault(kind, r, w,
                                        ticks=int(rng.integers(1, 4))))
        return cls(faults)

    def at(self, replica: int, wave: int) -> list[Fault]:
        return self._at.get((replica, wave), [])

    def __len__(self) -> int:
        return len(self.faults)

    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for f in self.faults:
            out[f.kind] = out.get(f.kind, 0) + 1
        return out

    def describe(self) -> str:
        return " ".join(f"{f.kind}@r{f.replica}w{f.wave}"
                        for f in self.faults) or "(empty)"


def _poison(e: Any) -> Any:
    """Corrupt one emission to non-finite values, preserving its type."""
    if e is None:
        return None
    if isinstance(e, np.ndarray):
        return np.full_like(e, np.nan) if np.issubdtype(
            e.dtype, np.floating) else e
    if isinstance(e, float):
        return float("nan")
    return e


class ChaosBackend:
    """A scheduler backend that injects a `FaultPlan` around the real one.

    Implements the dispatch/collect split of the backend protocol (falling
    back to the inner backend's synchronous ``step`` when it has no split)
    and delegates every other protocol method — ``bucket_key``,
    ``validate_request``, ``append``, ... — to the wrapped backend
    untouched, so an empty plan is behaviorally invisible.

    ``waves`` counts this replica's ``start`` + ``dispatch`` calls; faults
    fire when the plan has entries at the current count.  ``injected``
    records every fired fault as ``(wave, kind)`` for telemetry.
    """

    def __init__(self, inner: Any, plan: FaultPlan, *, replica: int):
        self.inner = inner
        self.plan = plan
        self.replica = replica
        self.waves = 0
        self.dead = False
        self._stall = 0
        self.injected: list[tuple[int, str]] = []

    def __getattr__(self, name: str) -> Any:
        # protocol methods we don't intercept delegate to the inner backend
        return getattr(self.inner, name)

    # -- fault firing -------------------------------------------------------

    def _tick(self) -> list[Fault]:
        w = self.waves
        self.waves += 1
        if self.dead:
            raise ReplicaDead(
                f"replica {self.replica} is dead (wave {w})")
        return self.plan.at(self.replica, w)

    def _die(self, wave: int, kind: str) -> None:
        self.dead = True
        self.injected.append((wave, kind))
        raise ReplicaDead(
            f"injected {kind} on replica {self.replica} at wave {wave}")

    # -- scheduler protocol -------------------------------------------------

    def start(self, reqs: list, width: int):
        w = self.waves
        for f in self._tick():
            if f.kind == "die_dispatch":
                self._die(w, "die_dispatch")
            if f.kind == "start_fail":
                self.injected.append((w, "start_fail"))
                raise CompileFault(
                    f"injected start_fail on replica {self.replica} "
                    f"at wave {w}")
            if f.kind == "transient":
                self.injected.append((w, "transient"))
                raise TransientFault(
                    f"injected transient on replica {self.replica} "
                    f"at wave {w} (start)")
        return self.inner.start(reqs, width)

    def dispatch(self, state, slots):
        w = self.waves
        fired = self._tick()
        for f in fired:
            if f.kind == "stall" and self._stall == 0:
                self._stall = f.ticks
        if self._stall > 0:
            self._stall -= 1
            self.injected.append((w, "stall"))
            return ("stall", None, False)
        for f in fired:
            if f.kind == "die_dispatch":
                self._die(w, "die_dispatch")
            if f.kind == "transient":
                self.injected.append((w, "transient"))
                raise TransientFault(
                    f"injected transient on replica {self.replica} "
                    f"at wave {w}")
        corrupt = any(f.kind == "nan" for f in fired)
        die_collect = any(f.kind == "die_collect" for f in fired)
        if corrupt:
            self.injected.append((w, "nan"))
        fn = getattr(self.inner, "dispatch", None)
        if fn is not None:
            handle = ("split", fn(state, slots), corrupt)
        else:
            handle = ("sync", self.inner.step(state, slots), corrupt)
        if die_collect:
            # remember to die when the scheduler comes back for the result
            handle = ("die_collect", (w, handle), corrupt)
        return handle

    def collect(self, state, handle, slots):
        tag, h, corrupt = handle
        if self.dead:
            raise ReplicaDead(
                f"replica {self.replica} is dead (collect)")
        if tag == "stall":
            return state, [None] * len(slots)
        if tag == "die_collect":
            w, _inner_handle = h
            self._die(w, "die_collect")
        if tag == "split":
            state, emis = self.inner.collect(state, h, slots)
        else:
            state, emis = h
        if corrupt:
            emis = [_poison(e) for e in emis]
        return state, emis
