"""The typed replica-fault hierarchy of the serving schedulers.

The port's own copy of the exception types of `repro/launch/faults.py`.  A
scheduler catches exactly `FAULT_TYPES`, never a bare ``except``, so a real
programming error (TypeError, ValueError, ...) still fails fast.  The
seeded chaos injection (`FaultPlan`, `ChaosBackend`) comes with the replica
fleet in a later slice.
"""
from __future__ import annotations

__all__ = [
    "ReplicaFault", "ReplicaDead", "TransientFault", "CompileFault",
    "NonFiniteOutput", "FAULT_TYPES",
]


class ReplicaFault(Exception):
    """Base of every scheduler-handled replica failure."""

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
