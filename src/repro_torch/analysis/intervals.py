"""Integer interval arithmetic for abstract index-map evaluation (the
port's copy of `repro/analysis/intervals.py`).

The layout contract's index-map functions are closed
arithmetic over grid indices and the prefetched ``idx`` table: only
``+ - * // %`` with non-negative operands (see `kernels.vsconv`).
Evaluating them with `Interval` operands therefore yields sound bounds on
every block offset a kernel can ever issue — the in-bounds proof in
`analysis.contracts` needs nothing more than these five operators.

Soundness convention: every operation returns an interval containing all
pointwise results for operands in the input intervals.  ``//`` and ``%``
are only defined for positive *constant* divisors (the only form the
index maps use); ``%`` collapses to ``[0, c-1]`` when the dividend spans a
multiple of ``c`` (exact otherwise).
"""
from __future__ import annotations

import dataclasses

__all__ = ["Interval", "AbstractIdx"]


@dataclasses.dataclass(frozen=True)
class Interval:
    """A closed integer interval [lo, hi] (lo <= hi)."""

    lo: int
    hi: int

    def __post_init__(self) -> None:
        if self.lo > self.hi:
            raise ValueError(f"empty interval [{self.lo}, {self.hi}]")

    @staticmethod
    def point(v: int) -> "Interval":
        return Interval(v, v)

    @staticmethod
    def of(v: "Interval | int") -> "Interval":
        return v if isinstance(v, Interval) else Interval.point(int(v))

    # -- arithmetic ---------------------------------------------------------
    def __add__(self, other: "Interval | int") -> "Interval":
        o = Interval.of(other)
        return Interval(self.lo + o.lo, self.hi + o.hi)

    __radd__ = __add__

    def __sub__(self, other: "Interval | int") -> "Interval":
        o = Interval.of(other)
        return Interval(self.lo - o.hi, self.hi - o.lo)

    def __rsub__(self, other: int) -> "Interval":
        return Interval.of(other) - self

    def __mul__(self, other: "Interval | int") -> "Interval":
        o = Interval.of(other)
        corners = (self.lo * o.lo, self.lo * o.hi,
                   self.hi * o.lo, self.hi * o.hi)
        return Interval(min(corners), max(corners))

    __rmul__ = __mul__

    def __floordiv__(self, c: int) -> "Interval":
        if isinstance(c, Interval):
            if c.lo != c.hi:
                raise TypeError("interval // interval is not supported")
            c = c.lo
        if c <= 0:
            raise ValueError(f"// by non-positive constant {c}")
        return Interval(self.lo // c, self.hi // c)

    def __mod__(self, c: int) -> "Interval":
        if isinstance(c, Interval):
            if c.lo != c.hi:
                raise TypeError("interval % interval is not supported")
            c = c.lo
        if c <= 0:
            raise ValueError(f"% by non-positive constant {c}")
        if self.lo < 0:
            raise ValueError(f"% of a possibly-negative interval {self}")
        if self.lo // c != self.hi // c:
            # the dividend spans a multiple of c: the residue wraps
            return Interval(0, c - 1)
        return Interval(self.lo % c, self.hi % c)

    # -- queries ------------------------------------------------------------
    def within(self, lo: int, hi: int) -> bool:
        """True when the whole interval lies in [lo, hi]."""
        return lo <= self.lo and self.hi <= hi

    def __repr__(self) -> str:
        return f"[{self.lo},{self.hi}]"


class AbstractIdx:
    """Abstract stand-in for the prefetched ``idx`` table.

    ``idx[j, s]`` returns the full stored-tile-id range ``[0, kb - 1]``
    whatever the (abstract) strip and step — so a bounds proof over it
    holds for *every* balanced encoding of the layer, not one sample.
    """

    def __init__(self, kb: int) -> None:
        if kb < 1:
            raise ValueError(f"kb must be >= 1, got {kb}")
        self.kb = kb

    def __getitem__(self, key: object) -> Interval:
        return Interval(0, self.kb - 1)
