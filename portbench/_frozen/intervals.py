"""Device busy time as the union of device events' intervals.

Copied from ``chip_smoke.py`` ``_device_spans`` and ``_device_time`` at
commit cb64fea1c63dc5ff4d7b3fa90baae8ccbbb73fb8.  Later changes to the
program do not change this copy.
"""
from __future__ import annotations

__all__ = ["device_time", "idle_gaps"]


def device_time(spans: list) -> tuple[float, dict]:
    """(busy us, the union of the spans' intervals; {name: (device ms,
    events)}) of ``spans``, a sorted list of (start us, end us, name)."""
    busy_us, reach, by_name = 0.0, float("-inf"), {}
    for start, end, name in spans:
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (end - start) / 1e3, n + 1)
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    return busy_us, by_name


def idle_gaps(spans: list, lo: float, hi: float) -> list:
    """The (start us, end us) stretches of [lo, hi] that no span of the
    sorted ``spans`` covers (the complement of `device_time`'s union)."""
    gaps, reach = [], lo
    for start, end, _ in spans:
        if start > reach:
            gaps.append((reach, min(start, hi)))
        reach = max(reach, end)
        if reach >= hi:
            break
    if reach < hi:
        gaps.append((reach, hi))
    return [(a, b) for a, b in gaps if b > a]
