"""The device trace of a stretch of the window, reduced to what the
per-layer readers need.

`Tracer` runs `torch.profiler` (CPU and CUDA activity) over a sub-window
of the measured window, started and stopped between two serve calls, so
that the calls it holds are whole, with `SLACK_S` of idle time at
each end that `Trace.window_s` leaves out.  Under CUDA graphs CUPTI reports every
kernel node of a replay as a device event of its own.  `reduce` turns the
events into a `Trace`: the device events (kernels, copies, sets), busy
time as the union of their intervals (`_frozen.intervals`), time by
kernel kind (`_frozen.kinds`), and the idle gaps named by the host event
that covers each gap's middle (``host python`` where none does).
"""
from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Any

import torch

from portbench._frozen.intervals import device_time, idle_gaps
from portbench._frozen.kinds import is_phase2, kind

__all__ = ["Tracer", "Trace", "reduce"]

TOP = 10     # entries of each breakdown list
# idle host time at each end of the trace: the profiler keeps only device
# events inside its window, and the device's clock has been seen 1.5 ms
# off the host's
SLACK_S = 0.05


@dataclasses.dataclass
class Trace:
    window_s: float          # the traced stretch, host clock
    busy_s: float            # union of device events' intervals
    spans: list              # sorted (start us, end us, name)
    by_name: dict            # {name: (device ms, events)}
    device_ops: list         # [[name, seconds]] most device time first
    idle_by_host: list       # [[host activity, seconds]] most idle first

    def kind_ms(self, kinds: set[str]) -> float:
        return sum(ms for name, (ms, _) in self.by_name.items()
                   if kind(name) in kinds)

    def kind_launches(self, kinds: set[str]) -> int:
        """Launches of ``kinds``: their first phases (a second phase, the
        split sums' reduction, is not a launch of its own layer)."""
        return sum(n for name, (_, n) in self.by_name.items()
                   if kind(name) in kinds and not is_phase2(name))


class Tracer:
    """Profiles the calls between `start` and `stop`."""

    def __init__(self, enabled: bool, begin_s: float, length_s: float):
        self.enabled = enabled
        self.begin_s, self.end_s = begin_s, begin_s + length_s
        self.prof: Any = None
        self.t0 = self.t1 = 0.0
        self.done = False

    @property
    def active(self) -> bool:
        return self.prof is not None

    def tick(self, elapsed_s: float) -> None:
        """Called between calls with the time since the window opened."""
        if not self.enabled or self.done:
            return
        if self.prof is None and elapsed_s >= self.begin_s:
            self.start()
        elif self.prof is not None and elapsed_s >= self.end_s:
            self.stop()

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        time.sleep(SLACK_S)
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        if self.prof is None or self.done:
            return
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        time.sleep(SLACK_S)
        self.prof.__exit__(None, None, None)
        self.done = True


def _events(prof: Any) -> tuple[list, list]:
    """(device spans, host spans), each a sorted list of (start us, end
    us, name)."""
    from torch.autograd import DeviceType
    dev, host = [], []
    results = getattr(prof.profiler, "kineto_results", None)
    if results is not None:
        for e in results.events():
            s, d = e.start_ns() / 1e3, e.duration_ns() / 1e3
            if e.device_type() == DeviceType.CUDA:
                if not e.is_user_annotation():
                    dev.append((s, s + d, e.name()))
            elif e.device_type() == DeviceType.CPU:
                host.append((s, s + d, e.name()))
    else:
        for e in prof.events():
            r = (e.time_range.start, e.time_range.end, e.name)
            (dev if e.device_type == DeviceType.CUDA else host).append(r)
    return sorted(dev), sorted(host)


def _host_label(host: list, starts: list, t: float) -> str:
    """The innermost host event around ``t``: of those that cover it, the
    one that started last (looked for among the 256 that started last
    before ``t``)."""
    i = bisect.bisect_right(starts, t)
    for s, e, name in reversed(host[max(0, i - 256):i]):
        if e >= t:
            return name
    return "host python"


def reduce(tracer: Tracer) -> Trace:
    dev, host = _events(tracer.prof)
    if not dev:
        raise RuntimeError("the trace holds no device event")
    window_s = tracer.t1 - tracer.t0
    busy_us, by_name = device_time(dev)
    ops = sorted(((n, ms / 1e3) for n, (ms, _) in by_name.items()),
                 key=lambda kv: -kv[1])[:TOP]
    # the traced stretch on the trace's clock: from the first host event
    # to the last event of either kind
    lo = min(dev[0][0], host[0][0] if host else dev[0][0])
    hi = max(max(e for _, e, _ in dev), max((e for _, e, _ in host),
                                            default=0.0))
    idle: dict = {}
    starts = [h[0] for h in host]
    for a, b in idle_gaps(dev, lo, hi):
        label = _host_label(host, starts, (a + b) / 2)
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e6
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return Trace(window_s, busy_us / 1e6, dev, by_name,
                 [[n[:160], s] for n, s in ops],
                 [[n[:160], s] for n, s in gaps])
