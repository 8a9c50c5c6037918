"""What a per-layer reader reads: the run's calls and requests, the
trace of its traced stretch, the layers' work and the card's peaks.

A reader is ``metrics/<name>.py`` with ``read(ctx) -> float | None``;
None leaves the metric out of the result line.
"""
from __future__ import annotations

import dataclasses

from portbench.harness.session import Call
from portbench.harness.trace import Trace
from portbench.harness.work import LayerWork, wave_work

__all__ = ["Context", "PORT_KERNELS"]

# device-event kinds of the port's own kernels (`_frozen.kinds`)
PORT_KERNELS = {k + s for k in ("vsconv_halo", "vsconv_stack", "vsmm",
                                "vsconv_dw_halo", "vsconv_dw_stack",
                                "flash_fwd") for s in ("", "_int8")}
# the kinds of each kernel source file, f32
SOURCE_KINDS = {"vsconv": {"vsconv_halo", "vsconv_stack"},
                "vsmm": {"vsmm"}}


@dataclasses.dataclass
class Context:
    calls: list[Call]
    requests: dict           # Session.arrays()
    trace: Trace | None
    works: list[LayerWork]
    f32_flops: float
    hbm_bw: float
    width: int

    @property
    def traced_calls(self) -> list[Call]:
        return [c for c in self.calls if c.traced]

    def roofline(self, source: str) -> float | None:
        """Percent: the traced waves' least time on ``source``'s layers
        over the device time of its kernels, or None where the trace has
        none of them or holds another number of first-phase launches than
        those layers (then the layers and the kernels are not the same
        work)."""
        if self.trace is None:
            return None
        kinds = SOURCE_KINDS[source]
        layers = sum(w.kernel == source for w in self.works)
        waves = [r for c in self.traced_calls for r in c.rows]
        launches = self.trace.kind_launches(kinds)
        ms = self.trace.kind_ms(kinds)
        if not layers or not waves or ms <= 0 \
                or launches != layers * len(waves):
            return None
        bound = sum(wave_work(self.works, r, source,
                              flops_peak=self.f32_flops,
                              bytes_peak=self.hbm_bw) for r in waves)
        return 100.0 * bound / (ms / 1e3)
