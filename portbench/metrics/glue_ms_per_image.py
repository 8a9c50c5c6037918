"""Device ms, a delivered image, of the events outside the port's own
kernels (pads, casts, copies, the input's and the logits' copies) over
the traced stretch."""
from portbench.harness.context import PORT_KERNELS
from portbench._frozen.kinds import kind


def read(ctx):
    if ctx.trace is None:
        return None
    images = sum(c.delivered for c in ctx.traced_calls)
    if not images:
        return None
    ms = sum(ms for name, (ms, _) in ctx.trace.by_name.items()
             if kind(name) not in PORT_KERNELS)
    return ms / images
