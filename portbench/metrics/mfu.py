"""Percent of the card's f32 peak that the whole step reached over the
traced stretch: 2 x the kept-weight MACs of the images delivered in it,
over (stretch x the f32 FMA peak)."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    images = sum(c.delivered for c in ctx.traced_calls)
    if not images:
        return None
    macs = sum(w.macs for w in ctx.works) * images
    return 100.0 * 2.0 * macs / (ctx.trace.window_s * ctx.f32_flops)
