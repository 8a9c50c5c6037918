"""Percent: vsconv.cu's share of its roofline over the traced waves, the
sum of its launches' least times over the sum of their device time
(`harness.context.Context.roofline`)."""


def read(ctx):
    return ctx.roofline("vsconv")
