"""Percent: vsmm.cu's share of its roofline over the traced waves; its
second phase counts under vsmm (`harness.context.Context.roofline`)."""


def read(ctx):
    return ctx.roofline("vsmm")
