"""Per-layer metrics: ``<name>.py`` reads the metric ``<name>`` from a
`harness.context.Context` (``read(ctx) -> float | None``)."""
