"""Deterministic shard-aware synthetic data pipelines (`pipeline`)."""
