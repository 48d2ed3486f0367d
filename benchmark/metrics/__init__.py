"""Readers of the per-layer metrics, one a metric (or a family of metrics
that share the part of their name before the first dot)."""
