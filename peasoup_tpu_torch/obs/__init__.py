"""Observability: only :mod:`.schema`, the JSON Schema validator the
sift report and the rank model need, is ported; telemetry, heartbeats,
metrics and the rest are ROADMAP item A.10."""
