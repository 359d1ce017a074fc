"""The port's tools: :mod:`.parsers` reads overview.xml, :mod:`.perf` runs
the tuning and measurement layer, :mod:`.scope_trace` attributes device
time to the drivers' scopes and :mod:`.validate_manifest` checks
telemetry manifests against their schema."""
