"""Run-scoped observability (the port's copy of the core of the JAX
package's obs/): structured logging (:mod:`.log`), the telemetry behind
the versioned ``telemetry.json`` run manifest (:mod:`.telemetry`), the
live ``status.json`` heartbeat and stall watchdog (:mod:`.heartbeat`), the
crash flight recorder (:mod:`.flight`), the schema contract
(:mod:`.schema` with the JAX package's ``manifest.schema.json`` and
``metrics.schema.json``, copied), time-series metrics with Prometheus
exposition (:mod:`.metrics`), cross-process trace correlation
(:mod:`.trace`) and on-demand profiling of a live worker
(:mod:`.profiler`), and on the campaign layer the survey-health alert
engine (:mod:`.alerts`, with the JAX package's ``alerts.schema.json``),
the scientific data-quality sentinels (:mod:`.health`) and the campaign
portal (:mod:`.portal`)."""

from .flight import FLIGHT_SCHEMA, FlightRecorder, load_flight
from .heartbeat import STATUS_SCHEMA, Heartbeat, load_status
from .log import configure as configure_logging
from .log import get_logger, resolve_level
from .metrics import (
    METRICS_SCHEMA,
    MetricsRecorder,
    fleet_samples,
    load_series,
    parse_exposition,
    prometheus_exposition,
    validate_sample,
)
from .profiler import capture_device_profile
from .schema import SchemaError, validate_manifest
from .telemetry import (
    MANIFEST_SCHEMA,
    MANIFEST_VERSION,
    NOOP,
    RunTelemetry,
    current,
    load_manifest,
)
from .trace import (
    TRACE_SCHEMA,
    Tracer,
    current_tracer,
    export_chrome_trace,
    job_instant,
    job_span,
    load_spans,
    new_trace_id,
    trace_paths,
    trace_summary,
)

__all__ = [
    "configure_logging",
    "get_logger",
    "resolve_level",
    "FLIGHT_SCHEMA",
    "FlightRecorder",
    "load_flight",
    "STATUS_SCHEMA",
    "Heartbeat",
    "load_status",
    "SchemaError",
    "validate_manifest",
    "MANIFEST_SCHEMA",
    "MANIFEST_VERSION",
    "NOOP",
    "RunTelemetry",
    "current",
    "load_manifest",
    "METRICS_SCHEMA",
    "MetricsRecorder",
    "fleet_samples",
    "load_series",
    "parse_exposition",
    "prometheus_exposition",
    "validate_sample",
    "capture_device_profile",
    "TRACE_SCHEMA",
    "Tracer",
    "current_tracer",
    "export_chrome_trace",
    "job_instant",
    "job_span",
    "load_spans",
    "new_trace_id",
    "trace_paths",
    "trace_summary",
]
