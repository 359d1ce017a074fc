"""Time-series metrics (the port's copy of the JAX package's
obs/metrics.py).

- :class:`MetricsRecorder`: an **append-only** time-series file (one
  JSON sample per line: the stream's ``--metrics-jsonl``, a campaign
  worker's ``queue/workers/<worker>.metrics.jsonl``) with bounded size:
  when the file outgrows ``max_bytes`` it is atomically rotated (tmp +
  ``os.replace``) keeping the newest tail, so a reader mid-rotate sees
  either the old or the new file, never a torn one. Counters are written
  as **cumulative** values (Prometheus semantics, carried in recorder
  memory across rotations), gauges as point-in-time values, and histogram
  samples as raw observations bucketed at read time.
- the **fleet aggregator**: :func:`fleet_samples` collects every worker's
  series under a campaign root, and :func:`prometheus_exposition` renders
  the standard text exposition format (``# TYPE`` comments,
  ``{label="..."}`` sets, histogram ``_bucket``/``_sum``/``_count``
  triplets).
- :func:`rotate_journal` keeps the campaign's append-only journals
  bounded, and :func:`serve_metrics` serves the exposition over HTTP.

Every sample line validates against the port's copy of the JAX package's
``obs/metrics.schema.json`` through :mod:`peasoup_tpu_torch.obs.schema`.

The recorder is single-writer by construction, so appends need no locking
across processes; a thread lock covers the threads of one process.
"""

from __future__ import annotations

import glob as _glob
import json
import math
import os
import threading
import time

from .log import get_logger

log = get_logger("obs.metrics")

METRICS_SCHEMA = "peasoup_tpu.metrics"
METRICS_VERSION = 1

METRICS_SUFFIX = ".metrics.jsonl"

_SCHEMA_PATH = os.path.join(
    os.path.dirname(__file__), "metrics.schema.json"
)

KINDS = ("counter", "gauge", "hist")

# default histogram bucket bounds (seconds-flavoured: latencies are
# the dominant histogram here); the exposition adds the +Inf bucket
DEFAULT_BUCKETS = (
    0.005, 0.02, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
    60.0, 120.0, 300.0,
)


def load_metrics_schema() -> dict:
    with open(_SCHEMA_PATH) as f:
        return json.load(f)


def validate_sample(rec: dict, schema: dict | None = None) -> None:
    """Validate one sample line against the checked-in schema (raises
    :class:`~peasoup_tpu_torch.obs.schema.SchemaError`)."""
    from .schema import validate

    validate(rec, schema or load_metrics_schema())


class MetricsRecorder:
    """Append-only bounded time-series recorder for ONE worker.

    ``enabled=False`` is the campaign's off switch: every method
    becomes a no-op and no file is ever created (mirroring
    :data:`~peasoup_tpu_torch.obs.telemetry.NOOP`).
    """

    def __init__(
        self,
        path: str,
        enabled: bool = True,
        max_bytes: int = 4 << 20,
        keep_bytes: int | None = None,
    ) -> None:
        self.path = path
        self.enabled = bool(enabled)
        self.max_bytes = int(max_bytes)
        self.keep_bytes = int(keep_bytes or max(4096, self.max_bytes // 2))
        self._lock = threading.Lock()
        self._counters: dict[tuple, float] = {}
        self._approx_bytes: int | None = None  # lazily stat()ed

    # --- recording ----------------------------------------------------
    def counter(self, name: str, by: float = 1.0, **labels) -> None:
        """Monotone cumulative counter (the written value is the
        running total, Prometheus-style)."""
        if not self.enabled:
            return
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            total = self._counters.get(key, 0.0) + float(by)
            self._counters[key] = total
            self._append("counter", name, total, labels)

    def gauge(self, name: str, value: float, **labels) -> None:
        """Point-in-time value."""
        if not self.enabled:
            return
        with self._lock:
            self._append("gauge", name, float(value), labels)

    def observe(self, name: str, value: float, **labels) -> None:
        """One histogram observation (bucketed at read time)."""
        if not self.enabled:
            return
        with self._lock:
            self._append("hist", name, float(value), labels)

    # --- the file -----------------------------------------------------
    def _append(self, kind: str, name: str, value: float, labels) -> None:
        now_unix = time.time()  # sample timestamps are epochs, shared
        rec: dict = {
            "t": now_unix,
            "name": str(name),
            "kind": kind,
            "value": value,
        }
        if labels:
            rec["labels"] = {k: str(v) for k, v in sorted(labels.items())}
        line = json.dumps(rec, separators=(",", ":")) + "\n"
        try:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(self.path, "a") as f:
                f.write(line)
            if self._approx_bytes is None:
                try:
                    self._approx_bytes = os.path.getsize(self.path)
                except OSError:
                    self._approx_bytes = len(line)
            else:
                self._approx_bytes += len(line)
            if self._approx_bytes > self.max_bytes:
                self._rotate()
        except OSError:
            # metrics must never fail the worker (full disk, yanked
            # mount): drop the sample, keep the campaign alive
            log.debug("metrics append failed: %s", self.path, exc_info=True)

    def _rotate(self) -> None:
        """Atomic tail-keeping rewrite: newest samples whose total size
        fits ``keep_bytes`` survive; the counter running totals live in
        recorder memory, so cumulative series stay monotone across the
        rotation."""
        try:
            with open(self.path) as f:
                lines = f.readlines()
        except OSError:
            return
        kept: list[str] = []
        total = 0
        for ln in reversed(lines):
            total += len(ln)
            if total > self.keep_bytes:
                break
            kept.append(ln)
        kept.reverse()
        tmp = self.path + ".tmp"
        try:
            with open(tmp, "w") as f:
                f.writelines(kept)
            os.replace(tmp, self.path)
        except OSError:
            log.debug("metrics rotation failed", exc_info=True)
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return
        self._approx_bytes = sum(len(ln) for ln in kept)
        log.debug(
            "rotated %s: kept %d of %d samples",
            self.path, len(kept), len(lines),
        )


# --------------------------------------------------------------------------
# reading + fleet aggregation
def rotate_journal(
    path: str, max_bytes: int, keep_bytes: int | None = None
) -> bool:
    """The recorder's tail-keeping rotation as a standalone operation
    for any append-only jsonl journal (``queue/alerts.jsonl``,
    ``queue/submissions.jsonl``, the per-tenant alert journals —
    ``peasoup-campaign prune --journals``): when ``path`` exceeds
    ``max_bytes``, atomically rewrite it keeping the newest whole
    lines that fit ``keep_bytes`` (default half of ``max_bytes``).
    Returns True when a rotation happened. Alert-engine state restores
    from the SNAPSHOT (``queue/alerts.json``), never the journal, so
    truncating journal history can never re-fire an alert — the
    restart-no-refire regression test pins that."""
    keep = int(keep_bytes or max(4096, int(max_bytes) // 2))
    try:
        if os.path.getsize(path) <= int(max_bytes):
            return False
        with open(path) as f:
            lines = f.readlines()
    except OSError:
        return False
    kept: list[str] = []
    total = 0
    for ln in reversed(lines):
        # budgets are bytes on disk, so measure encoded length —
        # len(ln) undercounts multibyte UTF-8 journal content
        total += len(ln.encode("utf-8"))
        if total > keep:
            break
        kept.append(ln)
    kept.reverse()
    tmp = path + ".tmp"
    try:
        with open(tmp, "w") as f:
            f.writelines(kept)
        os.replace(tmp, path)
    except OSError:
        log.debug("journal rotation failed: %s", path, exc_info=True)
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False
    log.info(
        "rotated %s: kept %d of %d lines", path, len(kept), len(lines)
    )
    return True


# --------------------------------------------------------------------------

def load_series(path: str, validate: bool = False) -> list[dict]:
    """Samples from one worker's metrics file (torn trailing line —
    the writer mid-append — is skipped, never an error)."""
    out: list[dict] = []
    schema = load_metrics_schema() if validate else None
    try:
        with open(path) as f:
            lines = f.readlines()
    except OSError:
        return out
    for ln in lines:
        ln = ln.strip()
        if not ln:
            continue
        try:
            rec = json.loads(ln)
        except json.JSONDecodeError:
            continue  # torn tail
        if validate:
            validate_sample(rec, schema)
        out.append(rec)
    return out


def metrics_paths(root: str) -> list[str]:
    """Every worker metrics file under a campaign root — departed
    workers' files included (history outlives membership)."""
    return sorted(
        _glob.glob(
            os.path.join(
                os.path.abspath(root), "queue", "workers",
                "*" + METRICS_SUFFIX,
            )
        )
    )


def source_for_path(path: str) -> str:
    base = os.path.basename(path)
    return base[: -len(METRICS_SUFFIX)] if base.endswith(
        METRICS_SUFFIX
    ) else os.path.splitext(base)[0]


def fleet_samples(
    root: str, validate: bool = False
) -> dict[str, list[dict]]:
    """source (worker id) -> its samples, for one campaign root."""
    return {
        source_for_path(p): load_series(p, validate=validate)
        for p in metrics_paths(root)
    }


def series(
    samples_by_source: dict[str, list[dict]],
    name: str,
    kind: str | None = None,
    labels: dict | None = None,
) -> list[dict]:
    """All samples of one metric across the fleet, time-ordered, each
    tagged with its source — the "queue depth over the last hour"
    query shape. ``labels`` filters to samples whose label set
    CONTAINS every given pair (``labels={"tenant": "alice"}`` slices
    one tenant's series out of the fleet's)."""
    out = []
    for src, samples in samples_by_source.items():
        for rec in samples:
            if rec.get("name") != name:
                continue
            if kind is not None and rec.get("kind") != kind:
                continue
            if labels:
                have = rec.get("labels") or {}
                if any(
                    have.get(k) != str(v) for k, v in labels.items()
                ):
                    continue
            out.append({**rec, "source": src})
    out.sort(key=lambda r: r.get("t", 0.0))
    return out


# --------------------------------------------------------------------------
# Prometheus text exposition
# --------------------------------------------------------------------------

def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _label_str(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{str(v).replace(chr(92), chr(92) * 2).replace(chr(34), chr(92) + chr(34))}"'
        for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _metric_name(name: str, prefix: str) -> str:
    safe = "".join(
        c if c.isalnum() or c == "_" else "_" for c in str(name)
    )
    return f"{prefix}_{safe}" if prefix else safe


def prometheus_exposition(
    samples_by_source: dict[str, list[dict]],
    prefix: str = "peasoup",
    buckets: tuple = DEFAULT_BUCKETS,
) -> str:
    """Render the fleet's series in the Prometheus text exposition
    format. Counters and gauges expose their LAST value per
    (source, labels) series; histogram observations are bucketed into
    cumulative ``_bucket`` counts plus ``_sum``/``_count``."""
    last: dict[tuple, tuple[float, float]] = {}  # series -> (t, value)
    kinds: dict[str, str] = {}
    hists: dict[tuple, list[float]] = {}
    for src, samples in sorted(samples_by_source.items()):
        for rec in samples:
            name = rec.get("name")
            kind = rec.get("kind")
            if not name or kind not in KINDS:
                continue
            labels = dict(rec.get("labels") or {})
            labels["worker"] = src
            key = (name, tuple(sorted(labels.items())))
            kinds[name] = kind
            if kind == "hist":
                hists.setdefault(key, []).append(float(rec["value"]))
            else:
                t = float(rec.get("t", 0.0))
                if key not in last or t >= last[key][0]:
                    last[key] = (t, float(rec["value"]))
    lines: list[str] = []
    for name in sorted(kinds):
        kind = kinds[name]
        mname = _metric_name(name, prefix)
        if kind == "hist":
            lines.append(f"# TYPE {mname} histogram")
            for key, obs in sorted(hists.items()):
                if key[0] != name:
                    continue
                labels = dict(key[1])
                cum = 0
                for b in (*buckets, math.inf):
                    cum = sum(1 for v in obs if v <= b)
                    lines.append(
                        f"{mname}_bucket"
                        f"{_label_str({**labels, 'le': _fmt_value(b)})}"
                        f" {cum}"
                    )
                lines.append(
                    f"{mname}_sum{_label_str(labels)} "
                    f"{_fmt_value(sum(obs))}"
                )
                lines.append(
                    f"{mname}_count{_label_str(labels)} {len(obs)}"
                )
        else:
            ptype = "counter" if kind == "counter" else "gauge"
            lines.append(f"# TYPE {mname} {ptype}")
            for key, (_, value) in sorted(last.items()):
                if key[0] != name:
                    continue
                lines.append(
                    f"{mname}{_label_str(dict(key[1]))} "
                    f"{_fmt_value(value)}"
                )
    return "\n".join(lines) + ("\n" if lines else "")


def parse_exposition(text: str) -> list[tuple[str, dict, float]]:
    """Parse exposition text back into (name, labels, value) triples —
    the round-trip check the chaos gate runs. Raises ValueError on a
    malformed line (that IS the gate)."""
    out: list[tuple[str, dict, float]] = []
    for ln in text.splitlines():
        ln = ln.strip()
        if not ln or ln.startswith("#"):
            continue
        head, _, val = ln.rpartition(" ")
        if not head:
            raise ValueError(f"malformed exposition line: {ln!r}")
        labels: dict = {}
        name = head
        if "{" in head:
            if not head.endswith("}"):
                raise ValueError(f"malformed label set: {ln!r}")
            name, _, inner = head.partition("{")
            inner = inner[:-1]
            for part in _split_labels(inner):
                k, _, v = part.partition("=")
                if not (v.startswith('"') and v.endswith('"')):
                    raise ValueError(f"malformed label value: {ln!r}")
                labels[k] = (
                    v[1:-1].replace('\\"', '"').replace("\\\\", "\\")
                )
        if not name.replace("_", "").replace(":", "").isalnum():
            raise ValueError(f"malformed metric name: {ln!r}")
        out.append((name, labels, float(val.replace("+Inf", "inf"))))
    return out


def _split_labels(inner: str) -> list[str]:
    """Split a label set on commas outside quotes."""
    parts, buf, quoted, escaped = [], [], False, False
    for ch in inner:
        if escaped:
            buf.append(ch)
            escaped = False
            continue
        if ch == "\\":
            buf.append(ch)
            escaped = True
            continue
        if ch == '"':
            quoted = not quoted
            buf.append(ch)
            continue
        if ch == "," and not quoted:
            parts.append("".join(buf))
            buf = []
            continue
        buf.append(ch)
    if buf:
        parts.append("".join(buf))
    return [p for p in (s.strip() for s in parts) if p]


def serve_metrics(
    root: str,
    port: int = 9099,
    host: str = "127.0.0.1",
    max_requests: int | None = None,
) -> None:
    """Serve ``GET /metrics`` (Prometheus exposition, regenerated per
    request from the campaign's metrics files) on a stdlib HTTP
    server. Blocks; ``max_requests`` bounds it for tests."""
    from http.server import BaseHTTPRequestHandler, HTTPServer

    class _Handler(BaseHTTPRequestHandler):
        def do_GET(self) -> None:  # noqa: N802 (http.server contract)
            if self.path.rstrip("/") not in ("", "/metrics"):
                self.send_error(404)
                return
            try:
                body = prometheus_exposition(
                    fleet_samples(root)
                ).encode()
            except Exception as exc:
                self.send_error(500, f"{type(exc).__name__}: {exc}")
                return
            self.send_response(200)
            self.send_header(
                "Content-Type", "text/plain; version=0.0.4"
            )
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args) -> None:
            log.debug("metrics http: " + fmt, *args)

    server = HTTPServer((host, port), _Handler)
    log.info(
        "serving campaign metrics at http://%s:%d/metrics (root %s)",
        host, server.server_address[1], root,
    )
    try:
        if max_requests is None:
            server.serve_forever()
        else:
            for _ in range(max_requests):
                server.handle_request()
    finally:
        server.server_close()
