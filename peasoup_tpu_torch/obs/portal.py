"""Per-campaign live status portal (stdlib HTTP, read-only; the port's
copy of the JAX package's obs/portal.py, the same routes and bodies).

One scrape target and one operator URL per campaign: the GSP-style
serving layer the survey-as-a-service direction needs, with zero new
dependencies. The server only ever READS the campaign tree's atomic
artifacts (every one is published via tmp + ``os.replace`` or
append-only JSONL), so it can run beside any number of workers — or on
a different host sharing the campaign filesystem — without joining any
protocol.

Endpoints:

- ``/metrics`` — Prometheus exposition over every worker's time series
  plus the ``ALERTS`` convention series from the alerts snapshot.
- ``/status`` — the campaign rollup JSON (the ``campaign_status.json``
  the workers maintain; rebuilt in-memory when absent).
- ``/alerts`` — the alerts snapshot JSON.
- ``/jobs/<id>`` — one job's queue record, done record, quarantine
  record and trace summary.
- ``/report`` and ``/bowtie.svg`` — the sift HTML report and bowtie
  plot when the campaign has been sifted (``peasoup-sift report`` writes
  both; 404 before).
- ``/tenants`` and ``/tenants/<name>`` — the multi-tenant view: per
  tenant queue tallies, quota vs windowed device-seconds, usage
  ledger, firing alerts, per-tenant sift/bowtie links.
- ``/candidates`` (and ``/tenants/<name>/candidates``) — the ranked
  triage table: score-tier tallies + top candidates, read READ-ONLY
  from the sifted candidates.sqlite.
- ``/usage`` — the usage ledger JSON (``queue/usage.json`` content,
  rebuilt in-memory when absent).
- ``/`` — a small HTML index linking the above.

One WRITE endpoint: ``POST /submit`` — the tenant submission front
end. Authenticated by bearer token (``Authorization: Bearer <token>``
or ``X-Peasoup-Token``) against the tenant registry; the JSON body
``{"input": ..., "priority"?, "config"?, "pipeline"?}`` is admitted
through campaign/ingest.submit_observation (quota-checked, journaled
append-only to ``queue/submissions.jsonl``). The ``input`` path is
CONFINED: it must resolve (realpath, so symlinks cannot escape) under
the tenant's own ``watch_dir`` or an operator-configured ``--data-root``
— otherwise 403. A token only authenticates a tenant; it must not let
them enqueue arbitrary server-readable files (another tenant's drops,
host configuration) for the pipeline to open.
"""

from __future__ import annotations

import html
import json
import os

from .log import get_logger

log = get_logger("obs.portal")

_JOB_ID_OK = frozenset(
    "abcdefghijklmnopqrstuvwxyz"
    "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789._-"
)


def _read_json(path: str) -> dict | None:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def _metrics_body(root: str) -> bytes:
    from .alerts import alerts_exposition, load_alerts
    from .metrics import fleet_samples, prometheus_exposition

    body = prometheus_exposition(fleet_samples(root))
    body += alerts_exposition(load_alerts(root))
    return body.encode()


def _status_body(root: str) -> bytes:
    doc = _read_json(os.path.join(root, "campaign_status.json"))
    if doc is None:
        from ..campaign.rollup import build_status

        doc = build_status(root)
    return (json.dumps(doc, indent=2) + "\n").encode()


def _alerts_body(root: str) -> bytes:
    from .alerts import load_alerts

    return (json.dumps(load_alerts(root), indent=2) + "\n").encode()


def _job_body(root: str, job_id: str) -> bytes | None:
    if not job_id or any(c not in _JOB_ID_OK for c in job_id):
        return None
    job = _read_json(
        os.path.join(root, "queue", "jobs", f"{job_id}.json")
    )
    if job is None:
        return None
    from .trace import load_spans, trace_paths, trace_summary

    doc = {
        "job": job,
        "done": _read_json(
            os.path.join(root, "queue", "done", f"{job_id}.json")
        ),
        "quarantine": _read_json(
            os.path.join(root, "queue", "quarantine", f"{job_id}.json")
        ),
        "trace": trace_summary(
            load_spans(trace_paths(os.path.join(root, "jobs", job_id)))
        ),
    }
    return (json.dumps(doc, indent=2) + "\n").encode()


def _file_body(path: str) -> bytes | None:
    try:
        with open(path, "rb") as f:
            return f.read()
    except OSError:
        return None


def _input_allowed(input_path: str, roots: list[str]) -> bool:
    """Realpath-prefix confinement for HTTP-submitted inputs: the
    fully-resolved path must sit under one of ``roots`` (each itself
    resolved), so neither ``..`` segments nor symlinks reach outside.
    Empty ``roots`` allows nothing — the HTTP door is deny-by-default."""
    rp = os.path.realpath(input_path)
    for root in roots:
        if not root:
            continue
        rr = os.path.realpath(root)
        if rp == rr or rp.startswith(rr + os.sep):
            return True
    return False


def _tenant_sections(root: str) -> tuple[dict, dict]:
    """(tenants, usage) rollup sections — from the workers' snapshot
    when it carries them, rebuilt in-memory otherwise (pre-tenant
    snapshots lack the keys)."""
    st = _read_json(os.path.join(root, "campaign_status.json"))
    if not st or "tenants" not in st:
        from ..campaign.rollup import build_status

        st = build_status(root)
    return (st.get("tenants") or {}), (st.get("usage") or {})


def _tenant_alerts(root: str, name: str | None = None) -> list[dict]:
    """Active alerts labelled with a tenant (optionally one tenant)."""
    from .alerts import load_alerts

    out = []
    for a in load_alerts(root).get("alerts", []):
        if a.get("state") not in ("pending", "firing"):
            continue
        t = (a.get("labels") or {}).get("tenant")
        if not t or (name is not None and t != name):
            continue
        out.append(a)
    return out


def _usage_body(root: str) -> bytes:
    from ..campaign.usage import build_usage, load_usage

    doc = load_usage(root) or build_usage(root)
    return (json.dumps(doc, indent=2) + "\n").encode()


def _tenants_body(root: str) -> bytes:
    tenants, usage = _tenant_sections(root)
    firing: dict[str, int] = {}
    for a in _tenant_alerts(root):
        t = (a.get("labels") or {}).get("tenant", "")
        firing[t] = firing.get(t, 0) + 1
    rows = []
    for name in sorted(tenants):
        rec = tenants[name] or {}
        u = usage.get(name) or {}
        budget = rec.get("device_s_budget")
        wdev = rec.get("window_device_s")
        budget_cell = (
            f"{wdev:.1f} / {budget:.0f}s"
            if budget and wdev is not None
            else (f"{wdev:.1f}s" if wdev is not None else "-")
        )
        safe = html.escape(str(name))
        rows.append(
            f'<tr><td><a href="/tenants/{safe}">{safe}</a></td>'
            f"<td>{rec.get('queued', 0)}</td>"
            f"<td>{rec.get('running', 0)}</td>"
            f"<td>{rec.get('throttled', 0)}</td>"
            f"<td>{rec.get('done', 0)}</td>"
            f"<td>{html.escape(budget_cell)}</td>"
            f"<td>{u.get('jit_programs_compiled', 0)}</td>"
            f"<td>{firing.get(name, 0)}</td>"
            f"<td>{html.escape(str(rec.get('throttle') or '-'))}</td>"
            "</tr>"
        )
    doc = (
        "<!DOCTYPE html><html><head><title>tenants</title></head>"
        "<body><h1>tenants</h1>"
        "<table border=1><tr><th>tenant</th><th>queued</th>"
        "<th>running</th><th>throttled</th><th>done</th>"
        "<th>device-s (window/budget)</th><th>compiles</th>"
        "<th>alerts</th><th>throttle</th></tr>"
        + "".join(rows)
        + '</table><p><a href="/usage">usage ledger (JSON)</a> · '
        '<a href="/">index</a></p></body></html>'
    )
    return doc.encode()


def _tenant_page_body(root: str, name: str) -> bytes | None:
    from ..campaign.tenants import valid_tenant_name

    if not valid_tenant_name(name):
        return None
    tenants, usage = _tenant_sections(root)
    if name not in tenants and name not in usage:
        return None
    rec = tenants.get(name) or {}
    u = usage.get(name) or {}
    safe = html.escape(name)

    def _table(d: dict) -> str:
        return "<table border=1>" + "".join(
            f"<tr><td>{html.escape(str(k))}</td>"
            f"<td>{html.escape(json.dumps(v))}</td></tr>"
            for k, v in sorted(d.items())
        ) + "</table>"

    alerts = _tenant_alerts(root, name)
    alert_lines = "".join(
        f"<li>{html.escape(a.get('rule', ''))} "
        f"[{html.escape(a.get('state', ''))}] "
        f"{html.escape(a.get('message', ''))}</li>"
        for a in alerts
    ) or "<li>none</li>"
    from ..campaign.ingest import read_submissions

    subs = [
        s for s in read_submissions(root)
        # the journal also carries tenant_admin audit entries (token
        # rotation, quota edits) — not submissions, so not listed here
        if s.get("tenant") == name and s.get("kind") != "tenant_admin"
    ][-20:]
    sub_lines = "".join(
        f"<li>{html.escape(str(s.get('input', '')))} via "
        f"{html.escape(str(s.get('via', '')))}: "
        f"{'accepted' if s.get('accepted') else 'rejected'}"
        f"{' (' + html.escape(str(s['reason'])) + ')' if s.get('reason') else ''}"
        "</li>"
        for s in subs
    ) or "<li>none</li>"
    doc = (
        f"<!DOCTYPE html><html><head><title>tenant {safe}</title>"
        f"</head><body><h1>tenant {safe}</h1>"
        f"<h2>queue</h2>{_table({k: v for k, v in rec.items() if k != 'quota'})}"
        f"<h2>quota</h2>{_table(rec.get('quota') or {})}"
        f"<h2>usage</h2>{_table(u)}"
        f"<h2>alerts</h2><ul>{alert_lines}</ul>"
        f"<h2>recent submissions</h2><ul>{sub_lines}</ul>"
        f'<p><a href="/tenants/{safe}/candidates">candidate '
        "triage</a> · "
        '<a href="/report">sift report</a> · '
        '<a href="/bowtie.svg">bowtie</a> · '
        '<a href="/tenants">all tenants</a></p>'
        "</body></html>"
    )
    return doc.encode()


def _candidates_body(
    root: str, tenant: str | None = None, limit: int = 50
) -> bytes | None:
    """The triage page: score-tier tallies + the top-N sifted
    candidates, read directly (and READ-ONLY — the portal must never
    migrate or write a database it merely renders) from the campaign's
    candidates.sqlite. ``tenant`` narrows to rows touching that
    tenant's observations. Tolerates a pre-ranking (v3) database: the
    score columns simply read as absent."""
    import sqlite3

    if tenant is not None:
        from ..campaign.tenants import valid_tenant_name

        if not valid_tenant_name(tenant):
            return None
    db_path = os.path.join(root, "candidates.sqlite")
    if not os.path.exists(db_path):
        return None
    try:
        conn = sqlite3.connect(f"file:{db_path}?mode=ro", uri=True)
    except sqlite3.Error:
        return None
    try:
        conn.row_factory = sqlite3.Row
        cols = {
            r[1]
            for r in conn.execute(
                "PRAGMA table_info(sift_candidates)"
            )
        }
        if not cols:
            return None  # no sift product in this database yet
        has_scores = "score" in cols
        score_sel = (
            "score, score_tier, model_fp"
            if has_scores
            else "NULL AS score, NULL AS score_tier, "
            "NULL AS model_fp"
        )
        rows = [
            dict(r)
            for r in conn.execute(
                f"SELECT label, tier, {score_sel}, dm, snr, period, "
                "folded_snr, n_obs, job_ids FROM sift_candidates "
                "ORDER BY (score IS NULL), score DESC, snr DESC"
            )
        ]
        keep_jobs = None
        if tenant is not None:
            keep_jobs = {
                r[0]
                for r in conn.execute(
                    "SELECT job_id FROM observations "
                    "WHERE COALESCE(tenant, '') = ?",
                    (tenant,),
                )
            }
    except sqlite3.Error:
        return None
    finally:
        conn.close()
    if keep_jobs is not None:
        rows = [
            r for r in rows
            if any(
                j in keep_jobs
                for j in json.loads(r.get("job_ids") or "[]")
            )
        ]
    tier_counts: dict[str, int] = {}
    model_fp = None
    for r in rows:
        st = r.get("score_tier")
        key = str(st) if st is not None else "unscored"
        tier_counts[key] = tier_counts.get(key, 0) + 1
        model_fp = model_fp or r.get("model_fp")
    tally = ", ".join(
        f"{tier_counts.get(k, 0)} {lbl}"
        for k, lbl in (
            ("1", "tier-1"), ("2", "tier-2"), ("3", "tier-3"),
            ("unscored", "unscored"),
        )
    )
    def _num(v, nd: int) -> str:
        return f"{v:.{nd}f}" if v is not None else "-"

    body_rows = []
    for r in rows[:limit]:
        st = r.get("score_tier")
        body_rows.append(
            "<tr>"
            f"<td>{_num(r.get('score'), 3)}</td>"
            f"<td>{st if st is not None else '-'}</td>"
            f"<td>{html.escape(str(r.get('label') or ''))}</td>"
            f"<td>{r.get('tier')}</td>"
            f"<td>{_num(r.get('period'), 6)}</td>"
            f"<td>{_num(r.get('dm'), 2)}</td>"
            f"<td>{_num(r.get('snr'), 1)}</td>"
            f"<td>{_num(r.get('folded_snr'), 1)}</td>"
            f"<td>{r.get('n_obs')}</td>"
            "</tr>"
        )
    title = "candidate triage" + (
        f" — tenant {html.escape(tenant)}" if tenant else ""
    )
    fp_line = (
        f"<p>ranked by model <code>{html.escape(str(model_fp))}"
        "</code></p>"
        if model_fp else "<p>no ranking scores recorded yet</p>"
    )
    doc = (
        f"<!DOCTYPE html><html><head><title>{title}</title></head>"
        f"<body><h1>{title}</h1>"
        f"<p>score tiers: {tally}</p>{fp_line}"
        "<table border=1><tr><th>score</th><th>s-tier</th>"
        "<th>label</th><th>tier</th><th>P (s)</th><th>DM</th>"
        "<th>S/N</th><th>folded S/N</th><th>obs</th></tr>"
        + "".join(body_rows)
        + '</table><p><a href="/report">sift report</a> · '
        '<a href="/">index</a></p></body></html>'
    )
    return doc.encode()


def _index_body(root: str) -> bytes:
    from .alerts import load_alerts

    snap = load_alerts(root)
    by_state: dict[str, int] = {}
    for a in snap.get("alerts", []):
        by_state[a["state"]] = by_state.get(a["state"], 0) + 1
    st = _read_json(os.path.join(root, "campaign_status.json")) or {}
    queue = st.get("queue") or {}
    rows = "".join(
        f"<tr><td>{html.escape(str(k))}</td>"
        f"<td>{html.escape(str(v))}</td></tr>"
        for k, v in sorted(queue.items())
    )
    alert_line = ", ".join(
        f"{by_state.get(s, 0)} {s}"
        for s in ("firing", "pending", "resolved")
    )
    doc = (
        "<!DOCTYPE html><html><head><title>peasoup campaign</title>"
        "</head><body>"
        f"<h1>campaign {html.escape(os.path.basename(root) or root)}"
        "</h1>"
        f"<p>alerts: {alert_line}</p>"
        f"<table>{rows}</table>"
        '<ul><li><a href="/metrics">/metrics</a></li>'
        '<li><a href="/status">/status</a></li>'
        '<li><a href="/alerts">/alerts</a></li>'
        '<li><a href="/tenants">/tenants</a></li>'
        '<li><a href="/usage">/usage</a></li>'
        '<li><a href="/candidates">candidate triage</a></li>'
        '<li><a href="/report">sift report</a></li>'
        '<li><a href="/bowtie.svg">bowtie</a></li></ul>'
        "</body></html>"
    )
    return doc.encode()


def serve_portal(
    root: str,
    port: int = 9100,
    host: str = "127.0.0.1",
    max_requests: int | None = None,
    data_roots: list[str] | None = None,
) -> None:
    """Serve the campaign portal. Blocks; ``max_requests`` bounds it
    for tests and the check gate. ``data_roots`` are the operator's
    shared staging directories HTTP-submitted inputs may come from (a
    tenant's own ``watch_dir`` is always allowed); with none configured
    and no watch_dir, POST /submit rejects every path with 403."""
    from http.server import BaseHTTPRequestHandler, HTTPServer

    root = os.path.abspath(root)
    data_roots = [d for d in (data_roots or []) if d]

    class _Handler(BaseHTTPRequestHandler):
        def do_GET(self) -> None:  # noqa: N802 (http.server contract)
            try:
                body, ctype = self._route(self.path)
            except Exception as exc:
                self.send_error(500, f"{type(exc).__name__}: {exc}")
                return
            if body is None:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _route(self, path: str):
            path = path.split("?", 1)[0].rstrip("/") or "/"
            if path == "/":
                return _index_body(root), "text/html; charset=utf-8"
            if path == "/metrics":
                return _metrics_body(root), "text/plain; version=0.0.4"
            if path == "/status":
                return _status_body(root), "application/json"
            if path == "/alerts":
                return _alerts_body(root), "application/json"
            if path == "/usage":
                return _usage_body(root), "application/json"
            if path == "/candidates":
                return (
                    _candidates_body(root),
                    "text/html; charset=utf-8",
                )
            if path == "/tenants":
                return _tenants_body(root), "text/html; charset=utf-8"
            if path.startswith("/tenants/") and path.endswith(
                "/candidates"
            ):
                name = path[len("/tenants/"):-len("/candidates")]
                return (
                    _candidates_body(root, tenant=name),
                    "text/html; charset=utf-8",
                )
            if path.startswith("/tenants/"):
                return (
                    _tenant_page_body(root, path[len("/tenants/"):]),
                    "text/html; charset=utf-8",
                )
            if path.startswith("/jobs/"):
                return (
                    _job_body(root, path[len("/jobs/"):]),
                    "application/json",
                )
            if path == "/report":
                return (
                    _file_body(
                        os.path.join(root, "sift", "report.html")
                    ),
                    "text/html; charset=utf-8",
                )
            if path == "/bowtie.svg":
                return (
                    _file_body(os.path.join(root, "sift", "bowtie.svg")),
                    "image/svg+xml",
                )
            return None, ""

        def do_POST(self) -> None:  # noqa: N802 (http.server contract)
            try:
                self._post()
            except Exception as exc:
                self.send_error(500, f"{type(exc).__name__}: {exc}")

        def _post(self) -> None:
            path = self.path.split("?", 1)[0].rstrip("/")
            if path != "/submit":
                self.send_error(404)
                return
            from ..campaign.ingest import submit_observation
            from ..campaign.tenants import TenantRegistry

            token = ""
            auth = self.headers.get("Authorization") or ""
            if auth.lower().startswith("bearer "):
                token = auth[len("bearer "):].strip()
            if not token:
                token = (self.headers.get("X-Peasoup-Token") or "").strip()
            tenant = TenantRegistry(root).by_token(token)
            if tenant is None:
                self._json(401, {"error": "missing or invalid token"})
                return
            try:
                length = int(self.headers.get("Content-Length") or 0)
            except ValueError:
                length = 0
            if length <= 0 or length > 1 << 20:
                self._json(400, {"error": "bad Content-Length"})
                return
            try:
                doc = json.loads(self.rfile.read(length))
            except (ValueError, OSError):
                self._json(400, {"error": "malformed JSON body"})
                return
            if not isinstance(doc, dict) or not isinstance(
                doc.get("input"), str
            ):
                self._json(400, {"error": 'body needs a string "input"'})
                return
            try:
                priority = int(doc.get("priority", 0))
            except (TypeError, ValueError):
                self._json(400, {"error": "priority must be an integer"})
                return
            config = doc.get("config")
            if config is not None and not isinstance(config, dict):
                self._json(400, {"error": "config must be an object"})
                return
            allowed = list(data_roots)
            if tenant.watch_dir:
                allowed.append(tenant.watch_dir)
            if not _input_allowed(doc["input"], allowed):
                import time

                from ..campaign.ingest import append_submission

                now_unix = time.time()
                entry = {
                    "t_unix": round(now_unix, 3),
                    "via": "http",
                    "tenant": tenant.name,
                    "input": doc["input"],
                    "pipeline": str(doc.get("pipeline") or "spsearch"),
                    "priority": priority,
                    "priority_capped": False,
                    "accepted": False,
                    "reason": (
                        "input outside the tenant watch_dir and the "
                        "portal --data-root allowlist"
                    ),
                    "job_id": None,
                }
                append_submission(root, entry)
                self._json(403, entry)
                return
            entry = submit_observation(
                root,
                tenant.name,
                doc["input"],
                priority=priority,
                config=config,
                pipeline=str(doc.get("pipeline") or "spsearch"),
                via="http",
            )
            if entry.get("accepted"):
                code = 200
            else:
                reason = str(entry.get("reason") or "")
                if reason.startswith("duplicate"):
                    code = 409
                elif reason.startswith("max_queued"):
                    code = 429
                else:
                    code = 400
            self._json(code, entry)

        def _json(self, code: int, doc: dict) -> None:
            body = (json.dumps(doc) + "\n").encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args) -> None:
            log.debug("portal http: " + fmt, *args)

    server = HTTPServer((host, port), _Handler)
    log.info(
        "serving campaign portal at http://%s:%d/ (root %s)",
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
