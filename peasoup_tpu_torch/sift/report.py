"""The survey report: one JSON document, one self-contained HTML page
(the JAX package's sift/report.py).

``peasoup-sift report`` renders the sifted product (the ``sift_*``
tables) into:

- a schema-validated JSON report (``report.schema.json`` beside this
  module, the port's copy of the JAX package's, through the port's
  dependency-free :mod:`peasoup_tpu_torch.obs.schema` validator);
  ``peasoup_tpu.sift_report`` names the file format both packages share;
- a **self-contained** HTML page: zero external assets, the full report
  JSON inlined in a ``<script type="application/json">`` block, tables
  rendered server-side and fold postage stamps drawn as inline SVG.

``build_report`` takes the campaign rollup (campaign/rollup.py) as an
argument, which the CLI reads from the workdir; the CLI also writes the
DM-time bowtie plot (tools/plotting.py) beside the report and links it.
"""

from __future__ import annotations

import html
import json
import os
import time

from ..campaign.db import CandidateDB
from ..obs.schema import validate

REPORT_SCHEMA = "peasoup_tpu.sift_report"
REPORT_VERSION = 1

_SCHEMA_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "report.schema.json"
)


def validate_report(doc: dict) -> None:
    """Validate a report document against the checked-in JSON Schema;
    raises ``obs.schema.SchemaError`` on drift."""
    with open(_SCHEMA_PATH) as f:
        schema = json.load(f)
    validate(doc, schema)


def _tenant_jobs(db: CandidateDB, tenant: str) -> set:
    """Job ids of observations stamped with this tenant."""
    return {
        o["job_id"]
        for o in db.observations()
        if (o.get("tenant") or "") == tenant
    }


def build_report(
    db: CandidateDB,
    campaign_status: dict | None = None,
    *,
    limit: int = 50,
    tenant: str | None = None,
) -> dict:
    """Aggregate DB + rollup into the report document. With ``tenant``
    the catalogue/known/SP sections keep only rows touching that
    tenant's observations (the sifted product itself is campaign-wide;
    this is a view)."""
    run = db.latest_sift_run()
    if run is None:
        raise RuntimeError(
            "no sift run in the database — run `peasoup-sift run` first"
        )
    keep_jobs = _tenant_jobs(db, tenant) if tenant else None
    full = db.sift_catalogue()
    for row in full:
        row["job_ids"] = json.loads(row.get("job_ids") or "[]")
        fold = row.pop("fold_json", None)
        row["fold"] = json.loads(fold) if fold else None
    if keep_jobs is not None:
        full = [
            row for row in full
            if any(j in keep_jobs for j in row["job_ids"])
        ]
    catalogue = full[:limit] if limit else full
    known = db.sift_known_matches()
    if keep_jobs is not None:
        known = [m for m in known if m.get("job_id") in keep_jobs]
    by_psr: dict[str, dict] = {}
    for m in known:
        rec = by_psr.setdefault(
            m["psr"],
            {
                "psr": m["psr"], "psr_period": m["psr_period"],
                "psr_dm": m["psr_dm"], "n_matches": 0,
                "harmonics": [], "job_ids": [],
            },
        )
        rec["n_matches"] += 1
        if m["harmonic"] not in rec["harmonics"]:
            rec["harmonics"].append(m["harmonic"])
        if m["job_id"] not in rec["job_ids"]:
            rec["job_ids"].append(m["job_id"])
    sp_sources = db.sift_sp_sources()
    for s in sp_sources:
        s["job_ids"] = json.loads(s.get("job_ids") or "[]")
        s["toas_s"] = json.loads(s.get("toas_s") or "[]")
    if keep_jobs is not None:
        sp_sources = [
            s for s in sp_sources
            if any(j in keep_jobs for j in s["job_ids"])
        ]
    tiers: dict[str, int] = {}
    labels: dict[str, int] = {}
    score_tiers: dict[str, int] = {}
    model_fp = None
    for row in full:
        tiers[str(row["tier"])] = tiers.get(str(row["tier"]), 0) + 1
        labels[row["label"]] = labels.get(row["label"], 0) + 1
        st = row.get("score_tier")
        if st is not None:
            score_tiers[str(st)] = score_tiers.get(str(st), 0) + 1
            model_fp = model_fp or row.get("model_fp")
    counts = db.counts()
    n_observations = (
        len(keep_jobs)
        if keep_jobs is not None else counts["observations"]
    )
    return {
        "schema": REPORT_SCHEMA,
        "version": REPORT_VERSION,
        "generated_unix": time.time(),
        "run": {
            "run_id": run["run_id"],
            "created_unix": run["created_unix"],
            "config": json.loads(run.get("config") or "{}"),
            "n_folded": run["n_folded"],
            "n_catalogue": run["n_catalogue"],
            "n_known": run["n_known"],
            "n_rfi": run["n_rfi"],
            "n_sp_sources": run["n_sp_sources"],
        },
        "observations": n_observations,
        "candidates": counts["candidates"],
        "tiers": tiers,
        "labels": labels,
        "score_tiers": score_tiers,
        "model_fp": model_fp,
        "tenant": tenant or None,
        "known_sources": sorted(
            by_psr.values(), key=lambda r: -r["n_matches"]
        ),
        "catalogue": catalogue,
        "sp_sources": sp_sources,
        "campaign": campaign_status,
    }


# --------------------------------------------------------------------------
# HTML rendering (self-contained: no external assets)
# --------------------------------------------------------------------------

_CSS = """
body { font: 14px/1.45 system-ui, sans-serif; margin: 2em auto;
       max-width: 70em; color: #1a1a2e; }
h1, h2 { font-weight: 600; }
table { border-collapse: collapse; width: 100%; margin: 0.8em 0; }
th, td { text-align: left; padding: 0.3em 0.7em;
         border-bottom: 1px solid #ddd; white-space: nowrap; }
th { background: #f4f4f8; }
.tier1 { background: #e8f6e8; } .tier2 { background: #fdf7e2; }
.rfi   { color: #a33; } .known { color: #2563eb; font-weight: 600; }
.tally { display: inline-block; margin-right: 2em; }
.tally b { font-size: 1.6em; display: block; }
svg.prof { vertical-align: middle; }
"""


def _sparkline(values: list[float], w: int = 120, h: int = 24) -> str:
    """Inline SVG profile sparkline for a fold postage stamp."""
    if not values:
        return ""
    lo, hi = min(values), max(values)
    span = (hi - lo) or 1.0
    n = len(values)
    pts = " ".join(
        f"{i * w / max(1, n - 1):.1f},"
        f"{h - (v - lo) / span * (h - 2) - 1:.1f}"
        for i, v in enumerate(values)
    )
    return (
        f'<svg class="prof" width="{w}" height="{h}">'
        f'<polyline points="{pts}" fill="none" stroke="#2563eb" '
        f'stroke-width="1.2"/></svg>'
    )


def _fmt(v, nd=3):
    if v is None:
        return "–"
    if isinstance(v, float):
        return f"{v:.{nd}f}"
    return html.escape(str(v))


def render_html(doc: dict, bowtie_href: str | None = None) -> str:
    """The self-contained survey page. The full report JSON is inlined
    (``</`` escaped so a string can never close the script block) —
    saving the page saves the data. ``bowtie_href`` links the DM-time
    bowtie diagnostic SVG beside the report (tools/plotting.py)."""
    run = doc["run"]
    parts = [
        "<!doctype html><html><head><meta charset='utf-8'>",
        f"<title>peasoup-sift survey report {run['run_id']}</title>",
        f"<style>{_CSS}</style></head><body>",
        f"<h1>Survey sifting report <code>{run['run_id']}</code></h1>",
        "<p>",
        f"generated {time.strftime('%Y-%m-%d %H:%M:%S UTC', time.gmtime(doc['generated_unix']))}"
        f" · {doc['observations']} observations"
        + (
            f" · tenant <code>{html.escape(doc['tenant'])}</code>"
            if doc.get("tenant") else ""
        ),
        "</p><div>",
    ]
    score_tiers = doc.get("score_tiers") or {}
    tallies = [
        ("catalogue rows", run["n_catalogue"]),
        ("known sources", run["n_known"]),
        ("RFI vetoed", run["n_rfi"]),
        ("repeat SP sources", run["n_sp_sources"]),
        ("candidates folded", run["n_folded"]),
    ]
    if score_tiers:
        tallies.append(("score tier 1", score_tiers.get("1", 0)))
    for label, n in tallies:
        parts.append(
            f"<span class='tally'><b>{n}</b>{label}</span>"
        )
    parts.append("</div><h2>Candidate catalogue</h2>")
    if doc.get("model_fp"):
        parts.append(
            f"<p>ranked by model <code>"
            f"{html.escape(doc['model_fp'])}</code> (score is the "
            "calibrated P(pulsar); s-tier 1 = review first)</p>"
        )
    parts.append("<table>")
    parts.append(
        "<tr><th>tier</th><th>label</th><th>score</th>"
        "<th>s-tier</th><th>P (s)</th><th>DM</th>"
        "<th>S/N</th><th>folded S/N</th><th>obs</th><th>members</th>"
        "<th>source</th><th>harm</th><th>profile</th></tr>"
    )
    for row in doc["catalogue"]:
        cls = []
        if row["tier"] == 1:
            cls.append("tier1")
        elif row["tier"] == 2:
            cls.append("tier2")
        if row["label"] == "rfi":
            cls.append("rfi")
        prof = (row.get("fold") or {}).get("prof") or []
        src = row.get("known_source")
        stier = row.get("score_tier")
        parts.append(
            f"<tr class='{' '.join(cls)}'>"
            f"<td>{row['tier']}</td><td>{row['label']}</td>"
            f"<td>{_fmt(row.get('score'), 3)}</td>"
            f"<td>{stier if stier is not None else '–'}</td>"
            f"<td>{_fmt(row['period'], 6)}</td>"
            f"<td>{_fmt(row['dm'], 2)}</td>"
            f"<td>{_fmt(row['snr'], 1)}</td>"
            f"<td>{_fmt(row['folded_snr'], 1)}</td>"
            f"<td>{row['n_obs']}</td><td>{row['members']}</td>"
            f"<td>{'<span class=known>' + html.escape(src) + '</span>' if src else '–'}</td>"
            f"<td>{_fmt(row.get('harmonic'))}</td>"
            f"<td>{_sparkline(prof)}</td></tr>"
        )
    parts.append("</table><h2>Known-source tally</h2><table>")
    parts.append(
        "<tr><th>pulsar</th><th>P0 (s)</th><th>DM</th>"
        "<th>matches</th><th>harmonics</th><th>observations</th></tr>"
    )
    for rec in doc["known_sources"]:
        parts.append(
            f"<tr><td class='known'>{html.escape(rec['psr'])}</td>"
            f"<td>{_fmt(rec['psr_period'], 6)}</td>"
            f"<td>{_fmt(rec['psr_dm'], 2)}</td>"
            f"<td>{rec['n_matches']}</td>"
            f"<td>{html.escape(', '.join(rec['harmonics']))}</td>"
            f"<td>{len(rec['job_ids'])}</td></tr>"
        )
    parts.append(
        "</table><h2>Repeat single-pulse sources</h2><table>"
    )
    parts.append(
        "<tr><th>DM</th><th>pulses</th><th>obs</th><th>best S/N</th>"
        "<th>inferred P (s)</th><th>phase resid</th></tr>"
    )
    for s in doc["sp_sources"]:
        parts.append(
            f"<tr><td>{_fmt(s['dm'], 2)}</td><td>{s['n_pulses']}</td>"
            f"<td>{s['n_obs']}</td><td>{_fmt(s['best_snr'], 1)}</td>"
            f"<td>{_fmt(s['period_s'], 6)}</td>"
            f"<td>{_fmt(s['period_frac_resid'], 4)}</td></tr>"
        )
    parts.append("</table>")
    if bowtie_href:
        parts.append(
            f"<p><a href='{html.escape(bowtie_href)}'>DM&#8211;time "
            "bowtie diagnostic</a> (all single-pulse detections, "
            "marker area &#8733; S/N)</p>"
        )
    camp = doc.get("campaign")
    if camp:
        q = camp.get("queue") or {}
        parts.append(
            "<h2>Campaign</h2><p>"
            f"{q.get('done', 0)}/{q.get('total', 0)} observations done, "
            f"{q.get('quarantined', 0)} quarantined · "
            f"{camp.get('candidates_total', 0)} raw candidates</p>"
        )
    payload = json.dumps(doc).replace("</", "<\\/")
    parts.append(
        f'<script type="application/json" id="sift-report">'
        f"{payload}</script>"
    )
    parts.append("</body></html>")
    return "".join(parts)


def write_report(
    doc: dict,
    json_path: str | None,
    html_path: str | None,
    bowtie_href: str | None = None,
) -> None:
    """Validate then write the requested artefacts (atomic rename)."""
    validate_report(doc)
    for path, payload in (
        (json_path, json.dumps(doc, indent=2) + "\n"),
        (html_path, render_html(doc, bowtie_href=bowtie_href)),
    ):
        if not path:
            continue
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(payload)
        os.replace(tmp, path)
