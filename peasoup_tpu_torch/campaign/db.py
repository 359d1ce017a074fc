"""Survey-level candidate database (stdlib sqlite): the port's copy of
the JAX package's campaign/db.py. Both packages read and write one file
format: the same tables, columns and ``PRAGMA user_version``, so a database
either wrote opens in the other.

One sqlite file per campaign holds:

- ``observations`` — one row per ingested job: input path, header
  provenance (source, tstart, tsamp, nchans, nsamps, beam, sky
  position, tenant), ingest time.
- ``candidates`` — one row per candidate with ``kind`` in
  ``('periodicity', 'single_pulse')``; periodicity rows carry
  period/acc/harmonic columns, single-pulse rows carry
  time/width/members columns, both share dm/snr.
- the ``sift_*`` tables — the sifted survey product written by
  ``peasoup-sift`` (:mod:`peasoup_tpu_torch.sift`): the deduplicated
  catalogue with its scores, known-pulsar cross-matches, and repeat
  single-pulse (RRAT) sources.

**Schema versioning**: opening an older database migrates it in place
through :data:`MIGRATIONS` (databases written before versioning existed
read as version 1); opening a *newer* one raises
:class:`SchemaVersionError` — never silently misread a future schema.

Ingest is idempotent per job (delete + reinsert under one transaction);
the sift ingest replaces the whole sifted product the same way (latest
run wins). Writes from concurrent workers serialise on sqlite's locking
(WAL where the filesystem supports it, a generous busy timeout) and
:data:`~peasoup_tpu_torch.resilience.policy.DB_RETRY` around every
transaction.
"""

from __future__ import annotations

import json
import os
import sqlite3
import time

from ..obs.log import get_logger
from ..resilience import faults
from ..resilience.policy import DB_RETRY

log = get_logger("campaign.db")

DB_FILENAME = "candidates.sqlite"

#: Current on-disk schema version (PRAGMA user_version).
#: 1 — the first campaign schema (observations + candidates), written
#:     before explicit versioning; detected by table presence.
#: 2 — observations gain beam/src_raj/src_dej provenance and the
#:     ``sift_*`` tables arrive (the peasoup-sift product).
#: 3 — observations gain the ``tenant`` stamp (multi-tenant usage
#:     accounting + per-tenant sift slices).
#: 4 — sift_candidates gain ``score``/``score_tier``/``model_fp``
#:     (the peasoup-rank calibrated scorer's output + provenance).
SCHEMA_VERSION = 4


class SchemaVersionError(RuntimeError):
    """The database was written by a newer version than this one."""


# version-1 base tables (unchanged since then; legacy DBs have exactly
# these and migrate forward from here)
_SCHEMA_V1 = """
CREATE TABLE IF NOT EXISTS observations (
    job_id       TEXT PRIMARY KEY,
    input        TEXT,
    source_name  TEXT,
    tstart       REAL,
    tsamp        REAL,
    nchans       INTEGER,
    nsamps       INTEGER,
    ingested_unix REAL
);
CREATE TABLE IF NOT EXISTS candidates (
    id        INTEGER PRIMARY KEY,
    job_id    TEXT NOT NULL REFERENCES observations(job_id),
    kind      TEXT NOT NULL CHECK (kind IN ('periodicity', 'single_pulse')),
    dm        REAL,
    snr       REAL,
    -- periodicity columns
    period    REAL,
    opt_period REAL,
    acc       REAL,
    nh        INTEGER,
    folded_snr REAL,
    -- single-pulse columns
    time_s    REAL,
    sample    INTEGER,
    width     INTEGER,
    members   INTEGER
);
CREATE INDEX IF NOT EXISTS idx_cand_snr ON candidates (kind, snr DESC);
CREATE INDEX IF NOT EXISTS idx_cand_job ON candidates (job_id);
CREATE INDEX IF NOT EXISTS idx_cand_dm ON candidates (dm);
"""

# columns added to observations in version 2 (multi-beam coincidence
# and sky-position association need beam + pointing provenance)
_OBS_V2_COLUMNS = (
    ("beam", "INTEGER"),
    ("src_raj", "REAL"),
    ("src_dej", "REAL"),
)

# version-2 sift tables: the peasoup-sift product. One sifted run at a
# time (latest wins — the sift ingest replaces these wholesale), so
# downstream readers never see a half-old half-new catalogue.
_SCHEMA_SIFT = """
CREATE TABLE IF NOT EXISTS sift_runs (
    run_id        TEXT PRIMARY KEY,
    created_unix  REAL,
    config        TEXT,
    n_folded      INTEGER,
    n_catalogue   INTEGER,
    n_known       INTEGER,
    n_rfi         INTEGER,
    n_sp_sources  INTEGER
);
CREATE TABLE IF NOT EXISTS sift_candidates (
    id          INTEGER PRIMARY KEY,
    run_id      TEXT NOT NULL REFERENCES sift_runs(run_id),
    kind        TEXT NOT NULL CHECK (kind IN ('periodicity', 'single_pulse')),
    label       TEXT NOT NULL CHECK (label IN ('candidate', 'known', 'rfi')),
    tier        INTEGER NOT NULL,
    dm          REAL,
    snr         REAL,
    period      REAL,
    folded_snr  REAL,
    opt_period  REAL,
    known_source TEXT,
    harmonic    TEXT,
    n_obs       INTEGER,
    members     INTEGER,
    job_ids     TEXT,
    fold_json   TEXT
);
CREATE INDEX IF NOT EXISTS idx_sift_cand ON sift_candidates (label, tier, snr DESC);
CREATE TABLE IF NOT EXISTS sift_known_matches (
    id             INTEGER PRIMARY KEY,
    run_id         TEXT NOT NULL REFERENCES sift_runs(run_id),
    candidate_id   INTEGER REFERENCES candidates(id),
    job_id         TEXT,
    psr            TEXT,
    psr_period     REAL,
    psr_dm         REAL,
    harmonic       TEXT,
    period_frac_err REAL,
    dm_err         REAL
);
CREATE TABLE IF NOT EXISTS sift_sp_sources (
    id                INTEGER PRIMARY KEY,
    run_id            TEXT NOT NULL REFERENCES sift_runs(run_id),
    dm                REAL,
    n_obs             INTEGER,
    n_pulses          INTEGER,
    best_snr          REAL,
    period_s          REAL,
    period_frac_resid REAL,
    job_ids           TEXT,
    toas_s            TEXT
);
"""

_SIFT_TABLES = (
    "sift_candidates", "sift_known_matches", "sift_sp_sources",
    "sift_runs",
)


def _exec_script(conn: sqlite3.Connection, script: str) -> None:
    """Run a multi-statement DDL script with plain ``execute`` calls:
    ``executescript`` would implicitly COMMIT the caller's migration
    transaction (sqlite3 legacy transaction control), and these scripts
    carry no embedded semicolons."""
    for stmt in script.split(";"):
        if stmt.strip():
            conn.execute(stmt)


def _migrate_1_to_2(conn: sqlite3.Connection) -> None:
    """v1 -> v2: beam/sky provenance columns + the sift tables."""
    existing = {
        r[1] for r in conn.execute("PRAGMA table_info(observations)")
    }
    for col, typ in _OBS_V2_COLUMNS:
        if col not in existing:
            conn.execute(
                f"ALTER TABLE observations ADD COLUMN {col} {typ}"
            )
    _exec_script(conn, _SCHEMA_SIFT)


# column added to observations in version 3: the tenant stamp
_OBS_V3_COLUMNS = (("tenant", "TEXT"),)


def _migrate_2_to_3(conn: sqlite3.Connection) -> None:
    """v2 -> v3: the observations.tenant stamp."""
    existing = {
        r[1] for r in conn.execute("PRAGMA table_info(observations)")
    }
    for col, typ in _OBS_V3_COLUMNS:
        if col not in existing:
            conn.execute(
                f"ALTER TABLE observations ADD COLUMN {col} {typ}"
            )


# columns added to sift_candidates in version 4: the rank scorer's
# calibrated probability, triage tier, and the fingerprint of the
# model artifact that produced them
_SIFT_V4_COLUMNS = (
    ("score", "REAL"),
    ("score_tier", "INTEGER"),
    ("model_fp", "TEXT"),
)


def _migrate_3_to_4(conn: sqlite3.Connection) -> None:
    """v3 -> v4: ranking columns on sift_candidates."""
    existing = {
        r[1] for r in conn.execute("PRAGMA table_info(sift_candidates)")
    }
    for col, typ in _SIFT_V4_COLUMNS:
        if col not in existing:
            conn.execute(
                f"ALTER TABLE sift_candidates ADD COLUMN {col} {typ}"
            )


#: in-place upgrades, keyed by FROM-version; applied in sequence until
#: the file reads :data:`SCHEMA_VERSION`
MIGRATIONS = {1: _migrate_1_to_2, 2: _migrate_2_to_3, 3: _migrate_3_to_4}


def _fnum(v, cast=float, default=None):
    """Header values arrive as strings from overview.xml; coerce with a
    default rather than failing ingest on a missing/blank field."""
    try:
        return cast(float(v))
    except (TypeError, ValueError):
        return default


class CandidateDB:
    """The campaign's sqlite candidate store."""

    def __init__(self, path: str, busy_timeout_ms: int = 30000) -> None:
        self.path = path
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self._conn = sqlite3.connect(
            path, timeout=max(0.001, busy_timeout_ms / 1000.0)
        )
        self._conn.row_factory = sqlite3.Row
        try:
            self._conn.execute("PRAGMA journal_mode=WAL")
        except sqlite3.OperationalError:
            pass  # WAL unsupported on some shared filesystems
        # first line of defence against concurrent writers; the
        # resilience DB_RETRY wrapped around every transaction is the
        # second (sqlite can still surface `database is locked` when a
        # writer starves the handle past this timeout). Tests shrink it
        # to force real two-process contention through the retry path.
        self._conn.execute(f"PRAGMA busy_timeout={int(busy_timeout_ms)}")
        # open = migrate: racing workers serialise on BEGIN IMMEDIATE
        # and the loser finds the work already done
        DB_RETRY.call(self._migrate, site="db.migrate", context=path)

    # --- schema versioning -------------------------------------------
    def schema_version(self) -> int:
        v = int(self._conn.execute("PRAGMA user_version").fetchone()[0])
        if v == 0:
            has_tables = self._conn.execute(
                "SELECT name FROM sqlite_master WHERE type='table' "
                "AND name='candidates'"
            ).fetchone()
            if has_tables:
                return 1  # pre-versioning campaign DB
        return v

    def _migrate(self) -> None:
        v = self.schema_version()
        if v > SCHEMA_VERSION:
            raise SchemaVersionError(
                f"{self.path}: database schema version {v} is newer "
                f"than this package (supports <= {SCHEMA_VERSION}); "
                "upgrade the software, do not let it touch this file"
            )
        if v == SCHEMA_VERSION:
            return
        # one writer migrates; BEGIN IMMEDIATE takes the write lock up
        # front so a racing opener blocks (busy timeout) instead of
        # both running the ALTERs
        self._conn.execute("BEGIN IMMEDIATE")
        try:
            v = self.schema_version()  # re-check under the lock
            if v > SCHEMA_VERSION:
                raise SchemaVersionError(
                    f"{self.path}: schema version {v} from the future"
                )
            if v == 0:
                _exec_script(self._conn, _SCHEMA_V1)
                _migrate_1_to_2(self._conn)
                _migrate_2_to_3(self._conn)
                _migrate_3_to_4(self._conn)
            else:
                for step in range(v, SCHEMA_VERSION):
                    MIGRATIONS[step](self._conn)
                    log.info(
                        "migrated %s: schema v%d -> v%d",
                        self.path, step, step + 1,
                    )
            self._conn.execute(f"PRAGMA user_version = {SCHEMA_VERSION}")
        except BaseException:
            self._conn.execute("ROLLBACK")
            raise
        else:
            self._conn.execute("COMMIT")

    def close(self) -> None:
        self._conn.close()

    def __enter__(self) -> "CandidateDB":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # --- ingest -------------------------------------------------------
    def ingest_job(
        self,
        job_id: str,
        job_dir: str,
        input_path: str = "",
        tenant: str = "",
    ) -> dict:
        """Ingest one completed job's outputs (idempotent: any prior
        rows for ``job_id`` are replaced in the same transaction).
        Returns counts of ingested rows per kind."""
        from ..tools.parsers import OverviewFile

        xml_path = os.path.join(job_dir, "overview.xml")
        ov = OverviewFile(xml_path)
        hdr = ov.header
        counts = {"periodicity": 0, "single_pulse": 0}
        rows: list[tuple] = []
        for c in ov.candidates:
            rows.append(
                (
                    job_id, "periodicity", float(c["dm"]), float(c["snr"]),
                    float(c["period"]), float(c["opt_period"]),
                    float(c["acc"]), int(c["nh"]), float(c["folded_snr"]),
                    None, None, None, None,
                )
            )
            counts["periodicity"] += 1
        for c in ov.sp_candidates:
            rows.append(
                (
                    job_id, "single_pulse", float(c["dm"]), float(c["snr"]),
                    None, None, None, None, None,
                    float(c["time_s"]), int(c["sample"]), int(c["width"]),
                    int(c["members"]),
                )
            )
            counts["single_pulse"] += 1
        ingested_unix = time.time()

        def _ingest_txn():
            faults.fire("db.ingest", context=job_id)
            with self._conn:  # one transaction: delete + reinsert
                self._conn.execute(
                    "DELETE FROM candidates WHERE job_id = ?", (job_id,)
                )
                self._conn.execute(
                    "INSERT OR REPLACE INTO observations (job_id, "
                    "input, source_name, tstart, tsamp, nchans, nsamps, "
                    "ingested_unix, beam, src_raj, src_dej, tenant) "
                    "VALUES (?,?,?,?,?,?,?,?,?,?,?,?)",
                    (
                        job_id,
                        input_path or hdr.get("rawdatafile", ""),
                        hdr.get("source_name", ""),
                        float(hdr.get("tstart", 0) or 0),
                        float(hdr.get("tsamp", 0) or 0),
                        int(float(hdr.get("nchans", 0) or 0)),
                        int(float(hdr.get("nsamples", 0) or 0)),
                        ingested_unix,
                        _fnum(hdr.get("ibeam"), int, 0),
                        _fnum(hdr.get("src_raj"), float, 0.0),
                        _fnum(hdr.get("src_dej"), float, 0.0),
                        tenant or "",
                    ),
                )
                self._conn.executemany(
                    "INSERT INTO candidates (job_id, kind, dm, snr, "
                    "period, opt_period, acc, nh, folded_snr, time_s, "
                    "sample, width, members) VALUES "
                    "(?,?,?,?,?,?,?,?,?,?,?,?,?)",
                    rows,
                )

        # WAL + busy_timeout serialise most contention, but two racing
        # ingesters can still surface `database is locked` (e.g. a
        # checkpoint starving the write lock past the timeout); the
        # transaction is idempotent, so the shared bounded-backoff
        # policy retries it whole
        DB_RETRY.call(_ingest_txn, site="db.ingest", context=job_id)
        log.info(
            "ingested %s: %d periodicity + %d single-pulse candidates",
            job_id, counts["periodicity"], counts["single_pulse"],
        )
        return counts

    # --- queries ------------------------------------------------------
    def _query(self, q: str, args=()) -> list[dict]:
        """Read path under the same busy/locked retry as ingest (a
        reader can see SQLITE_BUSY during a WAL checkpoint)."""
        return DB_RETRY.call(
            lambda: [dict(r) for r in self._conn.execute(q, args)],
            site="db.query",
        )

    def top_candidates(
        self, kind: str | None = None, limit: int = 20
    ) -> list[dict]:
        q = "SELECT c.*, o.source_name FROM candidates c JOIN observations o ON o.job_id = c.job_id"
        args: list = []
        if kind:
            q += " WHERE c.kind = ?"
            args.append(kind)
        q += " ORDER BY c.snr DESC LIMIT ?"
        args.append(int(limit))
        return self._query(q, args)

    def counts(self) -> dict:
        obs = self._query("SELECT COUNT(*) AS n FROM observations")
        by_kind = {
            r["kind"]: r["n"]
            for r in self._query(
                "SELECT kind, COUNT(*) AS n FROM candidates GROUP BY kind"
            )
        }
        return {"observations": obs[0]["n"], "candidates": by_kind}

    def candidates_for(self, job_id: str) -> list[dict]:
        return self._query(
            "SELECT * FROM candidates WHERE job_id = ? ORDER BY snr DESC",
            (job_id,),
        )

    def observations(self) -> list[dict]:
        return self._query(
            "SELECT * FROM observations ORDER BY tstart, job_id"
        )

    def max_observation_rowid(self) -> int:
        """High-water mark over ingested observations — the
        incremental-sift watermark (``peasoup-sift run --incremental``
        re-sifts only when this moved past the last run's recorded
        value). A re-ingested job bumps its rowid (INSERT OR REPLACE),
        which correctly reads as new data."""
        rows = self._query(
            "SELECT COALESCE(MAX(rowid), 0) AS hi FROM observations"
        )
        return int(rows[0]["hi"]) if rows else 0

    def all_candidates(self, kind: str | None = None) -> list[dict]:
        """Every candidate joined with its observation's provenance —
        the sift passes consume this (cross-observation association
        needs tstart/beam/position next to each detection)."""
        q = (
            "SELECT c.*, o.source_name, o.tstart AS obs_tstart, "
            "o.tsamp AS obs_tsamp, o.input AS obs_input, o.beam, "
            "o.src_raj, o.src_dej, o.nsamps AS obs_nsamps, o.tenant "
            "FROM candidates c JOIN observations o "
            "ON o.job_id = c.job_id"
        )
        args: list = []
        if kind:
            q += " WHERE c.kind = ?"
            args.append(kind)
        q += " ORDER BY c.snr DESC, c.id"
        return self._query(q, args)

    # --- the sifted product ------------------------------------------
    def ingest_sift_run(
        self,
        run_id: str,
        config: dict,
        catalogue: list[dict],
        known_matches: list[dict],
        sp_sources: list[dict],
    ) -> dict:
        """Replace the sifted survey product with one run's output in a
        single transaction (idempotent: latest run wins wholesale, so a
        reader never joins half-old tables). Returns the tally row."""
        tally = {
            "n_folded": int(config.get("n_folded", 0)),
            "n_catalogue": len(catalogue),
            "n_known": sum(1 for c in catalogue if c["label"] == "known"),
            "n_rfi": sum(1 for c in catalogue if c["label"] == "rfi"),
            "n_sp_sources": len(sp_sources),
        }

        created_unix = time.time()

        def _txn():
            faults.fire("db.ingest", context=f"sift:{run_id}")
            with self._conn:
                for t in _SIFT_TABLES:
                    self._conn.execute(f"DELETE FROM {t}")
                self._conn.execute(
                    "INSERT INTO sift_runs (run_id, created_unix, "
                    "config, n_folded, n_catalogue, n_known, n_rfi, "
                    "n_sp_sources) VALUES (?,?,?,?,?,?,?,?)",
                    (
                        run_id, created_unix,
                        json.dumps(config, sort_keys=True),
                        tally["n_folded"], tally["n_catalogue"],
                        tally["n_known"], tally["n_rfi"],
                        tally["n_sp_sources"],
                    ),
                )
                self._conn.executemany(
                    "INSERT INTO sift_candidates (run_id, kind, label, "
                    "tier, dm, snr, period, folded_snr, opt_period, "
                    "known_source, harmonic, n_obs, members, job_ids, "
                    "fold_json, score, score_tier, model_fp) VALUES "
                    "(?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?)",
                    [
                        (
                            run_id, c["kind"], c["label"], int(c["tier"]),
                            c.get("dm"), c.get("snr"), c.get("period"),
                            c.get("folded_snr"), c.get("opt_period"),
                            c.get("known_source"), c.get("harmonic"),
                            int(c.get("n_obs", 1)),
                            int(c.get("members", 1)),
                            json.dumps(c.get("job_ids", [])),
                            json.dumps(c["fold"])
                            if c.get("fold") is not None else None,
                            c.get("score"),
                            int(c["score_tier"])
                            if c.get("score_tier") is not None else None,
                            c.get("model_fp"),
                        )
                        for c in catalogue
                    ],
                )
                self._conn.executemany(
                    "INSERT INTO sift_known_matches (run_id, "
                    "candidate_id, job_id, psr, psr_period, psr_dm, "
                    "harmonic, period_frac_err, dm_err) VALUES "
                    "(?,?,?,?,?,?,?,?,?)",
                    [
                        (
                            run_id, m.get("candidate_id"), m.get("job_id"),
                            m["psr"], m["psr_period"], m["psr_dm"],
                            m["harmonic"], m["period_frac_err"],
                            m["dm_err"],
                        )
                        for m in known_matches
                    ],
                )
                self._conn.executemany(
                    "INSERT INTO sift_sp_sources (run_id, dm, n_obs, "
                    "n_pulses, best_snr, period_s, period_frac_resid, "
                    "job_ids, toas_s) VALUES (?,?,?,?,?,?,?,?,?)",
                    [
                        (
                            run_id, s["dm"], int(s["n_obs"]),
                            int(s["n_pulses"]), s.get("best_snr"),
                            s.get("period_s"), s.get("period_frac_resid"),
                            json.dumps(s.get("job_ids", [])),
                            json.dumps(s.get("toas_s", [])),
                        )
                        for s in sp_sources
                    ],
                )

        DB_RETRY.call(_txn, site="db.ingest", context=f"sift:{run_id}")
        log.info(
            "sift run %s ingested: %d catalogue rows (%d known, %d "
            "rfi), %d single-pulse sources",
            run_id, tally["n_catalogue"], tally["n_known"],
            tally["n_rfi"], tally["n_sp_sources"],
        )
        return tally

    def latest_sift_run(self) -> dict | None:
        rows = self._query(
            "SELECT * FROM sift_runs ORDER BY created_unix DESC LIMIT 1"
        )
        return rows[0] if rows else None

    def sift_catalogue(
        self, label: str | None = None, limit: int | None = None
    ) -> list[dict]:
        q = "SELECT * FROM sift_candidates"
        args: list = []
        if label:
            q += " WHERE label = ?"
            args.append(label)
        q += " ORDER BY tier, snr DESC"
        if limit:
            q += " LIMIT ?"
            args.append(int(limit))
        return self._query(q, args)

    def update_sift_scores(self, scored: list[dict]) -> int:
        """Write a re-scoring pass back onto existing sift rows (the
        ``peasoup-rank score`` path; the sift service ingests scores
        inline). Rows need ``id``, ``score``, ``score_tier``,
        ``model_fp``."""

        def _txn():
            with self._conn:
                self._conn.executemany(
                    "UPDATE sift_candidates SET score = ?, "
                    "score_tier = ?, model_fp = ? WHERE id = ?",
                    [
                        (
                            s.get("score"), s.get("score_tier"),
                            s.get("model_fp"), s["id"],
                        )
                        for s in scored
                    ],
                )

        DB_RETRY.call(_txn, site="db.ingest", context="rank.score")
        return len(scored)

    def sift_known_matches(self) -> list[dict]:
        return self._query(
            "SELECT * FROM sift_known_matches ORDER BY psr, job_id"
        )

    def sift_sp_sources(self) -> list[dict]:
        return self._query(
            "SELECT * FROM sift_sp_sources ORDER BY n_pulses DESC, dm"
        )
