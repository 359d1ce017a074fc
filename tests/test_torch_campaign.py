"""The port's candidate database (peasoup_tpu_torch.campaign.db), its
overview.xml parser (tools.parsers.OverviewFile) and its retry policy
(resilience.policy) against the JAX package's, on the CPU.

Equality class: exact. Both packages read and write one file format, so a
database either package wrote reads the same rows in the other (the
ingest time, a wall-clock stamp, aside), the migration of a legacy v1 file
gives the same schema, and a newer schema is refused by both.
"""

import sqlite3
import types

import numpy as np
import pytest

from peasoup_tpu.campaign import db as jdb
from peasoup_tpu.core.candidates import Candidate as JCandidate
from peasoup_tpu.core.candidates import SinglePulseCandidate as JSPCandidate
from peasoup_tpu.io.output import OutputFileWriter as JWriter
from peasoup_tpu.io.sigproc import SigprocHeader as JHeader
from peasoup_tpu.resilience import policy as jpolicy
from peasoup_tpu.tools import parsers as jparsers
from peasoup_tpu_torch.campaign import db as tdb
from peasoup_tpu_torch.core.candidates import Candidate as TCandidate
from peasoup_tpu_torch.core.candidates import SinglePulseCandidate as TSPCandidate
from peasoup_tpu_torch.io.output import OutputFileWriter as TWriter
from peasoup_tpu_torch.io.sigproc import SigprocHeader as THeader
from peasoup_tpu_torch.resilience import policy as tpolicy
from peasoup_tpu_torch.tools import parsers as tparsers

P0 = 0.714519699726  # J0332+5434


def _legacy_v1(path: str) -> None:
    conn = sqlite3.connect(path)
    conn.executescript(jdb._SCHEMA_V1)
    conn.execute(
        "INSERT INTO observations (job_id, input, source_name, tstart, tsamp, "
        "nchans, nsamps, ingested_unix) VALUES "
        "('j1', 'a.fil', 'SRC', 55000.0, 2.56e-4, 8, 4096, 0)"
    )
    conn.execute(
        "INSERT INTO candidates (job_id, kind, dm, snr, period) "
        "VALUES ('j1', 'periodicity', 26.7, 9.0, 0.714)"
    )
    conn.commit()
    conn.close()


def _schema(path: str) -> list:
    conn = sqlite3.connect(path)
    try:
        rows = conn.execute(
            "SELECT type, name, tbl_name FROM sqlite_master ORDER BY name"
        ).fetchall()
        cols = {
            t: [tuple(r) for r in conn.execute(f"PRAGMA table_info({t})")]
            for _, t, _ in rows if _ == "table"
        }
        version = conn.execute("PRAGMA user_version").fetchone()[0]
    finally:
        conn.close()
    return [rows, cols, version]


def test_constants_are_the_jax_packages():
    assert tdb.SCHEMA_VERSION == jdb.SCHEMA_VERSION
    assert tdb.DB_FILENAME == jdb.DB_FILENAME
    assert tdb._SCHEMA_V1 == jdb._SCHEMA_V1
    assert tdb._SCHEMA_SIFT == jdb._SCHEMA_SIFT
    assert sorted(tdb.MIGRATIONS) == sorted(jdb.MIGRATIONS)
    assert tparsers.CAND_FIELDS == jparsers.CAND_FIELDS
    assert tparsers.SP_CAND_FIELDS == jparsers.SP_CAND_FIELDS


@pytest.mark.parametrize("maker", ["fresh", "legacy"])
def test_schema_is_the_jax_packages(tmp_path, maker):
    """A fresh file and a migrated legacy v1 file end in the same schema,
    column for column and at the same user_version, in both packages."""
    got = {}
    for name, mod in (("jax", jdb), ("torch", tdb)):
        path = str(tmp_path / f"{name}.sqlite")
        if maker == "legacy":
            _legacy_v1(path)
        with mod.CandidateDB(path) as db:
            assert db.schema_version() == mod.SCHEMA_VERSION
        got[name] = _schema(path)
    assert got["torch"] == got["jax"]


def test_legacy_v1_migrated_by_the_port_reads_in_both(tmp_path):
    path = str(tmp_path / "c.sqlite")
    _legacy_v1(path)
    with tdb.CandidateDB(path) as db:
        obs, cands = db.observations(), db.all_candidates("periodicity")
    assert len(obs) == 1 and obs[0]["beam"] is None
    assert len(cands) == 1 and cands[0]["dm"] == 26.7
    with jdb.CandidateDB(path) as db:
        assert db.observations() == obs
        assert db.all_candidates("periodicity") == cands


@pytest.mark.parametrize("opener", ["jax", "torch"])
def test_future_version_refused(tmp_path, opener):
    path = str(tmp_path / "c.sqlite")
    _legacy_v1(path)
    conn = sqlite3.connect(path)
    conn.execute(f"PRAGMA user_version = {tdb.SCHEMA_VERSION + 7}")
    conn.commit()
    conn.close()
    mod = {"jax": jdb, "torch": tdb}[opener]
    with pytest.raises(mod.SchemaVersionError, match="newer"):
        mod.CandidateDB(path)


def _write_overview(pkg: str, path, *, nbeam: int) -> None:
    """An overview.xml written by one package's OutputFileWriter: a header,
    three periodicity candidates and a single-pulse section."""
    writer_cls, header_cls, cand_cls, sp_cls = {
        "jax": (JWriter, JHeader, JCandidate, JSPCandidate),
        "torch": (TWriter, THeader, TCandidate, TSPCandidate),
    }[pkg]
    hdr = header_cls(
        source_name="OBS", rawdatafile="obs.fil", tsamp=6.4e-5, tstart=55000.5,
        fch1=1500.0, foff=-4.6875, nchans=64, nbits=2, nifs=1, data_type=1,
        ibeam=nbeam, src_raj=123000.0, src_dej=-453000.0, nsamples=1 << 15,
    )
    w = writer_cls()
    w.add_header(hdr)
    w.add_dm_list([0.0, 10.0, 20.0])
    cands = [
        cand_cls(dm=10.0, dm_idx=1, acc=0.25, nh=2, snr=17.5, freq=1.0 / P0,
                 folded_snr=12.25, opt_period=P0 * (1 + 1e-6)),
        cand_cls(dm=20.0, dm_idx=2, acc=-1.5, nh=1, snr=9.0, freq=1.0 / 0.0314),
        cand_cls(dm=0.0, dm_idx=0, acc=0.0, nh=4, snr=7.25, freq=50.0),
    ]
    cands[0].append(cand_cls(dm=10.0, dm_idx=1, acc=0.5, nh=1, snr=11.0, freq=2.0 / P0))
    w.add_candidates(cands, {0: 0, 1: 96, 2: 160})
    sp_cfg = types.SimpleNamespace(
        outdir="out", killfilename="", dm_start=0.0, dm_end=20.0, dm_tol=1.1,
        dm_pulse_width=64.0, min_snr=7.0, n_widths=4, max_events=256, decimate=8,
        time_link=1.0, dm_link=2,
    )
    sps = [
        sp_cls(dm=10.0, dm_idx=1, snr=9.5, time_s=0.256, sample=4000, width=4,
               width_idx=2, members=5, dm_idx_lo=0, dm_idx_hi=2, sample_lo=3990,
               sample_hi=4010, width_lo=2, width_hi=8),
        sp_cls(dm=20.0, dm_idx=2, snr=7.5, time_s=1.28, sample=20000, width=1),
    ]
    w.add_single_pulse_section(sp_cfg, "obs.fil", [1, 2, 4, 8], sps)
    w.add_timing_info({"total": 1.5, "searching": 1.0})
    w.to_file(str(path))


def _rows(db, job):
    obs = [dict(o, ingested_unix=None) for o in db.observations()]
    return obs, db.candidates_for(job)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_overview_and_ingest_equal(tmp_path, writer):
    """Each package's overview.xml parses to the same arrays in both
    parsers, and ingest_job stores the same rows in both databases."""
    job_dir = tmp_path / "job"
    job_dir.mkdir()
    _write_overview(writer, job_dir / "overview.xml", nbeam=3)
    path = str(job_dir / "overview.xml")
    a, b = jparsers.OverviewFile(path), tparsers.OverviewFile(path)
    for name in ("header", "search_parameters", "execution_times", "sp_parameters"):
        assert getattr(b, name) == getattr(a, name), name
    for name in ("dm_list", "acc_list", "sp_widths", "candidates", "sp_candidates"):
        np.testing.assert_array_equal(getattr(b, name), getattr(a, name))
    assert len(b.candidates) == 3 and len(b.sp_candidates) == 2
    assert b.candidates["nassoc"][0] == 1

    got = {}
    for name, mod in (("jax", jdb), ("torch", tdb)):
        with mod.CandidateDB(str(tmp_path / f"{name}.sqlite")) as db:
            counts = db.ingest_job("job-1", str(job_dir), "/data/obs.fil", tenant="alice")
            assert counts == {"periodicity": 3, "single_pulse": 2}
            got[name] = _rows(db, "job-1")
    assert got["torch"] == got["jax"]
    assert got["torch"][0][0]["beam"] == 3 and got["torch"][0][0]["tenant"] == "alice"


def _sift_product():
    cat = [
        {"kind": "periodicity", "label": "known", "tier": 1, "dm": 26.76,
         "snr": 12.0, "period": P0, "folded_snr": 14.5, "opt_period": P0,
         "known_source": "J0332+5434", "harmonic": "1/1", "n_obs": 2,
         "members": 2, "job_ids": ["j0", "j1"],
         "fold": {"prof": [1.0, 2.0], "subints": [[1.0, 2.0]]},
         "score": 0.91, "score_tier": 1, "model_fp": "sha256:0123456789abcdef"},
        {"kind": "periodicity", "label": "rfi", "tier": 3, "dm": 5.0,
         "snr": 9.5, "period": 0.02, "job_ids": ["j0"]},
    ]
    known = [{"candidate_id": 1, "job_id": "j0", "psr": "J0332+5434",
              "psr_period": P0, "psr_dm": 26.76, "harmonic": "1/1",
              "period_frac_err": 1e-5, "dm_err": 0.04}]
    sp = [{"dm": 40.0, "n_obs": 2, "n_pulses": 6, "best_snr": 8.0,
           "period_s": 0.5, "period_frac_resid": 0.001,
           "job_ids": ["j0", "j1"], "toas_s": [0.55, 1.55]}]
    return {"n_folded": 3, "fold": True}, cat, known, sp


def _sift_tables(db):
    run = dict(db.latest_sift_run(), created_unix=None)
    return [run, db.sift_catalogue(), db.sift_known_matches(), db.sift_sp_sources(),
            db.max_observation_rowid()]


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_sift_product_round_trips(tmp_path, writer, reader):
    """ingest_sift_run and update_sift_scores from one package, read back
    by the other: the same tables."""
    mods = {"jax": jdb, "torch": tdb}
    path = str(tmp_path / "c.sqlite")
    with mods[writer].CandidateDB(path) as db:
        db.ingest_sift_run("run1", *_sift_product())
        rows = db.sift_catalogue()
        db.update_sift_scores([{"id": rows[-1]["id"], "score": 0.2, "score_tier": 3,
                                "model_fp": "sha256:fedcba9876543210"}])
        want = _sift_tables(db)
    with mods[reader].CandidateDB(path) as db:
        assert _sift_tables(db) == want
    assert want[0]["n_catalogue"] == 2 and want[0]["n_known"] == 1
    assert want[1][-1]["score_tier"] == 3


def test_db_retry_is_the_jax_packages():
    assert jpolicy.DB_RETRY.deadline_s is None
    for name in ("max_attempts", "base_delay_s", "max_delay_s", "jitter"):
        assert getattr(tpolicy.DB_RETRY, name) == getattr(jpolicy.DB_RETRY, name), name
    assert tpolicy.DB_RETRY.max_attempts >= 5
    for attempt in range(1, 6):
        assert tpolicy.DB_RETRY.delay(attempt, "db.ingest") == jpolicy.DB_RETRY.delay(
            attempt, "db.ingest")


def test_retry_policy_retries_contention_only():
    policy = tpolicy.RetryPolicy(max_attempts=3, base_delay_s=0.0, jitter=0.0)
    calls = []

    def fail(exc, times):
        def fn():
            calls.append(1)
            if len(calls) <= times:
                raise exc
            return "done"
        return fn

    assert policy.call(fail(sqlite3.OperationalError("database is locked"), 2),
                       site="t") == "done"
    assert len(calls) == 3
    calls.clear()
    with pytest.raises(sqlite3.OperationalError, match="locked"):
        policy.call(fail(sqlite3.OperationalError("database is locked"), 99), site="t")
    assert len(calls) == 3  # the budget, then the last error
    calls.clear()
    with pytest.raises(ValueError):
        policy.call(fail(ValueError("bad input"), 99), site="t")
    assert len(calls) == 1  # not retryable
