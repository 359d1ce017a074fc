"""The port's tuner and tuning cache (peasoup_tpu_torch.perf.tuning) on the
CPU, and its `tune` subcommand, against the JAX package's: the analytic
plans field for field, the cache file readable by both packages, and
the port's own rules (a warm bucket makes no measurement; a failed
measurement raises)."""

import json
import logging
import os
import time

import pytest

from peasoup_tpu.perf import tuning as jax_tuning
from peasoup_tpu_torch.io.sigproc import read_filterbank
from peasoup_tpu_torch.perf import tuning
from peasoup_tpu_torch.pipeline.search import PeasoupSearch, SearchConfig
from peasoup_tpu_torch.tools.perf import main as perf_main
from test_pipeline import make_synthetic_fil

# a small bucket the CPU tunes in about a second: 16 channels of 8-bit
# samples, 2^15 samples at 256 us
SMALL = (16, 8, 1 << 15, 0.000256, 1400.0, -8.0)
OVERRIDES = dict(dm_end=40.0)


def _resolve(path, **kw):
    return tuning.resolve_plan_for_bucket(SMALL, "search", OVERRIDES, str(path),
                                          device="cpu", **kw)


def test_cold_then_warm(tmp_path):
    cache = tmp_path / "tuning.json"
    n0 = tuning.measurement_count()
    cold = _resolve(cache)
    measured = tuning.measurement_count() - n0
    # dedisp_block (8, 16 and the probe's 30 trials), dm_block (3),
    # accel_bucket (3), the race (1)
    assert measured == 10
    assert cold.source == "tuned" and len(cold.trials) == measured
    assert {k for t in cold.trials for k in t["params"]} == {
        "dedisp_block", "dm_block", "accel_bucket", "engine"}
    assert cold.tuning_s > 0 and cold.pallas_block == 0
    n1 = tuning.measurement_count()
    warm = _resolve(cache)
    assert tuning.measurement_count() == n1
    assert warm.source == "cache"
    assert {**warm.to_doc(), "source": "tuned"} == cold.to_doc()
    forced = _resolve(cache, force=True)
    assert forced.source == "tuned" and tuning.measurement_count() > n1


def test_spsearch_tunes_the_block_knobs_only(tmp_path):
    plan = tuning.resolve_plan_for_bucket(SMALL, "spsearch", OVERRIDES,
                                          str(tmp_path / "t.json"), device="cpu")
    assert {k for t in plan.trials for k in t["params"]} == {"dedisp_block", "dm_block"}
    assert plan.engine == "exact" and plan.accel_bucket == 0


def test_corrupt_cache_retunes_with_a_warning(tmp_path, caplog):
    cache = tmp_path / "tuning.json"
    cache.write_text("{not json")
    n0 = tuning.measurement_count()
    with caplog.at_level(logging.WARNING, logger="peasoup_tpu_torch.tuning"):
        plan = _resolve(cache)
    assert plan.source == "tuned" and tuning.measurement_count() > n0
    assert "unreadable tuning cache" in caplog.text
    assert (tmp_path / "tuning.json.corrupt").read_text() == "{not json"
    # a document of another schema is moved aside alike
    cache.write_text(json.dumps({"schema": "something else", "devices": {}}))
    assert tuning.load_cache(str(cache)) == tuning._empty_cache()
    assert not cache.exists()


def test_unwritable_cache_warns(tmp_path, caplog):
    blocker = tmp_path / "file"
    blocker.write_text("")
    with caplog.at_level(logging.WARNING, logger="peasoup_tpu_torch.tuning"):
        plan = tuning.resolve_plan_for_bucket(SMALL, "search", OVERRIDES,
                                              str(blocker / "tuning.json"), device="cpu",
                                              tune=False)
    assert plan.source == "analytic"
    assert "could not persist tuning cache" in caplog.text


def test_cache_validates_under_both_packages(tmp_path):
    cache = tmp_path / "tuning.json"
    _resolve(cache)
    doc = json.loads(cache.read_text())
    tuning.validate_cache(doc)
    jax_tuning.validate_cache(doc)
    assert doc["schema"] == jax_tuning.TUNING_SCHEMA
    assert doc["version"] == jax_tuning.TUNING_VERSION
    # the JAX package writes into the same file; each reads its own entry
    jax_tuning.resolve_plan_for_bucket(SMALL, "search", OVERRIDES, str(cache), tune=False)
    doc = json.loads(cache.read_text())
    tuning.validate_cache(doc)
    jax_tuning.validate_cache(doc)
    assert set(doc["devices"]) == {tuning.device_fingerprint("cpu"),
                                   jax_tuning.device_fingerprint()}
    assert _resolve(cache).source == "cache"


def test_fingerprints_never_collide():
    fp = tuning.device_fingerprint("cpu")
    assert fp == "torch-cpu:cpu:n1"
    assert fp != jax_tuning.device_fingerprint()
    assert not jax_tuning.device_fingerprint().startswith("torch-")


@pytest.mark.parametrize("pipeline,overrides", [
    ("search", dict(dm_end=40.0)),
    ("search", dict(dm_end=20.0, subband_snr_loss=0.3)),
    ("search", dict(dm_end=40.0, subbands=8)),
    ("spsearch", dict(dm_end=60.0)),
])
@pytest.mark.parametrize("bucket", [SMALL, (64, 2, 3_145_728, 6.4e-05, 1500.0, -4.6875)],
                         ids=["small", "big-grid"])
def test_untuned_resolve_matches_jax(tmp_path, pipeline, overrides, bucket):
    got = tuning.resolve_plan_for_bucket(bucket, pipeline, overrides,
                                         str(tmp_path / "p.json"), tune=False, device="cpu")
    want = jax_tuning.resolve_plan_for_bucket(bucket, pipeline, overrides,
                                              str(tmp_path / "j.json"), tune=False)
    assert got.to_doc() == want.to_doc()
    stored = [next(iter(next(iter(json.loads((tmp_path / f).read_text())["devices"]
                                  .values())).values()))
              for f in ("p.json", "j.json")]
    for entry in stored:
        entry.pop("stored_unix")
    assert stored[0] == stored[1]


def test_list_and_prune(tmp_path):
    cache = tmp_path / "tuning.json"
    _resolve(cache, tune=False)
    doc = json.loads(cache.read_text())
    old = dict(next(iter(doc["devices"][tuning.device_fingerprint("cpu")].values())),
               stored_unix=time.time() - 10 * 86400)
    tuning.cache_store(doc, "gpu:NVIDIA H100 80GB HBM3:n1", "search|x", old)
    doc["devices"]["gpu:NVIDIA H100 80GB HBM3:n1"]["search|x"]["stored_unix"] = (
        time.time() - 10 * 86400)
    tuning.save_cache(str(cache), doc)
    rows = tuning.list_entries(str(cache), device="cpu")
    assert [r["stale"] for r in rows] == [True, False]
    assert rows[0]["age_s"] > 9 * 86400 and rows[1]["age_s"] < 3600
    gone = tuning.prune_cache(str(cache), dry_run=True, device="cpu")
    assert [r["fingerprint"] for r in gone] == ["gpu:NVIDIA H100 80GB HBM3:n1"]
    assert len(tuning.list_entries(str(cache), device="cpu")) == 2
    assert tuning.prune_cache(str(cache), keep_stale=True, older_than_s=86400.0,
                              device="cpu")[0]["stale"]
    assert len(tuning.list_entries(str(cache), device="cpu")) == 1
    assert tuning.prune_cache(str(cache), device="cpu") == []


def test_a_failed_measurement_raises(tmp_path, monkeypatch):
    # the port's rule: no fallback to the analytic knobs where the JAX
    # package would keep them; the run fails, and nothing is cached
    def broken(*args, **kwargs):
        raise RuntimeError("dedisperse kernel launch failed: CUDA error 700")

    monkeypatch.setattr("peasoup_tpu_torch.ops.dedisperse.dedisperse", broken)
    cache = tmp_path / "tuning.json"
    with pytest.raises(RuntimeError, match="launch failed"):
        _resolve(cache)
    assert not cache.exists()
    path, _, _ = make_synthetic_fil(tmp_path)
    cfg = SearchConfig(dm_end=40.0, tune=True, tuning_cache=str(cache))
    with pytest.raises(RuntimeError, match="launch failed"):
        PeasoupSearch(cfg, device="cpu").run(read_filterbank(path))


def test_a_failed_timer_raises(tmp_path, monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("the clock failed")

    monkeypatch.setattr(tuning, "timed_samples", broken)
    with pytest.raises(RuntimeError, match="the clock failed"):
        _resolve(tmp_path / "tuning.json")


def test_tune_subcommand(tmp_path, capsys):
    cache = str(tmp_path / "tuning.json")
    bucket = ",".join(str(x) for x in SMALL)
    argv = ["tune", "--device", "cpu", "--cache", cache, "--bucket", bucket,
            "--config", json.dumps(OVERRIDES)]
    assert perf_main(argv) == 0
    assert "(10 measurements)" in capsys.readouterr().out
    assert perf_main(argv) == 0
    assert "(0 measurements, served from cache)" in capsys.readouterr().out
    assert perf_main(["tune", "--device", "cpu", "--cache", cache, "--list"]) == 0
    assert "torch-cpu:cpu:n1" in capsys.readouterr().out
    assert perf_main(["tune", "--device", "cpu", "--cache", cache, "--prune",
                      "--dry-run"]) == 0
    assert "would remove 0 entries" in capsys.readouterr().out
    # bad arguments and internal errors exit 2
    assert perf_main(["tune", "--device", "cpu", "--cache", cache]) == 2
    assert perf_main(["tune", "--device", "cpu", "--cache", cache, "--bucket", "1,2"]) == 2
    assert perf_main(["tune", "--device", "cpu", "--cache", cache, "--bucket",
                      "x,8,1,1,1,1"]) == 2
    assert os.path.exists(cache)


def test_tune_subcommand_defaults_to_the_card(monkeypatch, tmp_path):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert perf_main(["tune", "--cache", str(tmp_path / "t.json"), "--bucket",
                      ",".join(str(x) for x in SMALL)]) == 2
    with pytest.raises(RuntimeError, match="is_available"):
        tuning.device_fingerprint()
