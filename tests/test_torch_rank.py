"""The port's candidate ranking (peasoup_tpu_torch.ops.candidate_features
and rank/) against the JAX package's, on the CPU, from the same
numpy-seeded injected fold products (tests/test_rank.py's recipe).

Tolerances (measured: features 8.4e-7 relative at most, scores 2e-8,
trained weights 5e-7):
- features: the discrete ones (prof_sharpness, subint_persistence,
  dm_argmax_frac) and dm_contrast exactly; the continuous ones to 1e-5
  relative, plus 1e-6 of the column's largest magnitude, as the sums run in
  another order than XLA's;
- scores over the same features: 1e-6 absolute, the same tiers and the
  same order wherever the JAX scores differ by more than twice that;
- training from one seed: weights within 1e-5 absolute of the JAX
  package's (many momentum steps in f32 carry the rounding on), the same
  training AUC, and the ROC gate (AUC >= 0.95) held on the port's own
  features.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peasoup_tpu.ops import candidate_features as jcf
from peasoup_tpu.rank import model as jmodel
from peasoup_tpu.rank import score as jscore
from peasoup_tpu.rank import train as jtrain
from peasoup_tpu_torch.ops import candidate_features as tcf
from peasoup_tpu_torch.rank import model as tmodel
from peasoup_tpu_torch.rank import score as tscore
from peasoup_tpu_torch.rank import train as ttrain

FEAT_RTOL, FEAT_ATOL_FRAC = 1e-5, 1e-6
SCORE_ATOL = 1e-6
WEIGHT_ATOL = 1e-5
EXACT = ("prof_sharpness", "subint_persistence", "dm_contrast", "dm_argmax_frac")


def _products(n=13, seed=3):
    prof, subints, dm_curve, _, _ = jtrain.synth_fold_products(n, seed)
    return prof, subints, dm_curve


def _jax_features(prof, subints, dmc):
    return np.asarray(jcf.candidate_features_batch(
        jnp.asarray(prof), jnp.asarray(subints), jnp.asarray(dmc),
        nbins=prof.shape[-1], nints=subints.shape[-2]))


def _assert_features_close(got, want):
    assert got.shape == want.shape and got.dtype == np.float32
    for j, name in enumerate(tcf.FEATURE_NAMES):
        if name in EXACT:
            np.testing.assert_array_equal(got[:, j], want[:, j], err_msg=name)
        else:
            np.testing.assert_allclose(
                got[:, j], want[:, j], rtol=FEAT_RTOL,
                atol=FEAT_ATOL_FRAC * np.abs(want[:, j]).max(), err_msg=name)


def test_constants_and_synthetic_set_are_the_jax_packages():
    assert tcf.FEATURE_NAMES == jcf.FEATURE_NAMES
    assert tcf.DM_CURVE_FRACTIONS == jcf.DM_CURVE_FRACTIONS
    for seed in (3, 42, 20260806):
        for a, b in zip(ttrain.synth_fold_products(50, seed),
                        jtrain.synth_fold_products(50, seed)):
            assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("n,seed", [(13, 3), (600, 20260806)])
def test_features_match_jax(n, seed):
    prof, subints, dmc = _products(n, seed)
    got = tcf.candidate_features_batch(
        torch.from_numpy(prof), torch.from_numpy(subints), torch.from_numpy(dmc)).numpy()
    _assert_features_close(got, _jax_features(prof, subints, dmc))


def test_feature_rules_population_std_median_first_argmax():
    """The JAX package's definitions where torch's defaults differ: ddof 0,
    the sorted middle of an even count, and the first of tied maxima."""
    x = torch.tensor([[3.0, 1.0, 4.0, 1.5]])
    assert tcf._median_last(x).item() == 2.25
    assert torch.equal(tcf._std(x, 1), torch.std(x, dim=1, correction=0))
    prof, subints, dmc = _products(4, 9)
    dmc[:, :] = [0.0, 5.0, 5.0, 1.0, 5.0]  # ties: the first maximum wins
    got = tscore.extract_features(prof, subints, dmc, device="cpu")
    want = _jax_features(prof, subints, dmc)
    j = tcf.FEATURE_NAMES.index("dm_argmax_frac")
    assert np.all(got[:, j] == 0.25) and np.array_equal(got[:, j], want[:, j])


def test_batch_width_and_halving_give_the_same_bits(monkeypatch):
    prof, subints, dmc = _products()
    want = tscore.extract_features(prof, subints, dmc, batch=64, device="cpu")
    for batch in (1, 5, 13):
        got = tscore.extract_features(prof, subints, dmc, batch=batch, device="cpu")
        assert np.array_equal(got, want), batch
    calls = []

    def oom_once(*args):
        calls.append(args[0].shape[0])
        if len(calls) == 1:
            raise torch.OutOfMemoryError("CUDA out of memory (injected)")
        return tcf.candidate_features_batch(*args)

    monkeypatch.setattr(tscore, "candidate_features_batch", oom_once)
    got = tscore.extract_features(prof, subints, dmc, batch=8, device="cpu")
    assert calls[:2] == [8, 4] and np.array_equal(got, want)


def test_halving_raises_at_batch_one(monkeypatch):
    prof, subints, dmc = _products(n=3)

    def oom(*args):
        raise torch.OutOfMemoryError("CUDA out of memory (injected)")

    monkeypatch.setattr(tscore, "candidate_features_batch", oom)
    with pytest.raises(torch.OutOfMemoryError):
        tscore.extract_features(prof, subints, dmc, batch=2, device="cpu")
    assert tscore.extract_features(
        np.empty((0, 64), np.float32), np.empty((0, 16, 64), np.float32),
        tscore.neutral_dm_curve(0), device="cpu").shape == (0, tcf.NFEATURES)


def test_shipped_artifact_and_fingerprint_are_the_jax_packages():
    with open(tmodel.DEFAULT_MODEL_PATH, "rb") as a, open(jmodel.DEFAULT_MODEL_PATH, "rb") as b:
        assert a.read() == b.read()
    with open(tmodel._SCHEMA_PATH, "rb") as a, open(jmodel._SCHEMA_PATH, "rb") as b:
        assert a.read() == b.read()
    t, j = tmodel.RankModel.from_file(), jmodel.RankModel.from_file()
    assert t.fingerprint == j.fingerprint == tmodel.model_fingerprint(t.doc)
    assert (tmodel.SCORE_TIER1, tmodel.SCORE_TIER2) == (jmodel.SCORE_TIER1, jmodel.SCORE_TIER2)
    for p in (0.99, 0.85, 0.6, 0.5, 0.1):
        assert tmodel.score_tier(p) == jmodel.score_tier(p)


@pytest.mark.parametrize("edit,match", [
    ("weights", "fingerprint mismatch"), ("calibration", "not monotone"),
    ("features", "different"),
])
def test_bad_artifacts_rejected(edit, match):
    with open(tmodel.DEFAULT_MODEL_PATH) as f:
        doc = json.load(f)
    if edit == "weights":
        doc["w2"][0] = float(doc["w2"][0]) + 0.5
    elif edit == "calibration":
        doc["calibration"] = {"x": [0.0, 0.5, 1.0], "y": [0.0, 0.8, 0.4]}
        doc["fingerprint"] = tmodel.model_fingerprint(doc)
    else:
        doc["feature_names"][0] = "bogus_feature"
        doc["fingerprint"] = tmodel.model_fingerprint(doc)
    for mod in (tmodel, jmodel):
        with pytest.raises(ValueError, match=match):
            mod.RankModel(doc)


def test_scores_match_jax():
    prof, subints, dmc, _, _ = jtrain.synth_fold_products(240, 20260806)
    tm, jm = tmodel.RankModel.from_file(), jmodel.RankModel.from_file()
    tfeats, tsc = tscore.score_fold_products(tm, prof, subints, dmc, batch=64, device="cpu")
    jfeats, jsc = jscore.score_fold_products(jm, prof, subints, dmc, batch=64)
    _assert_features_close(tfeats, jfeats)
    np.testing.assert_allclose(tsc, jsc, rtol=0, atol=SCORE_ATOL)
    assert [tmodel.score_tier(p) for p in tsc] == [jmodel.score_tier(p) for p in jsc]
    # the same order wherever the JAX scores are told apart
    gap = jsc[:, None] - jsc[None, :] > 2 * SCORE_ATOL
    assert np.all((tsc[:, None] - tsc[None, :] > 0)[gap])
    # without a DM curve: the neutral one in both
    _, tn = tscore.score_fold_products(tm, prof[:20], subints[:20], device="cpu")
    _, jn = jscore.score_fold_products(jm, prof[:20], subints[:20])
    np.testing.assert_allclose(tn, jn, rtol=0, atol=SCORE_ATOL)


def test_metrics_and_calibration_exact():
    rng = np.random.default_rng(0)
    raw = rng.uniform(0.0, 1.0, 200)
    labels = (rng.uniform(0.0, 1.0, 200) < raw).astype(np.float64)
    assert ttrain.isotonic_calibration(raw, labels) == jtrain.isotonic_calibration(raw, labels)
    for scores in (raw, np.round(raw, 1)):
        assert ttrain.roc_auc(labels, scores) == jtrain.roc_auc(labels, scores)


def _assert_weights_close(got, want):
    for k in ("w1", "b1", "w2", "b2", "norm_mean", "norm_scale"):
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), rtol=0,
                                   atol=WEIGHT_ATOL, err_msg=k)
    assert got["train"]["auc"] == pytest.approx(want["train"]["auc"], abs=1e-3)
    for k in ("schema", "version", "seed", "nfeatures", "feature_names", "hidden"):
        assert got[k] == want[k]


def test_training_matches_jax_and_is_deterministic():
    kw = dict(seed=7, n_examples=120, steps=30, hidden=8)
    a = ttrain.train_model(**kw, device="cpu")
    assert a == ttrain.train_model(**kw, device="cpu")
    assert a["fingerprint"] == tmodel.model_fingerprint(a)
    _assert_weights_close(a, jtrain.train_model(**kw))


def test_default_training_and_the_roc_gate():
    """The default recipe (1200 examples, 400 steps) from seed 42 in both
    packages, and the held-out ROC gate on the port's own features, for
    the shipped artifact and the port's freshly trained one."""
    doc = ttrain.train_model(device="cpu")
    _assert_weights_close(doc, jtrain.train_model())
    for model in (tmodel.RankModel.from_file(), tmodel.RankModel(doc)):
        ev = ttrain.evaluate_model(model, n_examples=240, device="cpu")
        assert ev["auc"] >= 0.95
        assert ev["pulsar_tier1_frac"] > ev["foil_tier1_frac"]
        assert ev["median_pulsar_score"] > ev["median_foil_score"]
    want = jtrain.evaluate_model(jmodel.RankModel.from_file(), n_examples=240)
    got = ttrain.evaluate_model(tmodel.RankModel.from_file(), n_examples=240, device="cpu")
    for k in ("n_examples", "n_pulsar", "n_foil", "seed", "fingerprint",
              "pulsar_tier1_frac", "foil_tier1_frac"):
        assert got[k] == want[k], k
    assert got["auc"] == pytest.approx(want["auc"], abs=1e-6)


def test_rank_cli(tmp_path, capsys):
    from peasoup_tpu_torch.cli.rank import main

    out = str(tmp_path / "m.json")
    assert main(["train", "-o", out, "--seed", "3", "--examples", "120", "--steps", "30",
                 "--hidden", "8", "--device", "cpu"]) == 0
    model = tmodel.RankModel.from_file(out)
    assert model.doc["seed"] == 3
    assert jmodel.RankModel.from_file(out).fingerprint == model.fingerprint
    ev = str(tmp_path / "eval.json")
    assert main(["eval", "--examples", "160", "--json", ev, "--device", "cpu"]) == 0
    with open(ev) as f:
        assert json.load(f)["auc"] >= 0.95
    assert main(["evaluate", "--examples", "160", "--min-auc", "1.01",
                 "--device", "cpu"]) == 2
    assert "BELOW --min-auc" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="A.10"):
        main(["eval", "--device", "cpu", "--metrics-json", "m.json"])
