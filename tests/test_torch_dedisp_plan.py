"""The port's dedispersion planner (peasoup_tpu_torch.plan.dedisp_plan) and
shape buckets (peasoup_tpu_torch.campaign.buckets) against the JAX
package's: the same numpy in both, so every plan is held field for field
and every table bit for bit."""

import dataclasses

import numpy as np
import pytest

from peasoup_tpu.campaign.runner import bucket_for_header as jax_bucket_for_header
from peasoup_tpu.campaign.runner import bucket_for_input as jax_bucket_for_input
from peasoup_tpu.campaign.runner import bucket_nsamps as jax_bucket_nsamps
from peasoup_tpu.ops.dedisperse import subband_groups as jax_subband_groups
from peasoup_tpu.plan import dedisp_plan as jdp
from peasoup_tpu.plan.dm_plan import DMPlan as JaxDMPlan
from peasoup_tpu_torch.campaign.buckets import bucket_for_header, bucket_for_input, bucket_nsamps
from peasoup_tpu_torch.io.sigproc import Filterbank, SigprocHeader, write_filterbank
from peasoup_tpu_torch.ops.dedisperse import subband_groups
from peasoup_tpu_torch.plan import dedisp_plan as pdp
from peasoup_tpu_torch.plan.dm_plan import DMPlan

# (nchans, nbits, nsamps, tsamp, fch1, foff, dm_end, max_smear, max_snr_loss)
GRID = [
    # the big grid's bucket (chip_smoke.py): exact at 0.1, subband 16 at 0.3
    (64, 2, 3_145_728, 6.4e-05, 1500.0, -4.6875, 20.0, 1.0, 0.1),
    (64, 2, 3_145_728, 6.4e-05, 1500.0, -4.6875, 20.0, 1.0, 0.3),
    (16, 8, 1 << 15, 2.56e-4, 1400.0, -8.0, 40.0, 1.0, 0.1),
    (32, 1, 1 << 17, 1e-4, 1400.0, -10.0, 200.0, 2.0, 0.05),
    (128, 8, 1 << 16, 6.4e-5, 1500.0, -2.34375, 500.0, 1.0, 0.3),
    (256, 8, 1 << 16, 6.4e-5, 1500.0, -1.171875, 1000.0, 2.0, 0.1),
    (256, 2, 1 << 16, 6.4e-5, 1500.0, -1.171875, 40.0, 0.0, 0.3),
    (512, 1, 1 << 15, 6.4e-5, 1400.0, -0.5, 2000.0, 1.0, 0.05),
    (1024, 8, 1 << 15, 6.4e-5, 1500.0, -0.29296875, 300.0, 2.0, 0.3),
    (1024, 2, 1 << 15, 1.28e-4, 1500.0, -0.29296875, 2000.0, 0.0, 0.1),
]
IDS = [f"{g[0]}ch-{g[1]}bit-dm{g[6]:g}-smear{g[7]:g}-loss{g[8]:g}" for g in GRID]


def _plans(g):
    nchans, _nbits, nsamps, tsamp, fch1, foff, dm_end, *_ = g
    kw = dict(nsamps=nsamps, nchans=nchans, tsamp=tsamp, fch1=fch1, foff=foff,
              dm_start=0.0, dm_end=dm_end, pulse_width=64.0, tol=1.10)
    return JaxDMPlan.create(**kw), DMPlan.create(**kw)


@pytest.mark.parametrize("g", GRID, ids=IDS)
def test_select_matches_jax(g):
    nchans, nbits, _, tsamp, fch1, foff, _, max_smear, loss = g
    jplan, pplan = _plans(g)
    kw = dict(nbits=nbits, tsamp=tsamp, fch1=fch1, foff=foff, max_smear=max_smear,
              max_snr_loss=loss)
    want = jdp.DedispPlan.select(jplan, **kw).to_doc()
    got = pdp.DedispPlan.select(pplan, **kw).to_doc()
    assert got == want


def test_big_grid_bucket_plans():
    exact, subband = (pdp.DedispPlan.select(_plans(GRID[i])[1], nbits=2, tsamp=6.4e-05,
                                            fch1=1500.0, foff=-4.6875, max_snr_loss=loss)
                      for i, loss in ((0, 0.1), (1, 0.3)))
    assert exact.engine == "exact" and not exact.matmul_candidate
    assert exact.predicted_loss > 0.1
    assert (subband.engine, subband.subbands, subband.n_groups) == ("subband", 16, 11)
    assert subband.smear_dm_scaled and subband.smear_loss_budget == 0.3


@pytest.mark.parametrize("g", GRID[:6], ids=IDS[:6])
def test_tables_match_jax(g):
    nchans, _, _, tsamp, fch1, foff, _, max_smear, loss = g
    jplan, pplan = _plans(g)
    dt = pplan.delay_samples()
    np.testing.assert_array_equal(dt, jplan.delay_samples())
    bud = dict(tsamp=tsamp, fch1=fch1, foff=foff, nchans=nchans, pulse_width_us=64.0,
               max_snr_loss=loss, floor=max(max_smear, 1.0))
    b = pdp.dm_smear_budgets(pplan.dm_list, **bud)
    np.testing.assert_array_equal(b, jdp.dm_smear_budgets(jplan.dm_list, **bud))
    assert pdp.matmul_cost_profile(dt, pplan.out_nsamps) == jdp.matmul_cost_profile(
        dt, jplan.out_nsamps)
    assert pdp.candidate_subbands(nchans) == jdp.candidate_subbands(nchans)
    for nsub in pdp.candidate_subbands(nchans) or [4]:
        for budgets in (None, b):
            np.testing.assert_array_equal(
                pdp.effective_delay_table(dt, nsub, max_smear, budgets),
                jdp.effective_delay_table(dt, nsub, max_smear, budgets))


@pytest.mark.parametrize("g", GRID[:6], ids=IDS[:6])
def test_group_spans_match_both_packages_groupings(g):
    nchans, _, _, tsamp, fch1, foff, _, max_smear, loss = g
    _, pplan = _plans(g)
    dt = pplan.delay_samples()
    b = pdp.dm_smear_budgets(pplan.dm_list, tsamp=tsamp, fch1=fch1, foff=foff,
                             nchans=nchans, pulse_width_us=64.0, max_snr_loss=loss,
                             floor=max(max_smear, 1.0))
    for nsub in pdp.candidate_subbands(nchans) or [4]:
        nsub = pdp.effective_subbands(nchans, nsub)
        for budgets in (None, b):
            spans = [(lo, hi) for lo, hi, _ in
                     pdp.subband_group_spans(dt, nsub, max_smear, budgets)]
            assert spans == subband_groups(dt, nsub, max_smear, budgets)
            assert spans == [tuple(s) for s in
                             jax_subband_groups(dt, nsub, max_smear, budgets)]


def test_plan_documents_cross_load():
    _, pplan = _plans(GRID[1])
    kw = dict(nbits=2, tsamp=6.4e-05, fch1=1500.0, foff=-4.6875, max_snr_loss=0.3)
    jplan = _plans(GRID[1])[0]
    jdoc = dataclasses.replace(jdp.DedispPlan.select(jplan, **kw), source="tuned",
                               trials=[{"params": {"subbands": 16}, "median_s": 0.5}]).to_doc()
    pdoc = dataclasses.replace(pdp.DedispPlan.select(pplan, **kw), source="tuned",
                               trials=[{"params": {"subbands": 16}, "median_s": 0.5}]).to_doc()
    assert pdp.DedispPlan.from_doc(jdoc).to_doc() == pdoc
    assert jdp.DedispPlan.from_doc(pdoc).to_doc() == jdoc
    assert pdp.DedispPlan.from_doc(jdoc).summary() == jdp.DedispPlan.from_doc(pdoc).summary()


@pytest.mark.parametrize("n", [1, 5, 767, 768, 769, 1024, 1025, 187_520, (1 << 21) + 8192])
def test_bucket_nsamps_matches_jax(n):
    assert bucket_nsamps(n) == jax_bucket_nsamps(n)
    assert bucket_nsamps(n, [1000, 4096]) == jax_bucket_nsamps(n, [1000, 4096])


@pytest.mark.parametrize("nbits,nsamps", [(2, 187_520), (8, 1 << 15), (1, 40_000)])
def test_bucket_for_header_matches_jax(tmp_path, nbits, nsamps):
    hdr = SigprocHeader(source_name="B", tsamp=6.4e-5, tstart=55000.0, fch1=1500.0,
                        foff=-4.6875, nchans=64, nbits=nbits, nifs=1, data_type=1,
                        nsamples=nsamps)
    assert bucket_for_header(hdr) == jax_bucket_for_header(hdr)
    path = tmp_path / "b.fil"
    write_filterbank(path, Filterbank(header=hdr, data=np.zeros((nsamps, 64), np.uint8)))
    assert bucket_for_input(str(path)) == jax_bucket_for_input(str(path)) == \
        bucket_for_header(hdr)
    (tmp_path / "junk.fil").write_bytes(b"not a filterbank")
    assert bucket_for_input(str(tmp_path / "junk.fil")) is None
    assert jax_bucket_for_input(str(tmp_path / "junk.fil")) is None
