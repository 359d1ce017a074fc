"""The comparison fails what it should: a run with the timed path broken
underneath (the look for a card skipped, the rest of a run driven at the
tiny cell's size) comes out not correct, once for each fault the cells
can have, and the control (the reference in bfloat16 in the program's
place) comes out not correct through the same numbers and ``decide``."""

import copy
import time

import pytest
import torch

from portbench.faults import planted
from portbench.gen import make_observation
from portbench.reference.check import answers_of, decide
from portbench.run import judge_run, run_cell, search_config

CPU = torch.device("cpu")
SEED = 2**31 + 1234


def _run(cell):
    return run_cell(cell, SEED, 0.2, False, CPU, time.perf_counter())


def test_a_sound_run_is_correct(tiny_cell):
    res = _run(tiny_cell)
    assert res["correct"], res["checks"]


def test_half_of_each_row_batch_left_out(tiny_cell):
    """The rows past the middle of each batch find nothing, as if they
    were never searched."""
    with planted("half_batch"):
        res = _run(tiny_cell)
    assert not res["correct"]
    assert res["checks"]["pulsar_gap"]["value"] > res["checks"]["pulsar_gap"]["limit"]


def test_the_dropped_half_holding_the_strongest_pulsar_alone(tiny_cell):
    """The weaker pulsar in the kept half of each batch (DM 8 of 0-40), the
    stronger in the dropped half: the list's top is the weaker one, whose
    box holds only rows that were searched, so the box round the top reads
    nothing amiss; the box round each injected pulsar does."""
    tiny_cell.traffic["pulsars"][0]["dm"] = 8.0
    tiny_cell.traffic["pulsars"][1]["snr"] = 60.0
    assert _run(copy.deepcopy(tiny_cell))["correct"]
    with planted("half_batch"):
        res = _run(tiny_cell)
    checks = res["checks"]
    assert not res["correct"]
    assert checks["recall_gap"]["value"] <= checks["recall_gap"]["limit"]
    assert checks["snr_gap"]["value"] <= checks["snr_gap"]["limit"]
    assert checks["pulsar_gap"]["value"] > checks["pulsar_gap"]["limit"]


def test_an_answer_altered_where_it_is_produced(tiny_cell):
    """The strongest peak of each row batch comes back 1% stronger."""
    with planted("stronger"):
        res = _run(tiny_cell)
    assert not res["correct"]
    assert res["checks"]["snr_gap"]["value"] > res["checks"]["snr_gap"]["limit"]


def test_the_bfloat16_control_is_not_correct(tiny_cell, tmp_path):
    """The reference in bfloat16 put in the program's place at the port's
    own candidates, judged by the numbers and ``decide`` a run takes."""
    from peasoup_tpu_torch.pipeline.search import PeasoupSearch

    obs = [make_observation(tiny_cell.config, tiny_cell.traffic, SEED + k, CPU) for k in range(2)]
    cfg = search_config(tiny_cell, tmp_path)
    lists = [[answers_of(PeasoupSearch(cfg, device=CPU).run(o.fil).candidates)] for o in obs]
    v = judge_run(tiny_cell, obs, lists, SEED, CPU, control=True)
    limits = tiny_cell.traffic["limits"]
    assert decide(v["numbers"], limits)[1], v["numbers"]
    checks, correct = decide(v["control"], limits)
    assert not correct
    assert checks["snr_gap"]["value"] > 3 * limits["snr_gap"]


@pytest.mark.cuda
def test_a_tiny_run_on_the_card_is_correct(tiny_cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = run_cell(tiny_cell, SEED, 0.2, False, torch.device("cuda", 0), time.perf_counter())
    assert res["correct"], res["checks"]
