"""A tiny cell for the CPU tests: a 16-channel, 2-bit observation of
8,392 samples (an FFT of 8,192), DM 0-40 and three acceleration trials,
two pulsars and 50 Hz mains. The harness, the port's plain CPU path and
the reference run it in about a second."""

import copy

import pytest

TINY_CONFIG = {
    "name": "tiny",
    "header": {"nchans": 16, "fch1": 400.0, "foff": -1.0, "tsamp": 0.001, "nbits": 2,
               "nsamps": 8392},
    "mains_hz": 50.0,
}
TINY_TRAFFIC = {
    "name": "tiny",
    "search": {"dm_start": 0.0, "dm_end": 40.0, "acc_start": -5.0, "acc_end": 5.0},
    "pulsars": [{"period_s": 0.1013, "dm": 20.0, "duty": 0.05, "snr": 40.0, "accel": 0.0},
                {"period_s": 0.0371, "dm": 31.0, "duty": 0.05, "snr": 30.0, "accel": -2.0}],
    "mains": {"amplitude": 0.05, "harmonics": [1.0, 0.5], "birdie_width_hz": 0.5},
    "check": {"top": 4, "sample": 6, "box_dm": 2, "family_tol": 5e-4},
    "limits": {"snr_gap": 2e-4, "recall_gap": 3e-5, "pulsar_gap": 3e-5, "distil_pairs": 0,
               "score_mismatches": 0},
}
E2E = [{"name": "obs_s", "unit": "s"}, {"name": "setup_s", "unit": "s"}]


@pytest.fixture
def tiny_cell():
    from portbench.cell import Cell

    return Cell(name="tiny", chips=1, config=copy.deepcopy(TINY_CONFIG),
                traffic=copy.deepcopy(TINY_TRAFFIC), end_to_end=E2E, per_layer=[])
