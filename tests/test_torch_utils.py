"""The port's utils/ (progress bar, phase timing, trace spans, buffer dumps)
against the JAX package's on the CPU, and the progress bar the port's
drivers now draw: ``-p`` on ``peasoup``, ``spsearch``, ``peasoup-fdas``
and ``peasoup-ffa`` leaves the bar's final frame on stderr, as the JAX
CLIs do, and the candidates are the bytes of a run without it."""

import io
import os
import time
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

from peasoup_tpu.utils import ProgressBar as JaxProgressBar
from peasoup_tpu_torch.utils import ProgressBar, Stopwatch, dump_buffer, trace_span


class FakeClock:
    def __init__(self, times):
        self.times = list(times)

    def __call__(self):
        return self.times.pop(0)


# (clock readings, updates): start() reads the clock once, every update
# reads it once
SEQUENCES = [
    ([0.0, 0.05, 0.2, 0.25, 0.4, 1.0, 1.1], [0.1, 0.2, 0.3, 0.5, 1.0, 1.0]),
    ([10.0, 10.5, 11.0, 11.01, 12.0], [0.0, 0.25, 0.26, 0.9]),
    ([0.0, 0.01, 0.02, 0.03], [1.0, 1.0, 0.5]),
]


@pytest.mark.parametrize("min_interval", [0.0, 0.1])
@pytest.mark.parametrize("times,updates", SEQUENCES)
def test_progress_frames_are_the_jax_bars(monkeypatch, times, updates, min_interval):
    frames = []
    for cls in (JaxProgressBar, ProgressBar):
        monkeypatch.setattr(time, "perf_counter", FakeClock(times + [times[-1]] * 4))
        buf = io.StringIO()
        bar = cls(stream=buf, min_interval=min_interval)
        bar.start()
        for f in updates:
            bar.update(f)
        bar.stop()
        bar.update(0.9)  # after stop: no frame
        frames.append(buf.getvalue())
    assert frames[0] == frames[1]
    assert "100.0%" in frames[1]


def test_progress_bar_writes_to_stderr_by_default(capsys):
    bar = ProgressBar(min_interval=0.0)
    bar.start()
    bar.update(0.5)
    bar.stop()
    cap = capsys.readouterr()
    assert cap.out == ""
    assert "50.0%" in cap.err and "100.0%" in cap.err and "ETA" in cap.err


def test_stopwatch_accumulates():
    sw = Stopwatch()
    sw.start()
    sw.stop()
    first = sw.elapsed
    sw.start()
    sw.stop()
    assert sw.getTime() >= first  # accumulates across start/stop pairs
    sw.reset()
    assert sw.elapsed == 0.0
    with pytest.raises(RuntimeError):
        sw.stop()


def test_stopwatch_names_its_span_when_mispaired():
    sw = Stopwatch()
    with trace_span("DM-Loop", sw):
        pass
    with pytest.raises(RuntimeError, match="'DM-Loop'"):
        sw.stop()


def test_trace_span_times_nests_and_reaches_the_profiler():
    sw = Stopwatch()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace_span("DM-Loop", sw):
            with trace_span("Acceleration-Loop"):
                torch.ones(8).sum()
    assert sw.elapsed >= 0.0
    names = {e.name for e in prof.events()}
    assert {"DM-Loop", "Acceleration-Loop"} <= names


@pytest.mark.parametrize("dtype", [np.float32, np.int16, np.complex64, np.uint8])
def test_dump_buffer_roundtrip(tmp_path, dtype):
    """A tensor dumps its raw little-endian bytes, as the JAX package's
    dump of the same values does."""
    from peasoup_tpu.utils import dump_buffer as jax_dump

    x = (np.arange(100) * 3 % 251).astype(dtype)
    ours, theirs = str(tmp_path / "ours.bin"), str(tmp_path / "jax.bin")
    dump_buffer(torch.from_numpy(x.copy()), ours)
    jax_dump(x, theirs)
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    np.testing.assert_array_equal(np.fromfile(ours, dtype=dtype), x)


def test_dump_buffer_writes_little_endian(tmp_path):
    x = np.arange(10, dtype=">f4")
    path = str(tmp_path / "be.bin")
    dump_buffer(x, path)
    np.testing.assert_array_equal(np.fromfile(path, dtype="<f4"), x.astype("<f4"))


# --- -p on the CLIs ------------------------------------------------------

@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    import chip_smoke

    from test_torch_ffa import _ffa_fil

    d = tmp_path_factory.mktemp("p_inputs")
    paths = {k: str(d / f"{k}.fil") for k in ("fake", "sp", "fdas", "ffa")}
    chip_smoke.small_fil(paths["fake"])
    chip_smoke.sp_small_fil(paths["sp"])
    chip_smoke.fdas_small_fil(paths["fdas"])
    _ffa_fil(paths["ffa"])
    return paths


@pytest.fixture
def jax_log_kept():
    """The JAX CLIs install their log handler on the stderr of the moment,
    here pytest's capture, which is closed after the test: put the JAX
    logger back as it was."""
    from peasoup_tpu.obs import log as jax_log

    logger = jax_log.get_logger()
    handler, handlers, level = jax_log._handler, list(logger.handlers), logger.level
    yield
    jax_log._handler = handler
    logger.handlers[:] = handlers
    logger.setLevel(level)


def _ffa_candidates(path: str) -> list:
    root = ET.parse(path).getroot()
    return [ET.tostring(c) for c in root.findall("candidates/candidate")]


# cli name, input, flags, the output (under the -o target) that must not change
CLIS = [
    ("peasoup", "fake", ["--dm_end", "40", "--acc_start", "-2", "--acc_end", "2",
                         "-m", "6"], "candidates.peasoup"),
    ("spsearch", "sp", ["--dm_end", "60", "-m", "7", "--n_widths", "8"],
     "candidates.singlepulse"),
    ("fdas", "fdas", ["--dm_start", "50", "--dm_end", "70", "--zmax", "32", "-n", "2"],
     "candidates.fdas"),
    ("ffa", "ffa", ["--dm_end", "10", "--p_start", "1.0", "--p_end", "8.0",
                    "--min_dc", "0.01"], None),
]


@pytest.mark.parametrize("name,fil,flags,product", CLIS, ids=[c[0] for c in CLIS])
def test_p_draws_the_bar_and_keeps_the_outputs(tmp_path, capsys, inputs, jax_log_kept,
                                               name, fil, flags, product):
    import importlib

    main = importlib.import_module(f"peasoup_tpu_torch.cli.{name}").main
    jax_main = importlib.import_module(f"peasoup_tpu.cli.{name}").main
    outs, errs = {}, {}
    for label, extra in (("plain", []), ("p", ["-p"])):
        out = str(tmp_path / (f"{label}.xml" if product is None else label))
        assert main(["-i", inputs[fil], "-o", out, *flags, *extra, "--device", "cpu"]) == 0
        errs[label] = capsys.readouterr().err
        if product is None:
            outs[label] = _ffa_candidates(out)
        else:
            with open(os.path.join(out, product), "rb") as f:
                outs[label] = f.read()
    out = str(tmp_path / ("jax.xml" if product is None else "jax"))
    assert jax_main(["-i", inputs[fil], "-o", out, *flags, "-p"]) == 0
    jax_err = capsys.readouterr().err
    assert outs["p"] == outs["plain"] and outs["p"]
    assert "100.0%" not in errs["plain"]
    # the bar's last frame, as the JAX CLI leaves it
    final = "\rComplete: 100.0%  ETA: 0.0 s   \n"
    assert final in errs["p"]
    assert final in jax_err
