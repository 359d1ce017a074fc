"""The seven span readers (metrics/upload_s.py and the six beside it) on
made-up span tables: each reads the mean over the window's tables, the
last ``len(ctx.timers)``, and nothing from an untraced run, a program
that keeps no tables, or fewer tables than observations."""

import pytest

from portbench import metrics
from portbench.run import Context

READERS = ("upload_s", "whitening_s", "fetch_wait_s", "redispatch_share",
           "distil_rows_s", "distil_native_s", "distil_objects_s")


def _table(k: float):
    """A table whose every number is ``k`` times a base value."""
    from peasoup_tpu_torch.utils.trace import RunTable, SpanStats

    tab = RunTable("Search")
    rows = [("Upload", "Dedisperse", 0.0, 0.5, {"upload.bytes": 100}),
            ("Whitening", "DM-Loop", 0.0, 0.25, {"whitening.trials": 4}),
            ("Whitening", "Other", 0.0, 0.5, {}),
            ("DM-Loop", "Search", 2.0, None, {"rows.dispatched": 300}),
            ("Wave-Fetch", "DM-Loop", 0.5, None,
             {"rows.dispatched": 100, "rows.redispatched": 100 * k}),
            ("Fetch", "Wave-Fetch", 0.125, None, {"wave.fetches": 2}),
            ("Distil-Rows", "Search-Host", 0.25, None, {}),
            ("Distil-Native", "Search-Host", 0.5, None, {}),
            ("Distil-Objects", "Search-Host", 1.0, None, {})]
    for name, parent, wall, dev, counters in rows:
        st = tab.spans[name, parent] = SpanStats(name, parent)
        st.calls, st.wall_s = 1, wall * k
        st.device_s = None if dev is None else dev * k
        st.counters = dict(counters)
    return tab


WANT = {"upload_s": 0.5, "whitening_s": 0.75, "fetch_wait_s": 0.125,
        "redispatch_share": 25.0, "distil_rows_s": 0.25, "distil_native_s": 0.5,
        "distil_objects_s": 1.0}


def _ctx(n_obs: int, traced: bool = True) -> Context:
    return Context(timers=[{}] * n_obs, trace=object() if traced else None, launches={},
                   peak=None, peak_mem_bytes=None)


@pytest.fixture
def tables(monkeypatch):
    from peasoup_tpu_torch.utils import trace

    held = []
    monkeypatch.setattr(trace, "run_tables", lambda: list(held))
    return held


@pytest.mark.parametrize("name", READERS)
def test_each_reader_takes_the_mean_over_the_window_tables(name, tables):
    # an older run's table, then the window's two at 1x and 3x: the mean is 2x
    tables.extend([_table(40.0), _table(1.0), _table(3.0)])
    assert metrics.load(name).read(_ctx(2)) == pytest.approx(2.0 * WANT[name])


@pytest.mark.parametrize("name", READERS)
def test_each_reader_reads_nothing_where_there_is_nothing(name, tables):
    reader = metrics.load(name)
    empty = Context(timers=[], trace=None, launches={}, peak=None, peak_mem_bytes=None)
    assert reader.read(empty) is None
    tables.append(_table(1.0))
    assert reader.read(_ctx(1, traced=False)) is None  # no --trace 1
    assert reader.read(_ctx(2)) is None  # fewer tables than observations
    from peasoup_tpu_torch.utils.trace import RunTable

    tables[:] = [RunTable("Search"), RunTable("Search")]  # tables without the span
    assert reader.read(_ctx(2)) is None


def test_the_readers_read_nothing_from_a_program_without_tables(monkeypatch):
    # the parent's program: utils/trace.py has no run_tables
    from peasoup_tpu_torch.utils import trace

    monkeypatch.delattr(trace, "run_tables")
    for name in READERS:
        assert metrics.load(name).read(_ctx(1)) is None
