"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m portbench.run --workload NAME --seed N --seconds S --trace 0|1

A cell of ``chips`` N runs on the cards ``cuda:0`` to ``cuda:N-1``; for
N > 1 its search shards the DM trials over them (``shard_devices`` N,
the port's own ``_pick_devices``). Set-up (``setup_s``): the port's
kernels built or loaded, a context made on each card of the cell, the
cell's two observations made on the first card from ``seed`` and
``seed + 1`` and copied to host RAM in the form
``io/sigproc.py:read_filterbank`` gives, the birdie list and the
configuration's kill file written under ``TMPDIR``, and one whole
observation searched as a warm-up. The window: observations searched
back to back, the two taking turns, each
``PeasoupSearch(cfg, device=cuda:0).run(fil)`` and a wait on every card
of the cell, in pairs (one of each), until the first pair that ends at
or after ``--seconds``; every window holds the same work. A closed loop
with one client: a survey node searching its queue. ``obs_s`` is the
window's wall time over the observations completed in it.

The cards used are measured, not assumed: after the window each visible
card's allocator peak is read, and a card counts as used where it is
above 0. ``device.count`` is the number used, ``memory_peak_bytes`` the
fullest card's peak, ``power_limit_w`` the lowest limit among them and
``info.cards`` each one; a run that used fewer cards than its cell's
``chips`` prints why and no result, and exits 5.

With ``--trace 1`` the window runs under ``torch.profiler`` and the line
carries the per-layer metrics (``metrics/<name>.py``), the device's busy
seconds (the mean over the cell's cards) and the window's length, and a
breakdown in card-seconds (summed over the cards). Once the window has
closed the candidate lists are judged on the first card against the
plain reference (``reference/check.py``) and every number compared is
printed beside its limit, as the last lines of standard error and under
``checks``, the last key of the result line.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from collections import Counter  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

from .cell import Cell, load_cell  # noqa: E402

# the JAX side of the repository, which no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "peasoup_tpu")


def forbidden_modules() -> list[str]:
    """Modules loaded in this process whose top-level name is JAX's or the
    JAX package's, compared whole (``peasoup_tpu_torch`` is not one)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


@dataclass
class Context:
    """What a per-layer metric reads (metrics/<name>.py)."""

    timers: list  # each window observation's stage timers
    trace: object  # trace.Reduced, or None without --trace 1
    launches: dict  # kernel -> {launch shape: launches} in the window
    peak: tuple | None  # one card's (FLOP/s, bytes/s)
    peak_mem_bytes: int | None  # the fullest card's
    config: dict | None = None  # the cell's configuration (the counts read its kill mask)

    def mean_timer(self, name: str) -> float | None:
        vals = [t[name] for t in self.timers if name in t]
        return sum(vals) / len(vals) if vals else None

    def roofline_share(self, kernel: str) -> float | None:
        """% of its roofline a kernel reaches in the trace, or None where it
        launched nothing or the trace holds none of its launches."""
        from . import roofline

        shapes = self.launches.get(kernel)
        if not shapes or self.trace is None or self.peak is None:
            return None
        secs = self.trace.port_seconds.get(kernel, 0.0)
        held = self.trace.port_held.get(kernel, 0)
        if secs <= 0 or held <= 0:
            return None
        bound, _ = roofline.bound_seconds(kernel, shapes, self.peak, self.config or {})
        # where the trace lacks launches, hold its time to that share of the count
        return 100.0 * bound * min(1.0, held / sum(shapes.values())) / secs


def _launch_snapshot(kernels) -> dict:
    return {k: Counter(v) for k, v in kernels.launch_shapes.items()}


def _launch_delta(before: dict, kernels) -> dict:
    out = {}
    for k, after in kernels.launch_shapes.items():
        d = Counter(after)
        d.subtract(before.get(k, Counter()))
        d = {s: n for s, n in d.items() if n > 0}
        if d:
            out[k] = d
    return out


def cell_cards(cell: Cell, device) -> list:
    """The cards of ``cell``: ``chips`` cards from ``device`` on, or on the
    CPU ``device`` alone."""
    import torch

    if device.type != "cuda":
        return [device]
    first = device.index or 0
    return [torch.device("cuda", first + i) for i in range(cell.chips)]


def _sync(cards) -> None:
    import torch

    for d in cards:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def search_config(cell: Cell, tmp: Path):
    """The port's SearchConfig of the cell: the mix's flags, the DM trials
    sharded over the cell's ``chips`` cards where it has more than one,
    and the site's birdie list and the configuration's kill file written
    under ``tmp``."""
    from peasoup_tpu_torch.pipeline.search import SearchConfig

    from .gen import write_birdies, write_killfile

    flags = dict(cell.traffic["search"])
    if "shard_devices" in flags:
        raise ValueError(f"traffic of {cell.name} sets shard_devices; the cell's chips set it")
    if cell.chips > 1:
        flags["shard_devices"] = cell.chips
    birdie_path = tmp / f"portbench-{cell.name}-birdies.txt"
    write_birdies(birdie_path, cell.config, cell.traffic)
    kill_path = tmp / f"portbench-{cell.name}-kill.txt"
    killfile = str(kill_path) if write_killfile(kill_path, cell.config) else ""
    return SearchConfig(zapfilename=str(birdie_path), killfilename=killfile, **flags)


def read_cards() -> list[dict]:
    """Every visible card's index, name and allocator peak, read after the
    window; each card's power limit where its peak is above 0."""
    import torch

    from .peaks import power_limit_w

    cards = []
    for i in range(torch.cuda.device_count()):
        peak = int(torch.cuda.max_memory_allocated(i))
        cards.append({"index": i, "name": torch.cuda.get_device_name(i), "peak_bytes": peak,
                      "power_limit_w": power_limit_w(i) if peak > 0 else None})
    return cards


def card_report(cards: list[dict]) -> tuple[dict, list[dict]]:
    """The result line's ``device`` from the cards of :func:`read_cards`,
    and the cards used (allocator peak above 0): their count, their shared
    name, the fullest card's peak and the lowest power limit among them."""
    used = [c for c in cards if c["peak_bytes"] > 0]
    names = sorted({c["name"] for c in used})
    if len(names) > 1:
        raise ValueError(f"the cards used differ: {names}")
    dev = {"platform": "gpu", "kind": names[0] if names else "", "count": len(used),
           "memory_peak_bytes": max((c["peak_bytes"] for c in used), default=0)}
    limits = [c["power_limit_w"] for c in used if c["power_limit_w"] is not None]
    if limits:
        dev["power_limit_w"] = min(limits)
    return dev, used


def judge_run(cell: Cell, obs: list, lists: list, seed: int, device,
              control: bool = False) -> dict:
    """The reference's numbers for the lists ``lists`` (distinct lists of
    Answers of each observation of ``obs``)."""
    from .cell import killmask
    from .gen import birdies
    from .reference.check import judge

    return judge(cell.header, cell.traffic["search"], birdies(cell.config, cell.traffic),
                 [(o.fil.raw if o.fil.raw is not None else o.fil.data, ls, o.pulsars)
                  for o, ls in zip(obs, lists)], seed, device, cell.traffic["check"],
                 killmask(cell.config), control=control)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """One run of ``cell`` on its cards, ``device`` the first: set-up
    (timed from ``t_start``), window, judgement. Returns the result line's
    object."""
    import torch
    from torch.profiler import record_function

    from peasoup_tpu_torch import kernels
    from peasoup_tpu_torch.pipeline.search import PeasoupSearch

    from . import metrics, roofline
    from .gen import make_observation
    from .peaks import peaks
    from .reference.check import answers_of, decide
    from .trace import OBS_SPAN, WINDOW_SPAN, absorb_start_loss, reduce_events

    on_card = device.type == "cuda"
    cards = cell_cards(cell, device)
    parts = {"start": time.perf_counter() - t_start}
    if on_card:
        kernels.load()
        for d in cards:
            torch.zeros(1, device=d)
    parts["kernels"] = time.perf_counter() - t_start
    obs = [make_observation(cell.config, cell.traffic, seed + i, device) for i in range(2)]
    parts["observations"] = time.perf_counter() - t_start
    cfg = search_config(cell, Path(os.environ.get("TMPDIR") or tempfile.gettempdir()))
    PeasoupSearch(cfg, device=device).run(obs[0].fil)
    _sync(cards)
    parts["warm_up"] = time.perf_counter() - t_start
    if on_card:
        for d in cards:
            torch.cuda.reset_peak_memory_stats(d)
    setup_s = time.perf_counter() - t_start

    timers, lists = [], [dict(), dict()]
    attempted = failed = 0
    before = _launch_snapshot(kernels)
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        prof = profile(activities=acts)
        prof.__enter__()
        if on_card:
            absorb_start_loss()
    ru0 = resource.getrusage(resource.RUSAGE_SELF)
    t0 = time.perf_counter()
    with record_function(WINDOW_SPAN):
        while True:
            # one pair: each observation once, so every window holds the same work
            for k in range(2):
                attempted += 1
                try:
                    with record_function(OBS_SPAN):
                        res = PeasoupSearch(cfg, device=device).run(obs[k].fil)
                    _sync(cards)
                except Exception:  # a failed observation counts, and the window goes on
                    failed += 1
                    traceback.print_exc()
                    res = None
                if res is not None:
                    # the answers copied out and the port's objects let go, so
                    # the next observation runs on the heap that this one had
                    timers.append(res.timers)
                    ans = answers_of(res.candidates)
                    del res
                    lists[k].setdefault(tuple(a.key() for a in ans), ans)
            window_s = time.perf_counter() - t0
            if window_s >= seconds:
                break
    ru1 = resource.getrusage(resource.RUSAGE_SELF)
    host = {"user_s": ru1.ru_utime - ru0.ru_utime, "system_s": ru1.ru_stime - ru0.ru_stime}
    red = None
    if prof is not None:
        prof.__exit__(None, None, None)
        red = reduce_events(prof.events(), roofline.symbols(), len(cards))
        del prof
    completed = attempted - failed
    launches = _launch_delta(before, kernels)
    if on_card:
        dev, used = card_report(read_cards())
        for d in cards:
            with torch.cuda.device(d):
                torch.cuda.empty_cache()
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": None}
        used = []
    limit_w = dev.get("power_limit_w")

    verdict = judge_run(cell, obs, [list(ls.values()) for ls in lists], seed, device)
    checks, held = decide(verdict["numbers"], cell.traffic["limits"])
    correct = failed == 0 and completed > 0 and held

    out_metrics = {}
    if trace:
        ctx = Context(timers=timers, trace=red, launches=launches,
                      peak=peaks(dev["kind"]) if on_card else None,
                      peak_mem_bytes=dev["memory_peak_bytes"],
                      config=cell.config)
        for m in cell.per_layer:
            v = metrics.load(m["name"]).read(ctx)
            if v is not None:
                entry = {"value": v, "unit": m["unit"]}
                if m["unit"] == "%" and limit_w is not None:
                    entry["power_limit_w"] = limit_w
                out_metrics[m["name"]] = entry
    else:
        e2e = {"obs_s": window_s / completed if completed else math.inf, "setup_s": setup_s}
        for m in cell.end_to_end:
            out_metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": out_metrics, "device": dev}
    if red is not None:
        dev.update(red.card_means())
        result["breakdown"] = red.breakdown()
    result["info"] = dict(verdict["info"], observations=completed, window_s=window_s,
                          setup_parts=parts, obs_seconds=[t.get("total") for t in timers],
                          obs_timers=timers, host=host,
                          top=[[[a.freq, a.dm, a.acc, a.nh, a.snr] for a in ans[:8]]
                               for ls in lists for ans in ls.values()],
                          distinct_lists=[len(ls) for ls in lists],
                          candidates=[len(next(iter(ls.values()), [])) for ls in lists],
                          pulsars=[o.describe() for o in obs], cards=used)
    result["checks"] = checks
    return result


def _finite(x):
    """The result with each number that JSON cannot hold (an infinite or
    undefined gap) as its name, a string."""
    if isinstance(x, float) and not math.isfinite(x):
        return repr(x)
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_finite(v) for v in x]
    return x


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = load_cell(args.workload)
        import torch

        import peasoup_tpu_torch  # noqa: F401  (the program under test must be there)
    except (OSError, KeyError, ImportError) as exc:
        print(f"portbench: cannot load the cell or the program: {exc!r}", file=sys.stderr)
        return 3
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T_START)
    if result["device"]["count"] < cell.chips:
        print(f"portbench: {cell.name} asks for {cell.chips} cards and did work on "
              f"{result['device']['count']}: {result['info']['cards']}", file=sys.stderr)
        return 5
    found = forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package loaded: {found}", file=sys.stderr)
        return 4
    for n, c in result["checks"].items():
        print(f"check {n} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
