"""The traced run's reduction of a ``torch.profiler`` trace: device busy
time as the union of each card's intervals, kernel time by name and by
the port's kernels, and each card's idle gaps named by what the host was
doing.

The arithmetic that attributes kernels is the port's
``tools/scope_trace.py``, frozen here: a session opens with
:data:`WARMUP_LAUNCHES` one-element kernels under :data:`WARMUP_SCOPE`,
which take the records Kineto drops at a session's start and which every
table leaves out, and each port kernel's launches held in the trace are
counted against the launches its wrapper made (``lost``). Busy time is
not a sum of durations: kernels and copies that overlap on one card count
once. The profiler's ranges of ``record_function`` scopes on the device
track are annotations, not work, and are left out.

Every time is in card-seconds: busy, window and idle seconds are summed
over the cards of the cell (each card's union, the window once a card,
each card's gaps), as kernel seconds already are, so that one less busy
over window is the cards' mean idle share; the result line's busy and
window seconds are a card's, those over the cards (``card_means``). On
one card they are that card's seconds.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

WARMUP_SCOPE = "Profiler-Warmup"
WARMUP_LAUNCHES = 1024

# the harness's own spans, around the calls into the program
WINDOW_SPAN = "portbench.window"
OBS_SPAN = "portbench.observation"
# the program's driver scopes (pipeline/search.py, accel_search.py)
PROGRAM_SCOPES = ("Dedisperse", "DM-Loop", "Spectrum-Chain", "Acceleration-Loop",
                  "Resample", "Harmonic summing", "Peaks")


def absorb_start_loss(n: int = WARMUP_LAUNCHES) -> None:
    """Launch ``n`` one-element kernels under :data:`WARMUP_SCOPE` and wait."""
    import torch
    from torch.profiler import record_function

    with record_function(WARMUP_SCOPE):
        x = torch.zeros(1, device="cuda")
        for _ in range(n):
            x.add_(1)
        torch.cuda.synchronize()


def union_length(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: list[tuple[float, float]], lo: float, hi: float) -> list[tuple[float, float]]:
    """The parts of [lo, hi) that no interval covers."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


def _in_warmup(evt) -> bool:
    while evt is not None:
        if evt.name == WARMUP_SCOPE:
            return True
        evt = evt.cpu_parent
    return False


@dataclass
class Reduced:
    window_s: float = 0.0  # the window times the cards
    busy_s: float = 0.0  # each card's union, summed
    cards: int = 1  # the cards the times are summed over
    by_name: dict = field(default_factory=dict)  # kernel name -> card-seconds
    port_seconds: dict = field(default_factory=dict)  # port kernel -> card-seconds
    port_held: dict = field(default_factory=dict)  # port kernel -> launches in the trace
    idle_by_host: dict = field(default_factory=dict)  # host activity -> idle card-seconds

    def card_means(self) -> dict:
        """``busy_s`` and ``window_s`` as the result line's ``device`` has
        them: a card's busy seconds, the mean over the cards, and the
        window's length."""
        return {"busy_s": self.busy_s / self.cards, "window_s": self.window_s / self.cards}

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:top]
        idle = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k[:120], v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in idle]}


class _HostTimeline:
    """What the host was doing at any time of the trace: the innermost
    program scope open then, or where none is, where in its observation
    the time lay (the stage timers' order: plan, dedispersion, the search's
    rounds, then the host's search, distil and scoring)."""

    def __init__(self, spans: list):
        edges = []
        for s, e, name in spans:
            edges.append((s, 1, name))
            edges.append((e, 0, name))
        edges.sort(key=lambda x: (x[0], x[1]))
        self.times, self.labels, stack = [], [], []
        for t, opening, name in edges:
            if opening:
                stack.append(name)
            elif name in stack:
                stack.reverse()
                stack.remove(name)
                stack.reverse()
            self.times.append(t)
            self.labels.append(stack[-1] if stack else None)
        self.obs = []
        for s, e, name in spans:
            if name != OBS_SPAN:
                continue
            inner = [(a, b, n) for a, b, n in spans if s <= a < e and n in ("Dedisperse", "DM-Loop")]
            loops = [(a, b) for a, b, n in inner if n == "DM-Loop"]
            self.obs.append((s, e, min((a for a, _, _ in inner), default=e),
                             min((a for a, _ in loops), default=e),
                             max((b for _, b in loops), default=e)))

    def at(self, t: float) -> str:
        i = bisect.bisect_right(self.times, t) - 1
        label = self.labels[i] if i >= 0 else None
        if label is not None and label != OBS_SPAN:
            return label
        for s, e, first, loop_start, loop_end in self.obs:
            if s <= t < e:
                if t < first:
                    return "observation: plan, before Dedisperse"
                if t < loop_start:
                    return "observation: after Dedisperse, before the search"
                if t < loop_end:
                    return "observation: between DM-Loop rounds"
                return "observation: after the search (search_host, distil, scoring)"
        return "between observations"


def reduce_events(events, symbols: dict[str, tuple], cards: int = 1) -> Reduced:
    """Reduce a profiler's FunctionEvents. ``symbols``: port kernel name ->
    its device symbols (the last launched once a wrapper launch);
    ``cards``: the cell's cards. Intervals are kept by the device index
    the trace gives them; a card of the cell with none in the window is
    idle throughout, and a card past ``cards`` that holds some counts too."""
    from torch.autograd import DeviceType

    red = Reduced()
    window = None
    spans = []
    dev = {}
    for e in events:
        if e.device_type == DeviceType.CPU:
            if e.name == WINDOW_SPAN:
                window = (e.time_range.start, e.time_range.end)
            elif e.name == OBS_SPAN or e.name in PROGRAM_SCOPES:
                spans.append((e.time_range.start, e.time_range.end, e.name))
    by_id = {e.id: e for e in events if e.device_type == DeviceType.CPU}
    for e in events:
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        launcher = by_id.get(getattr(e, "linked_correlation_id", 0) or e.id)
        if _in_warmup(launcher):
            continue
        s, t = e.time_range.start, e.time_range.end
        if window is not None and (t <= window[0] or s >= window[1]):
            continue
        dev.setdefault(e.device_index, []).append((s, t))
        sec = (t - s) / 1e6
        red.by_name[e.name] = red.by_name.get(e.name, 0.0) + sec
        for kern, syms in symbols.items():
            if any(sym in e.name for sym in syms):
                red.port_seconds[kern] = red.port_seconds.get(kern, 0.0) + sec
                if syms[-1] in e.name:
                    red.port_held[kern] = red.port_held.get(kern, 0) + 1
                break
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    lo, hi = window
    lanes = [dev[i] for i in sorted(dev)] + [[]] * max(0, cards - len(dev))
    red.cards = len(lanes)
    red.window_s = red.cards * (hi - lo) / 1e6
    host = _HostTimeline(spans)
    for lane in lanes:
        clipped = [(max(s, lo), min(t, hi)) for s, t in lane]
        red.busy_s += union_length(clipped) / 1e6
        for s, t in gaps(clipped, lo, hi):
            name = host.at(0.5 * (s + t))
            red.idle_by_host[name] = red.idle_by_host.get(name, 0.0) + (t - s) / 1e6
    return red
