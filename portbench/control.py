"""The readings that a cell's limits are set from, on the card:

    python3 -m portbench.control --workload NAME --seeds S1 S2 ... \
        [--control N] [--fault half_batch|stronger --faulted N]

For each seed: the cell's two observations made as a run makes them, each
searched once by the port (``PeasoupSearch.run``, as in the window), and
the lists judged by the reference (the program's readings). For the
first ``--control`` seeds the control too: the reference in bfloat16 (the
precision below the float32 the search states) put in the program's
place, its list judged by the same numbers and ``decide`` as a run's
(the control's readings, which have to come out not correct). For the
first ``--faulted`` seeds, with ``--fault``, the observations are searched
again with that fault planted under the search (``faults.py``) and judged
alike. One JSON line a seed, then a summary line: the largest program
reading and the smallest control and fault readings of each number, and
whether every control and every faulted run came out not correct. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

from .cell import load_cell
from .run import _finite, forbidden_modules, judge_run, search_config


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3, help="seeds that also run the control")
    ap.add_argument("--fault", default="", help="a fault of faults.py to plant")
    ap.add_argument("--faulted", type=int, default=3, help="seeds that also run the fault")
    args = ap.parse_args(argv)
    import torch

    from peasoup_tpu_torch import kernels
    from peasoup_tpu_torch.pipeline.search import PeasoupSearch

    from .faults import planted
    from .gen import make_observation
    from .reference.check import answers_of, decide

    if not torch.cuda.is_available():
        print("portbench.control: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = load_cell(args.workload)
    limits = cell.traffic["limits"]
    kernels.load()
    cfg = search_config(cell, Path(os.environ.get("TMPDIR") or tempfile.gettempdir()))
    worst: dict = {}
    least = {"control": {}, "fault": {}}
    verdicts = {"control": [], "fault": []}

    def search(obs):
        return [[answers_of(PeasoupSearch(cfg, device=dev).run(o.fil).candidates)] for o in obs]

    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        obs = [make_observation(cell.config, cell.traffic, seed + k, dev) for k in range(2)]
        lists = search(obs)
        faulted = None
        if args.fault and i < args.faulted:
            with planted(args.fault):
                faulted = search(obs)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        v = judge_run(cell, obs, lists, seed, dev, control=i < args.control)
        line = {"seed": seed, "program": v["numbers"],
                "program_correct": decide(v["numbers"], limits)[1]}
        for n, x in v["numbers"].items():
            worst[n] = max(worst.get(n, x), x)
        readings = {}
        if "control" in v:
            readings["control"] = v["control"]
        if faulted is not None:
            readings["fault"] = judge_run(cell, obs, faulted, seed, dev)["numbers"]
        for kind, nums in readings.items():
            ok = decide(nums, limits)[1]
            verdicts[kind].append(ok)
            line[kind] = nums
            line[f"{kind}_correct"] = ok
            for n, x in nums.items():
                least[kind][n] = min(least[kind].get(n, x), x)
        line["info"] = dict(v["info"], search_s=t1 - t0, judge_s=time.perf_counter() - t1,
                            candidates=[len(ls[0]) for ls in lists])
        print(json.dumps(_finite(line)), flush=True)
        del obs, lists, faulted
        torch.cuda.empty_cache()
    if forbidden_modules():
        print(f"modules of JAX or the JAX package loaded: {forbidden_modules()}", file=sys.stderr)
        return 4
    print(json.dumps(_finite({
        "summary": cell.name, "seeds": len(args.seeds), "program_max": worst,
        "control_min": least["control"], "fault": args.fault, "fault_min": least["fault"],
        "control_correct": verdicts["control"], "fault_correct": verdicts["fault"],
        "limits": limits})), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
