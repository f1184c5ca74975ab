"""One traced run of a cell, as ``run.py --trace 1`` makes it, with what
its result line leaves out: the end-to-end metrics of the run's window,
the tick's device time and kernels a tick by phase (``rest`` included;
``phase_readers.phase_split``), the program's host spans by path from
their top span (the median over top spans of each path's time summed),
and the share of the card's idle time in the traced segment that falls
inside a program span.

    python3 benchmark/phase_report.py --workload <cell> --seed <n> --seconds <s> [--out <file>]

The report is printed as one JSON line after the run's own lines and
appended to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from collections import defaultdict

T0 = time.perf_counter()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402
from benchmark import phase_readers as pr  # noqa: E402


def span_paths(spans) -> dict:
    """For each path of names from a top span (``node.step/tick/tick.wait``),
    the count of top spans and the median over them of the path's
    seconds summed, in ms."""
    by_id = {s.id: s for s in spans}
    sums = defaultdict(lambda: defaultdict(float))
    tops = defaultdict(set)
    for s in spans:
        names, top = [s.name], s
        while top.parent in by_id:
            top = by_id[top.parent]
            names.append(top.name)
        if top.parent is not None:        # its top span left the ring
            continue
        tops[top.name].add(top.id)
        sums["/".join(reversed(names))][top.id] += s.duration
    out = {}
    for path, per_top in sorted(sums.items()):
        ids = tops[path.split("/")[0]]
        values = [per_top.get(i, 0.0) for i in ids]
        out[path] = {"tops": len(ids), "median_ms": 1e3 * statistics.median(values)}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="a traced run of one cell, by phase and span")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    args.trace = 1
    # as run.py: one process with few threads, set before torch is imported
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    records, read_metrics = [], harness.read_metrics

    def keeping(entries, run):
        records.append(run)
        return read_metrics(entries, run)

    harness.read_metrics = keeping
    try:
        result = harness.run(args, t0=T0)
    except harness.RunError as err:
        print(f"benchmark: {err}", file=sys.stderr, flush=True)
        return 2
    finally:
        harness.read_metrics = read_metrics
    run = records[0]
    man = harness.manifest()
    spans = pr.program_spans()
    idle = pr.idle_in_spans(run, spans)
    report = {"line": "phase_report", "workload": args.workload, "seed": args.seed,
              "correct": result["correct"],
              "failed": result["failed"], "device": result["device"],
              "end_to_end": {k: v["value"] for k, v in read_metrics(
                  harness.metrics_for(man, args.workload, "end_to_end"), run).items()},
              "per_layer": {k: v["value"] for k, v in result["metrics"].items()},
              "phases": pr.phase_split(run),
              "idle_in_spans": None if idle is None else {"share": idle[0], "idle_s": idle[1]},
              "spans": span_paths(spans) if spans else None,
              "setup_s": run["setup_s"], "power_limit_w": run["power_limit_w"]}
    line = json.dumps(report)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
