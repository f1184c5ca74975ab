"""The per-layer readers of the tick's phases on the card and of the
program's host spans, shared by the metric files that read one quantity
in different cells (``metrics/<name>.py``).

Device phases. The program marks each phase boundary of a tick on the
card with an empty kernel ``bp_phase_<phase>``
(``boundplanner_tpu_torch/telemetry.py``): ``tick`` where ``mpc_tick``
starts, ``link`` (the link collision sets), ``ocp`` / ``qp`` /
``line_search`` once per SQP iteration, and ``rest`` after the link sets
and after the SQP. The tick's CUDA graph holds them as nodes, so every
replay carries them on the card's clock. `phase_split` sorts the traced
segment's device events by start and gives each to the phase of the latest
mark that started before it (events before the first mark go to
``rest``). A phase's device time a tick is the union of its events'
intervals, marks left out, over the count of ``bp_phase_tick`` marks; its
kernels a tick are its events, marks left out. ``rest`` holds the ``tick``
and ``rest`` phases: the tick's own work before the link sets, between
them and the SQP and after it, the rollout's plant step, and in the arm
the node's eager kernels. Where the ``tick`` marks are not the traced
ticks, nothing is read; a phase without a mark reads nothing.

Host spans. ``boundplanner_tpu_torch.telemetry.spans()``: the program's
own store of spans in this process, every span of the run (set-up, the
window and the traced segment), whose medians over periods or replays the
readers take. A program without the store reads nothing.
"""

from __future__ import annotations

import statistics
from collections import defaultdict

from benchmark.yardstick import gaps, union_length

MARK = "bp_phase_"
PHASES = ("link", "ocp", "qp", "line_search")
REST = ("tick", "rest")


def phase_split(run):
    """{"ticks", "ms": {phase: ms a tick}, "kernels": {phase: events a
    tick}, "marked": the phases with a mark} over `PHASES` and ``rest``,
    or None (see the module)."""
    tr = run.get("trace")
    if not tr or not tr.get("device"):
        return None
    events = sorted(tr["device"], key=lambda e: e[1])
    ticks = sum(1 for name, _, _ in events if name == MARK + "tick")
    if ticks == 0 or ticks != tr["ticks"]:
        return None
    spans, marked, phase = defaultdict(list), set(), "rest"
    for name, lo, hi in events:
        if name.startswith(MARK):
            phase = name[len(MARK):]
            marked.add(phase)
            continue
        spans["rest" if phase in REST else phase].append((lo, hi))
    keys = PHASES + ("rest",)
    return {"ticks": ticks,
            "ms": {p: 1e3 * union_length(spans[p]) / ticks for p in keys},
            "kernels": {p: len(spans[p]) / ticks for p in keys},
            "marked": sorted(marked)}


def phase_device_ms(run, phase: str):
    """``phase``'s device time a tick in the traced segment, in ms."""
    split = phase_split(run)
    if split is None or phase not in split["marked"]:
        return None
    return split["ms"][phase]


def program_spans():
    """The program's stored spans, or None where it keeps none."""
    try:
        from boundplanner_tpu_torch import telemetry
    except ImportError:
        return None
    read = getattr(telemetry, "spans", None)
    return read() if read is not None else None


def _median_ms(values):
    return 1e3 * statistics.median(values) if values else None


def child_sums(spans, parent: str) -> list[dict]:
    """For each span named ``parent``, the seconds of its direct children
    summed by name."""
    sums = {s.id: defaultdict(float) for s in spans if s.name == parent}
    for s in spans:
        if s.parent in sums:
            sums[s.parent][s.name] += s.duration
    return list(sums.values())


def node_fk_ms(spans):
    """The median over periods (``node.step``) of the period's
    ``node.fk`` spans summed, in ms."""
    if not spans:
        return None
    return _median_ms([c["node.fk"] for c in child_sums(spans, "node.step")])


def tick_host_ms(spans):
    """The median over the node's ticks of ``tick`` less its
    ``tick.wait``: the tick's host work, in ms."""
    if not spans:
        return None
    ticks = {s.id: s.duration for s in spans if s.name == "tick"}
    waits = defaultdict(float)
    for s in spans:
        if s.name == "tick.wait" and s.parent in ticks:
            waits[s.parent] += s.duration
    return _median_ms([d - waits[i] for i, d in ticks.items()])


def named_median_ms(spans, name: str):
    """The median duration of the spans named ``name``, in ms."""
    if not spans:
        return None
    return _median_ms([s.duration for s in spans if s.name == name])


def idle_in_spans(run, spans):
    """The share of the card's idle time in the traced segment (the gaps
    between its events, from the first to the last) that falls inside a
    program span, with the idle seconds: (share, idle_s), or None."""
    tr = run.get("trace")
    if not tr or not tr.get("device") or not spans:
        return None
    idle = gaps([(lo, hi) for _, lo, hi in tr["device"]])
    total = sum(hi - lo for lo, hi in idle)
    if total <= 0:
        return None
    t0, t1 = idle[0][0], idle[-1][1]
    host = sorted((s.start_ns * 1e-9, s.end_ns * 1e-9) for s in spans
                  if s.end_ns * 1e-9 > t0 and s.start_ns * 1e-9 < t1)
    merged = []
    for lo, hi in host:
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    inside, k = 0.0, 0
    for lo, hi in idle:
        while k < len(merged) and merged[k][1] <= lo:
            k += 1
        j = k
        while j < len(merged) and merged[j][0] < hi:
            inside += min(hi, merged[j][1]) - max(lo, merged[j][0])
            j += 1
    return inside / total, total
