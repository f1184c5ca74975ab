"""The traced segment of a ``--trace 1`` run: ``torch.profiler`` over the
host and the card, reduced to what the per-layer readers take.

``trace(fn)`` runs ``fn()`` under the profiler and returns the card's
events (name, start, end in seconds), the busy time (the union of the card's events, the busy-share
arithmetic of ``chip_smoke.py::union_us``), the traced window (from the
card's first event to its last, less the idle time under the profiler's
own buffer flushes, which tracing alone causes), and the breakdown: the
ten device operations that took most time, and the ten longest idle gaps
by the host operation that was running in them.
"""

from __future__ import annotations

import heapq
import re
from collections import defaultdict

from .yardstick import gaps, union_length

NO_HOST_OP = "_no_host_op_"
# the profiler's own bookkeeping: the card idles while the host flushes or
# requests the profiler's activity buffers, a cost of tracing itself
PROFILER_OPS = ("Buffer_Flush", "Activity_Buffer_Request")


def _short(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_:.]", "_", name)[:64]


def breakdown(device, host) -> dict:
    """The ten device operations by total time, and the ten host
    operations under which the card sat idle longest (the innermost host
    event running at each gap's middle), with ``"stall_s"``: the idle time
    under the profiler's own bookkeeping."""
    by_name = defaultdict(float)
    for name, lo, hi in device:
        by_name[_short(name)] += hi - lo
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    # sweep the gaps' middles in order; a max-heap by start holds the host
    # events begun so far, those ended before the current middle dropped
    host_sorted = sorted(host, key=lambda e: e[1])
    idle = defaultdict(float)
    heap, k = [], 0
    for lo, hi in gaps([(d[1], d[2]) for d in device]):
        mid = 0.5 * (lo + hi)
        while k < len(host_sorted) and host_sorted[k][1] <= mid:
            name, start, end = host_sorted[k]
            heapq.heappush(heap, (-start, end, name))
            k += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        idle[_short(heap[0][2]) if heap else NO_HOST_OP] += hi - lo
    idle_top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    stall = sum(idle.get(name, 0.0) for name in PROFILER_OPS)
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in idle_top],
            "stall_s": stall}


def trace(fn) -> dict:
    """``fn()`` under the profiler; returns the reduced trace and what
    ``fn`` returned (``"result"``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        result = fn()
        torch.cuda.synchronize()
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        lo, hi = e.start_ns() * 1e-9, e.end_ns() * 1e-9
        if e.device_type() == DeviceType.CUDA:
            device.append((e.name(), lo, hi))
        else:
            host.append((e.name(), lo, hi))
    del prof            # the profiler's own copy of the events goes now
    busy = union_length([(d[1], d[2]) for d in device])
    parts = breakdown(device, host)
    stall = parts.pop("stall_s")
    span = max(d[2] for d in device) - min(d[1] for d in device) if device else 0.0
    # the traced window: the card's first event to its last, without the
    # idle time under the profiler's own bookkeeping
    return {"device": device, "busy_s": busy, "window_s": max(span - stall, busy),
            "stall_s": stall, "breakdown": parts, "result": result}
