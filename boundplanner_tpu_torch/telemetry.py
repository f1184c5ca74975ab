"""Structured telemetry: the port's per-period records, host spans and
the tick's device phase marks.

- `MPCTickRecord` / `TelemetryRecorder`: the field set of the reference's
  ROS telemetry message (`boundmpcmsg/msg/MPCData.msg`: timings
  t_comp/t_loop/t_overhead, cost, iterations, errors, references) without
  the ROS dependency, held equal to the JAX package's records; exportable
  as dict-of-arrays or streamed to the optional ROS 2 adapter
  (`ros_compat`).
- `span(name)`: a host span (name, start, end, parent span), on the clock
  of ``torch.profiler``'s events (the Unix epoch in nanoseconds,
  ``time.time_ns``), so that the program's spans and the card's events
  share one timeline. Spans go to one ring of the newest `SPAN_CAPACITY`
  (`spans`, `clear`). While a profiler runs, a span also opens a host
  range of its name in the trace: the profiler's fast record-function
  range (``torch._C._profiler._RecordFunctionFast``), a host event only.
  ``torch.profiler.record_function``'s user range would also put a
  device-side annotation event over the span's kernels on the card's
  timeline, which a trace's device events would count as work.
- `device_tick(device)` / `device_phase(phase, device)`: the tick's phase
  boundaries on the card. Each boundary is one launch of an empty
  one-thread kernel named ``bp_phase_<phase>`` (`csrc/graph_cond.cu`) on
  the device's current stream: under a CUDA graph's capture it becomes a
  node of the graph, so every replay carries the boundaries on the card's
  own clock, in the profiler's device events by name (a replay runs no
  Python, so a host range cannot split it). Phases are marked only inside
  a tick on the calling thread, so the planner's own SQP marks nothing; on
  the CPU nothing is launched.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import threading
import time
from collections import deque
from typing import Dict, List

import numpy as np
import torch

SPAN_CAPACITY = 65536
# the phases of a tick, in the order of ``bp_phase_mark``'s ids
PHASES = ("tick", "link", "ocp", "qp", "line_search", "rest")


@dataclasses.dataclass
class MPCTickRecord:
    """Per-control-period telemetry (field parity with `MPCData.msg:2-8`)."""

    t: float                 # simulation time
    t_comp: float            # solver wall time
    t_loop: float            # full loop wall time
    t_overhead: float        # loop minus solver
    cost: float
    iterations: int
    phi: float
    dphi: float
    phi_max: float
    sector: int
    success: bool
    viol: float
    e_p: np.ndarray          # position error at k=1
    e_r: np.ndarray          # orientation error at k=1
    p_ref: np.ndarray        # reference pose at k=1
    p: np.ndarray            # actual pose
    q: np.ndarray            # joint configuration


class TelemetryRecorder:
    def __init__(self):
        self.ticks: List[MPCTickRecord] = []

    def record_tick(self, rec: MPCTickRecord):
        self.ticks.append(rec)

    def arrays(self) -> Dict[str, np.ndarray]:
        if not self.ticks:
            return {}
        out: Dict[str, np.ndarray] = {}
        for f in dataclasses.fields(MPCTickRecord):
            vals = [getattr(r, f.name) for r in self.ticks]
            out[f.name] = np.asarray(vals)
        return out

    def summary(self) -> Dict[str, float]:
        a = self.arrays()
        if not a:
            return {}
        return {
            "ticks": len(self.ticks),
            "fail_rate": float(1.0 - a["success"].mean()),
            "t_comp_mean": float(a["t_comp"].mean()),
            "t_comp_p99": float(np.percentile(a["t_comp"], 99)),
            "phi_final": float(a["phi"][-1]),
            "max_viol": float(a["viol"].max()),
        }

    def dump_json(self, path: str):
        """The summary of the records and the process's spans (name, start
        and end in ns, parent and own id)."""
        with open(path, "w") as f:
            json.dump(
                {"summary": self.summary(), "spans": [s.as_dict() for s in spans()]},
                f,
                indent=2,
                default=str,
            )


_SPANS: deque = deque(maxlen=SPAN_CAPACITY)
_LOCAL = threading.local()
_NEXT_ID = itertools.count(1)


class span:
    """``with span(name) as s:`` times the block on the profiler's clock;
    ``s.duration`` is its length in seconds once it has ended. ``parent``
    is the id of the span open around it on this thread (None at the top)."""

    __slots__ = ("name", "id", "parent", "start_ns", "end_ns", "_range")

    def __init__(self, name: str):
        self.name = name
        self.start_ns = self.end_ns = None
        self._range = None

    def __enter__(self) -> "span":
        stack = getattr(_LOCAL, "spans", None)
        if stack is None:
            stack = _LOCAL.spans = []
        self.id = next(_NEXT_ID)
        self.parent = stack[-1].id if stack else None
        stack.append(self)
        if torch._C._autograd._profiler_enabled():
            self._range = torch._C._profiler._RecordFunctionFast(self.name)
            self._range.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        _LOCAL.spans.pop()
        _SPANS.append(self)
        return False

    @property
    def duration(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def as_dict(self) -> dict:
        return {"name": self.name, "start_ns": self.start_ns, "end_ns": self.end_ns,
                "parent": self.parent, "id": self.id}


def spans() -> list:
    """The stored spans, oldest first by end (at most `SPAN_CAPACITY`)."""
    return list(_SPANS)


def clear() -> None:
    """Empty the span store."""
    _SPANS.clear()


def _launch_mark(phase: str, device: torch.device) -> None:
    """One launch of ``bp_phase_<phase>`` on ``device``'s current stream;
    nothing off the card."""
    if device.type != "cuda":
        return
    from .ops._build import check, library

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        check(library().bp_phase_mark(stream, PHASES.index(phase)), f"phase mark {phase}")


@contextlib.contextmanager
def device_tick(device: torch.device):
    """``with device_tick(device):`` marks ``tick`` where the block starts
    and opens the tick on this thread: `device_phase` marks its phases
    inside the block only."""
    outer = getattr(_LOCAL, "tick", False)
    _launch_mark("tick", device)
    _LOCAL.tick = True
    try:
        yield
    finally:
        _LOCAL.tick = outer


class device_phase:
    """Inside a `device_tick` on this thread, ``with device_phase(phase,
    device) as p:`` marks ``phase`` where the block starts and ``rest``
    (the tick's own work) where it ends; ``p.to(other)`` marks the next
    phase inside the block. Outside a tick it marks nothing."""

    __slots__ = ("phase", "device", "on")

    def __init__(self, phase: str, device: torch.device):
        self.phase, self.device = phase, device

    def __enter__(self) -> "device_phase":
        self.on = getattr(_LOCAL, "tick", False)
        self.to(self.phase)
        return self

    def to(self, phase: str) -> None:
        if self.on:
            _launch_mark(phase, self.device)

    def __exit__(self, *exc):
        self.to("rest")
        return False
