"""Structured telemetry — the engine's observability surface (the port's
copy of ``boundplanner_tpu/telemetry.py``: pure Python and numpy,
unchanged).

Mirrors the field set of the reference's ROS telemetry message
(`boundmpcmsg/msg/MPCData.msg`: timings t_comp/t_loop/t_overhead, cost,
iterations, errors, references, sets) without the ROS dependency: records
are plain dataclasses accumulated by a recorder, exportable as dict-of-
arrays (for plotting/regression) or streamed to an optional ROS 2 adapter
(`ros_compat`). Phase timing mirrors the planner's accumulators
(`BoundPlanner.py:40-46,154-172`).
"""

from __future__ import annotations

import dataclasses
import json
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional

import numpy as np


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
        self.events: List[Dict[str, Any]] = []

    def record_tick(self, rec: MPCTickRecord):
        self.ticks.append(rec)

    def record_event(self, kind: str, **data):
        self.events.append({"kind": kind, "t_wall": time.time(), **data})

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
        with open(path, "w") as f:
            json.dump(
                {"summary": self.summary(), "events": self.events},
                f,
                indent=2,
                default=str,
            )


class PhaseTimer:
    """Named phase accumulators (ref `BoundPlanner.print_computation_time`,
    `BoundPlanner.py:154-172`)."""

    def __init__(self):
        self.acc = defaultdict(float)
        self.counts = defaultdict(int)

    def add(self, name: str, seconds: float):
        self.acc[name] += seconds
        self.counts[name] += 1

    class _Ctx:
        def __init__(self, timer, name):
            self.timer, self.name = timer, name

        def __enter__(self):
            self.t0 = time.perf_counter()

        def __exit__(self, *exc):
            self.timer.add(self.name, time.perf_counter() - self.t0)

    def phase(self, name: str):
        return self._Ctx(self, name)

    def report(self) -> str:
        lines = [
            f"  {k}: {v:.4f}s ({self.counts[k]}x)"
            for k, v in sorted(self.acc.items(), key=lambda kv: -kv[1])
        ]
        return "\n".join(lines)
