"""What ``failed`` and ``attempted`` count: solves that raised, came out
not finite, or were judged wrong by the reference; never a tick that
missed the violation bar while the reference misses it too."""

import math
import typing

import torch

from benchmark.drivers import fleet_rollout
from benchmark.reference import fleet as ref

LIMITS = {"start_q": 1e-3, "meas_pose": 1e-6}


def _records(bsz=3, ticks=4):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(bsz, ticks, 7, generator=g, dtype=torch.float64)
    return {"q": q, "phi": torch.rand(bsz, ticks, generator=g, dtype=torch.float64),
            "p": torch.zeros(bsz, ticks, 6, dtype=torch.float64),
            "success": torch.ones(bsz, ticks, dtype=torch.bool),
            "viol": torch.zeros(bsz, ticks, dtype=torch.float64)}


def _pose(q):
    return torch.cat([q[..., :3], q[..., 3:6]], dim=-1)


def _consistent(recs, q0):
    """Records whose measured poses are the pose function of the joint
    state of the tick before."""
    before = torch.cat([q0[:, None], recs["q"][:, :-1]], dim=1)
    recs["p"] = _pose(before)
    return recs


def test_missed_violation_bar_is_not_a_failure():
    q0 = torch.zeros(3, 7, dtype=torch.float64)
    prog = _consistent(_records(), q0)
    prog["viol"][1, 2] = 5e-3                      # misses the 1e-4 bar
    prog["success"][1, 2] = False
    ref_recs = {k: v.clone() for k, v in prog.items()}   # the reference agrees
    numbers, wrong = ref.compare(prog, ref_recs, q0, _pose, LIMITS)
    assert wrong.sum() == 0
    assert numbers["flag_mismatch"] == 0.0 and numbers["nonfinite"] == 0.0
    assert fleet_rollout.count_failed(prog) == 0


def test_non_finite_command_counts_one():
    q0 = torch.zeros(3, 7, dtype=torch.float64)
    prog = _consistent(_records(), q0)
    ref_recs = {k: v.clone() for k, v in prog.items()}
    prog["q"][2, 1, 4] = math.nan
    assert fleet_rollout.count_failed(prog) == 1
    numbers, wrong = ref.compare(prog, ref_recs, q0, _pose, LIMITS)
    assert numbers["nonfinite"] >= 1
    # the NaN solve, and the next tick, whose measured pose reads the NaN state
    assert wrong[2, 1] and wrong.sum() <= 2


def test_a_wrong_answer_counts_where_it_is_judged():
    q0 = torch.zeros(3, 7, dtype=torch.float64)
    prog = _consistent(_records(), q0)
    ref_recs = {k: v.clone() for k, v in prog.items()}
    prog["q"][0, 0, 0] += 1e-2                    # tick 0 of scene 0 is off
    prog = _consistent(prog, q0)
    numbers, wrong = ref.compare(prog, ref_recs, q0, _pose, LIMITS)
    assert numbers["start_q_gap_max"] > 0.99e-2
    assert wrong[0, 0] and wrong.sum() == 1
    prog["p"][1, 3, 0] += 1e-3                    # a measured pose the state does not give
    _, wrong = ref.compare(prog, ref_recs, q0, _pose, LIMITS)
    assert wrong[1, 3] and wrong.sum() == 2


def test_attempted_counts_every_rollout_started():
    class Session(fleet_rollout.FleetSession):
        def __init__(self):
            self.torch, self.ticks, self.index = torch, 4, [0, 1, 2]
            self.device = torch.device("cpu")
            self.dtype = torch.float64
            self.records, self.raised, self.calls = [], None, 0

        def _rollout(self):
            self.calls += 1
            recs = _records()
            if self.calls == 2:
                recs["viol"][0, 0] = math.inf
            return None, recs

    s = Session()
    w = s.window(0.05)
    assert w["attempted"] == 12 * s.calls and w["solves"] == w["attempted"]
    assert w["failed"] == (1 if s.calls >= 2 else 0)


class Path(typing.NamedTuple):
    p: torch.Tensor


class Carry(typing.NamedTuple):
    x: torch.Tensor
    path: Path


def test_arm_judges_every_drawn_period_and_handoff():
    """A drawn period that falls on a hand-off is judged as a period and as
    a hand-off; nothing drawn goes missing from a window that reaches it."""
    from benchmark.drivers import arm_shuttle

    class Session(arm_shuttle.ArmSession):
        def __init__(self, seed):
            self.ctx = {"seed": seed, "traffic": {"judged_within": 12, "judged_periods": 5,
                                                  "judged_handoffs": 2}}
            self.leg, self.torch, self.device = 3, torch, torch.device("cpu")
            self.pick_judged()
            carry = Carry(torch.zeros(2), Path(torch.ones(1)))
            self.log = []
            for k in range(20):
                e = {"k": k, "carry": carry} if k in self.judged_k else {"k": k}
                if k in self.judged_k and k % self.leg == 0:
                    e["handoff"] = {"carry_before": carry}
                self.log.append(e)

    for seed in range(40):
        s = Session(seed)
        drawn_p, drawn_h = set(s.judged_periods), set(s.judged_handoffs)
        s.release()
        assert {e["k"] for e in s.judged["periods"]} == drawn_p
        assert {e["k"] for e in s.judged["handoffs"]} == drawn_h
        assert all(k % 3 == 0 for k in drawn_h)
