"""Driver ``arm_shuttle``: one arm's control loop, the port's
``mpc/node.py::MPCNode``, shuttling between the two ends of a frozen plan.

Traffic parameters: ``plans_file`` (the frozen plans, relative to the
checkout), ``plan_seeds`` (the seed picks plan ``seed mod plan_seeds``),
``leg_periods`` (control periods per leg), ``warm_periods`` (periods of
each direction in set-up), ``judged_periods`` and ``judged_handoffs``
(drawn by the seed among the first ``judged_within`` periods, held to the
reference) and ``traced_periods``.

A leg is ``leg_periods`` calls of ``MPCNode.step``; then the other
direction's plan is handed over through ``update_reference``. A hand-off
with the same configuration keeps the model and its graphs, so set-up's
periods in both directions capture every graph the window replays. The
window runs periods until ``--seconds`` have passed and counts every
period it started; a period's time includes the hand-off before it.
"""

from __future__ import annotations

import os
import time

import numpy as np

from benchmark.harness import ROOT, load_json, mpc_params

DIRECTIONS = ("out", "back")


def setup(ctx):
    return ArmSession(ctx)


def to_device(tree, device, dtype=None):
    """A (nested) carry's tensors on ``device``, floating leaves in
    ``dtype`` where given."""
    if isinstance(tree, tuple):
        return type(tree)(*(to_device(x, device, dtype) for x in tree))
    if dtype is not None and tree.is_floating_point():
        return tree.to(device=device, dtype=dtype)
    return tree.to(device)


def _state(node) -> dict:
    return {k: np.array(getattr(node, k), dtype=np.float64)
            for k in ("q", "dq", "ddq", "jerk", "qf", "p_lie", "v")}


class ArmSession:
    def __init__(self, ctx):
        import torch
        from boundplanner_tpu_torch import config as prog_config
        from boundplanner_tpu_torch.mpc.node import MPCNode

        t_imported = time.perf_counter()
        self.ctx, self.torch = ctx, torch
        tr, conf = ctx["traffic"], ctx["config"]
        self.device = ctx["device"]
        self.dtype = getattr(torch, conf["dtype"])
        plans = load_json(os.path.join(ROOT, tr["plans_file"]))
        self.plan_seed = str(ctx["seed"] % int(tr["plan_seeds"]))
        self.plans = plans["plans"][self.plan_seed]
        self.leg = int(tr["leg_periods"])
        self.cfg = mpc_params(prog_config, conf)
        from benchmark.reference.arm import plan_args

        self.args = {d: plan_args(self.plans[d]) for d in DIRECTIONS}
        t_loaded = time.perf_counter()
        self.node = MPCNode(np.asarray(plans["q0"]), params=self.cfg, device=self.device,
                            dtype=self.dtype)
        t_node = time.perf_counter()
        for d in DIRECTIONS:               # warm: both directions' shapes
            self.node.update_reference(*self.args[d])
            for _ in range(int(tr["warm_periods"])):
                self.node.step()
        t_warm = time.perf_counter()
        self.setup_parts = {"imports_s": t_imported - ctx["t0"], "load_s": t_loaded - t_imported,
                            "node_s": t_node - t_loaded, "warm_periods_s": t_warm - t_node,
                            "graph_capture_s": self.capture_s()}
        self.log, self.raised = [], None
        self.first_tick = len(self.node.telemetry.ticks)
        self.pick_judged()

    def pick_judged(self):
        """The periods and hand-offs held to the reference, drawn by the
        seed before the window among the first ``judged_within`` periods,
        which every window reaches: only those keep a copy of their state."""
        tr = self.ctx["traffic"]
        rng = np.random.default_rng([self.ctx["seed"], 2])
        within = int(tr["judged_within"])
        self.judged_periods = set(rng.choice(within, size=int(tr["judged_periods"]),
                                             replace=False).tolist())
        self.judged_handoffs = set(rng.choice(range(0, within, self.leg),
                                              size=int(tr["judged_handoffs"]),
                                              replace=False).tolist())
        self.judged_k = self.judged_periods | self.judged_handoffs

    def capture_s(self) -> float:
        return float(sum(g.capture_s or 0.0 for g in self.node.mpc.model.graphs.values()))

    def _period(self, k: int) -> dict:
        """Period ``k`` of the window: a hand-off first where a leg starts.
        A judged period also keeps the state before and after it, and the
        tick's carry before it (and before the hand-off)."""
        node = self.node
        keep = k in self.judged_k
        entry = {"k": k, "direction": DIRECTIONS[(k // self.leg) % 2]}
        t0 = time.perf_counter()
        if k % self.leg == 0:
            if keep:
                entry["handoff"] = {"before": _state(node),
                                    "carry_before": self._clone(node.mpc.carry)}
            node.update_reference(*self.args[entry["direction"]])
        if keep:
            entry["before"] = _state(node)
            entry["carry"] = self._clone(node.mpc.carry)
        node.step()
        entry["seconds"] = time.perf_counter() - t0
        entry["finite"] = all(np.isfinite(getattr(node, f)).all()
                              for f in ("q", "dq", "ddq", "p_lie"))
        entry["fail"] = bool(node.fails[-1])
        if keep:
            entry["after"] = _state(node)
        return entry

    def _clone(self, x):
        if isinstance(x, tuple):
            return type(x)(*(self._clone(v) for v in x))
        return x.clone()

    def window(self, seconds: float) -> dict:
        attempted = failed = 0
        t0 = time.perf_counter()
        k = 0
        while time.perf_counter() - t0 < seconds:
            attempted += 1
            try:
                entry = self._period(k)
            except RuntimeError as err:            # a call that raised
                failed += 1
                self.raised = repr(err)
                break
            failed += int(not entry["finite"])
            self.log.append(entry)
            k += 1
        window_s = time.perf_counter() - t0
        periods = np.array([e["seconds"] for e in self.log])
        ticks = self.node.telemetry.ticks[self.first_tick:]
        outcome = {"raised": self.raised} if self.raised else {}
        if ticks:
            # the path parameter at the end of each leg the window completed
            leg_ends = [t.phi for t, e in zip(ticks, self.log) if (e["k"] + 1) % self.leg == 0]
            outcome |= {"periods": len(ticks),
                       "legs": len({e["k"] // self.leg for e in self.log}),
                       "success_share": float(np.mean([t.success for t in ticks])),
                       "fail_share": float(np.mean([e["fail"] for e in self.log])),
                       "max_viol": float(max(t.viol for t in ticks)),
                       "mean_phi_final": float(np.mean(leg_ends or [ticks[-1].phi])),
                       "plan_seed": int(self.plan_seed),
                       "period_ms_p50_p90_p99_max": [1e3 * float(np.percentile(periods, q))
                                                     for q in (50, 90, 99, 100)],
                       "handoff_period_ms": [1e3 * e["seconds"] for e in self.log
                                             if e["k"] % self.leg == 0]}
        self.window_info = {
            "attempted": attempted, "failed": failed, "window_s": window_s,
            "periods": len(self.log), "period_s": periods.tolist(),
            "node_host_s": [t.t_loop - t.t_comp for t in ticks],
            "outcome": outcome, "dtype": str(self.dtype).split(".")[-1]}
        return self.window_info

    def traced(self, tracer) -> dict:
        """``traced_periods`` more periods under the profiler, after the
        window (continuing the shuttle)."""
        n = int(self.ctx["traffic"]["traced_periods"])
        k0 = len(self.log)
        out = tracer(lambda: [self._period(k0 + i) for i in range(n)])
        out.pop("result")
        out["ticks"] = n
        out["scenes"] = 1
        return out

    def counters(self) -> dict:
        return {"graph_capture_s": self.capture_s(),
                "graphs": len(self.node.mpc.model.graphs)}

    def release(self):
        """Keep the judged periods and hand-offs, their carries on the host;
        free the node."""
        cpu = lambda tree: type(tree)(*(cpu(x) if isinstance(x, tuple) else x.cpu()
                                        for x in tree))
        kept = {}
        for e in self.log:
            if e["k"] in self.judged_k:
                e = dict(e, carry=cpu(e["carry"]))
                if "handoff" in e:
                    e["handoff"] = {**e["handoff"],
                                    "carry_before": cpu(e["handoff"]["carry_before"])}
                kept[e["k"]] = e
        self.judged = {"periods": [kept[k] for k in sorted(self.judged_periods) if k in kept],
                       "handoffs": [kept[k] for k in sorted(self.judged_handoffs) if k in kept]}
        self.log = None
        self.node = None
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    def judge(self, limits: dict) -> dict:
        from benchmark.reference import arm as ref
        from benchmark.reference.bmpc import config as ref_config

        torch = self.torch
        conf = self.ctx["config"]
        rdtype = torch.float64
        t0 = time.perf_counter()
        model = ref.RefArm(mpc_params(ref_config, conf), self.device, rdtype, conf["link_route"])
        obs = {d: model.obstacles(self.plans[d]) for d in DIRECTIONS}
        to_dev = lambda tree: to_device(tree, self.device, rdtype)
        q_gap = dq_gap = p_gap = 0.0
        fail_mismatch = 0
        wrong = 0
        w = limits["wrong_at"]
        for e in self.judged["periods"]:
            out = model.period(e["before"], to_dev(e["carry"]), obs[e["direction"]])
            gq = float(np.abs(out["q"] - e["after"]["q"]).max())
            gdq = float(np.abs(out["dq"] - e["after"]["dq"]).max())
            gp = float(np.abs(out["p"] - e["after"]["p_lie"]).max())
            clear = out["viol"] < 1e-5 or out["viol"] > 1e-3
            mismatch = int(clear and out["fail"] != e["fail"])
            q_gap, dq_gap, p_gap = max(q_gap, gq), max(dq_gap, gdq), max(p_gap, gp)
            fail_mismatch += mismatch
            wrong += int(gq > w["q"] or gdq > w["dq"] or gp > w["pose"] or mismatch
                         or not np.isfinite([gq, gdq, gp]).all())
        h_gap = 0.0
        for e in self.judged["handoffs"]:
            h = e["handoff"]
            carry = model.handoff(self.plans[e["direction"]], h["before"]["p_lie"],
                                  h["before"]["v"], to_dev(h["carry_before"]))
            g = ref.carry_gap(carry, e["carry"])
            h_gap = max(h_gap, g)
            wrong += int(not g <= w["handoff"])
        short = (len(self.judged_periods) + len(self.judged_handoffs)
                 - len(self.judged["periods"]) - len(self.judged["handoffs"]))
        numbers = {"judged_short": float(short),
                   "period_q_gap_max": q_gap, "period_dq_gap_max": dq_gap,
                   "period_pose_gap_max": p_gap, "fail_mismatch": float(fail_mismatch),
                   "handoff_carry_gap_max": h_gap,
                   "judged_periods": len(self.judged["periods"]),
                   "judged_handoffs": len(self.judged["handoffs"]),
                   "reference_s": time.perf_counter() - t0}
        compared = {k: (numbers[k], float(v)) for k, v in limits["compare"].items()}
        return {"numbers": numbers, "compared": compared, "failed": wrong}
