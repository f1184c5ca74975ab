"""Driver ``fleet_rollout``: closed-loop rollouts of a fleet of cached
scenes through the port's ``parallel/batch.py::chunked_rollout``.

Traffic parameters: ``fleet_file`` (the cached fleet, relative to the
checkout), ``pool`` (scenes in it), ``scenes`` (drawn from the pool by the
seed, without replacement), ``chunk``, ``ticks`` (per rollout) and
``traced_ticks`` (of the traced rollout, after the window). Every
rollout starts from the drawn scenes' cached start. Set-up loads the
scenes, builds the model, and runs one warm rollout, which captures the
step graph. The window starts rollouts until ``--seconds`` have passed and
counts every rollout it started: ``attempted`` is its solves (scene-ticks).

After the window, one rollout drawn by the seed is held to the plain
reference (``reference/fleet.py``), which rolls out the same scenes from
the same cached start in float64, over the rollout's first
``reference_ticks`` ticks (the cell's limits file; all of them by
default).
"""

from __future__ import annotations

import os
import time

import numpy as np

from benchmark.harness import ROOT, mpc_params

def tmap(fn, tree):
    if isinstance(tree, dict):
        return {k: tmap(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tmap(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tmap(fn, v) for v in tree)
    return fn(tree)


def count_failed(recs) -> int:
    """The solves of a rollout whose command or next state is not finite
    (a tick over the violation bar is the solver's outcome, not a failed
    solve)."""
    import torch

    finite = (torch.isfinite(recs["q"]).all(-1) & torch.isfinite(recs["phi"])
              & torch.isfinite(recs["viol"]))
    return int((~finite).sum())


def draw(seed: int, pool: int, scenes: int) -> np.ndarray:
    """The scenes of a run: ``scenes`` of ``pool`` without replacement, in
    index order."""
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(pool, size=scenes, replace=False))


def setup(ctx):
    return FleetSession(ctx)


class FleetSession:
    def __init__(self, ctx):
        import torch
        from boundplanner_tpu_torch import config as prog_config
        from boundplanner_tpu_torch.mpc.bound_mpc import FleetMPC
        from boundplanner_tpu_torch.parallel import batch, fleet_cache

        t_imported = time.perf_counter()
        self.ctx, self.torch = ctx, torch
        tr, conf = ctx["traffic"], ctx["config"]
        self.device = ctx["device"]
        self.dtype = getattr(torch, conf["dtype"])
        self.ticks, self.chunk = int(tr["ticks"]), int(tr["chunk"])
        self.index = draw(ctx["seed"], int(tr["pool"]), int(tr["scenes"]))
        self.fleet_path = os.path.join(ROOT, tr["fleet_file"])
        self.cfg = mpc_params(prog_config, conf)
        self.rollout_fn = batch.chunked_rollout
        carry, q0, obs = fleet_cache.load_fleet(self.fleet_path, device=self.device,
                                                dtype=self.dtype)
        idx = torch.as_tensor(self.index, device=self.device)
        self.inputs = tmap(lambda t: t[idx], (carry, q0, obs))
        t_loaded = time.perf_counter()
        self.model = FleetMPC(self.cfg, device=self.device, dtype=self.dtype)
        t_model = time.perf_counter()
        self._rollout()                      # warm: builds, captures, runs once
        self._sync()
        t_warm = time.perf_counter()
        self.setup_parts = {"imports_s": t_imported - ctx["t0"], "load_s": t_loaded - t_imported,
                            "model_s": t_model - t_loaded, "warm_rollout_s": t_warm - t_model,
                            "graph_capture_s": self.capture_s()}
        self.records, self.raised = [], None

    def _sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def _rollout(self):
        carry, q0, obs = self.inputs
        return self.rollout_fn(carry, q0, obs, self.model, self.ticks, chunk=self.chunk)

    def capture_s(self) -> float:
        return float(sum(g.capture_s or 0.0 for g in self.model.graphs.values()))

    def window(self, seconds: float) -> dict:
        torch = self.torch
        solves = self.ticks * len(self.index)
        attempted = failed = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            attempted += solves
            try:
                _, recs = self._rollout()
            except RuntimeError as err:            # a call that raised
                failed += solves
                self.raised = repr(err)
                break
            failed += count_failed(recs)
            self.records.append(recs)
        self._sync()
        window_s = time.perf_counter() - t0
        rollouts = len(self.records)
        success = torch.cat([r["success"] for r in self.records]) if rollouts else None
        viol = torch.cat([r["viol"] for r in self.records]) if rollouts else None
        outcome = {"raised": self.raised} if self.raised else {}
        if rollouts:
            outcome |= {"rollouts": rollouts, "success_share": float(success.float().mean()),
                       "max_viol": float(viol.max()),
                       "mean_phi_final": float(self.records[-1]["phi"][:, -1].mean()),
                       "success_bar": 1e-4}
        self.window_info = {"attempted": attempted, "failed": failed, "window_s": window_s,
                            "solves": rollouts * solves, "ticks": rollouts * self.ticks,
                            "scenes": len(self.index), "outcome": outcome,
                            "dtype": str(self.dtype).split(".")[-1]}
        return self.window_info

    def traced(self, tracer) -> dict:
        """One more rollout under the profiler, after the window, of
        ``traced_ticks`` ticks (the traffic's; its ``ticks`` by default)."""
        ticks = int(self.ctx["traffic"].get("traced_ticks", self.ticks))
        carry, q0, obs = self.inputs
        out = tracer(lambda: self.rollout_fn(carry, q0, obs, self.model, ticks, chunk=self.chunk))
        out.pop("result")
        out["ticks"] = ticks
        out["scenes"] = len(self.index)
        return out

    def counters(self) -> dict:
        return {"graph_capture_s": self.capture_s(),
                "graphs": len(self.model.graphs)}

    def release(self):
        """Keep the judged rollout's records on the host; free the rest."""
        rng = np.random.default_rng([self.ctx["seed"], 1])
        self.judged = None
        if self.records:
            k = int(rng.integers(len(self.records)))
            self.judged = (k, tmap(lambda t: t.detach().cpu(), self.records[k]))
        self.q0 = self.inputs[1].detach().cpu()
        self.records = self.inputs = None
        self.model = None
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    def judge(self, limits: dict) -> dict:
        from benchmark.reference import fleet as ref
        from benchmark.reference.bmpc import config as ref_config

        torch = self.torch
        if self.judged is None:
            return {"numbers": {}, "compared": {"rollouts_judged": (1.0, 0.0)}, "failed": 0}
        conf = self.ctx["config"]
        rdtype = torch.float64
        t0 = time.perf_counter()
        model = ref.RefFleet(mpc_params(ref_config, conf), self.device, rdtype, conf["link_route"])
        carry, q0, obs = ref.load_scenes(self.fleet_path, self.index, self.device, rdtype)
        ticks = min(int(limits.get("reference_ticks", self.ticks)), self.ticks)
        _, recs = model.rollout(carry, q0, obs, ticks)
        judged = {k: v[:, :ticks] for k, v in self.judged[1].items()}
        numbers, wrong = ref.compare(judged, tmap(lambda t: t.cpu(), recs), self.q0,
                                     lambda q: model.pose(q.to(self.device, rdtype)),
                                     limits["wrong_at"])
        numbers["judged_rollout"] = self.judged[0]
        numbers["reference_s"] = time.perf_counter() - t0
        compared = {k: (numbers[k], float(v)) for k, v in limits["compare"].items()}
        return {"numbers": numbers, "compared": compared, "failed": int(wrong.sum())}
