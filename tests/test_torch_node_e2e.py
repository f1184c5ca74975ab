"""The default float64 closed loop near active rows, port against JAX.

The tests/test_e2e.py scene (a floor and a pillar between the demo pose
and the goal) is planned once by the port in float64 on the CPU
(`mpc/e2e.py::plan_e2e`); JAX's ``MPCNode`` and the port's, both with the
default ``MPCParams()`` (12 SQP x 25 dense IPM iterations on 2439 rows),
run 3 ticks on that one plan. Near active obstacle and set rows the dense
IPM amplifies float64 rounding about 1e3-fold a tick: two exact float64
factorizations on the CPU (``python -m boundplanner_tpu_torch.mpc.e2e
--device cpu``, kernel A's plain version against ``cholesky_ex`` +
``solve_triangular``) drift apart in dq by the BAND below (q and the pose
by less). q, dq and the measured pose of the port may drift from JAX's by
no more than that band: more is a port fault.

Each side's final IPM residuals per tick (primal, dual, gap of the last
QP of the tick) are recorded and printed in the comparison's message.
"""

import numpy as np
import pytest

import jax
import torch

import boundplanner_tpu.ops.sqp as jsqp
from boundplanner_tpu.config import MPCParams
from boundplanner_tpu.mpc import bound_mpc as jbound_mpc
from boundplanner_tpu.mpc import solver as jsolver
from boundplanner_tpu.mpc.node import MPCNode as JNode
import boundplanner_tpu_torch.ops.sqp as tsqp
from boundplanner_tpu_torch.mpc import MPCNode
from boundplanner_tpu_torch.mpc.e2e import plan_e2e

torch.set_num_threads(1)
TICKS = 3
# dq's spread between two exact float64 factorizations on the CPU, ticks
# 1..3 (`python -m boundplanner_tpu_torch.mpc.e2e --device cpu`: dq 3.0e-9,
# 8.0e-7, 4.1e-6; q 7.5e-11, 2.0e-8, 2.6e-7; p_lie 2.0e-11, 1.2e-8, 1.4e-7)
BAND = (3.0e-9, 8.0e-7, 4.1e-6)


def _record_jax(log):
    """A ``solve_qp`` that reports each QP's final residuals to ``log``."""
    solve = jsqp.solve_qp

    def wrapped(*args, **kwargs):
        sol = solve(*args, **kwargs)
        jax.debug.callback(lambda r_p, r_d, gap: log.append(
            (float(r_p), float(r_d), float(gap))), sol.r_p, sol.r_d, sol.gap, ordered=True)
        return sol

    return wrapped


def _record_port(log):
    solve = tsqp.solve_qp

    def wrapped(*args, **kwargs):
        sol = solve(*args, **kwargs)
        log.append((float(sol.r_p.max()), float(sol.r_d.max()), float(sol.gap.max())))
        return sol

    return wrapped


@pytest.fixture(scope="module")
def runs():
    plan = plan_e2e("cpu")
    q0, args = plan[0], plan[1]
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for name in ("jax", "port"):
            log = []
            if name == "jax":
                # a fresh trace, so the recording wrapper is in it and
                # leaves no trace behind for other tests
                jbound_mpc.mpc_tick.clear_cache()
                jsolver.solve_sqp.clear_cache()
                mp.setattr(jsqp, "solve_qp", _record_jax(log))
                node = JNode(q0, MPCParams())
            else:
                mp.setattr(tsqp, "solve_qp", _record_port(log))
                node = MPCNode(q0, device="cpu")
            node.update_reference(*args)
            ticks = []
            for _ in range(TICKS):
                start = len(log)
                node.step()
                if name == "jax":
                    jax.effects_barrier()
                ticks.append({"q": node.q.copy(), "dq": node.dq.copy(),
                              "p_lie": np.array(node.p_lie), "qps": len(log) - start,
                              "residual": log[-1]})
            out[name] = (ticks, list(node.fails))
    finally:
        mp.undo()
        jbound_mpc.mpc_tick.clear_cache()
        jsolver.solve_sqp.clear_cache()
    return out


@pytest.mark.parametrize("tick", range(TICKS), ids=[f"tick{i + 1}" for i in range(TICKS)])
def test_drift_within_the_rounding_band(runs, tick):
    j, t = runs["jax"][0][tick], runs["port"][0][tick]
    msg = (f"tick {tick + 1}: final IPM residuals (r_p, r_d, gap) jax {j['residual']} "
           f"port {t['residual']}")
    print(msg)
    assert j["qps"] == t["qps"] == MPCParams().sqp_iters, msg
    for key in ("q", "dq", "p_lie"):
        err = float(np.abs(t[key] - j[key]).max())
        assert err <= BAND[tick], f"{key}: {err:.3g} > {BAND[tick]:.3g}; {msg}"
    assert all(np.isfinite(v) for v in j["residual"] + t["residual"]), msg


def test_same_outcomes(runs):
    assert runs["port"][1] == runs["jax"][1] == [0.0] * TICKS
