"""External-solver anchor for the port's condensed BoundMPC OCP (the
counterpart of ``tests/test_external_anchor.py::test_cold_start_tick_matches_slsqp``).

The port's Gauss-Newton SQP (``mpc.solver.solve_sqp``, the default
``MPCParams()``: 12 SQP x 25 IPM iterations, dense QP, float64 on the CPU)
is held against scipy's SLSQP, a float64 SQP independent of both packages,
on the EXACT same NLP: the port's ``ocp.cost`` and ``ocp.constraints`` of
the demo scene's first tick (full horizon N = 15, 2439 inequality rows),
with the port's own Jacobians (``ocp_jac.evaluate_with_jac``) as SLSQP's
derivatives and the same cold start. Both must be feasible, the port must
not converge to a worse point, and the trajectories and optimal values
must agree, with the JAX test's tolerances.
"""

import numpy as np
import torch
from scipy.optimize import minimize

from boundplanner_tpu_torch.config import MPCParams
from boundplanner_tpu_torch.demo import demo_scene
from boundplanner_tpu_torch.mpc import ocp, ocp_jac
from boundplanner_tpu_torch.mpc.bound_mpc import FleetMPC, build_tick_params
from boundplanner_tpu_torch.mpc.solver import solve_sqp
from boundplanner_tpu_torch.utils.tree import to_torch, tree_map

torch.set_num_threads(1)
CFG = MPCParams()


def first_tick_params():
    """The demo scene's first-tick OCP parameters (one scene) and the
    model's static structure."""
    carry, meas, obs, _ = demo_scene(CFG, dtype=np.float64)
    model = FleetMPC(CFG, device="cpu", dtype=torch.float64)
    batch = to_torch(tree_map(lambda a: np.asarray(a)[None], (carry, meas, obs)), "cpu",
                     torch.float64)
    params_b = build_tick_params(*batch, CFG, model.st)[0]
    return params_b, tree_map(lambda t: t[0], params_b), model.st


def slsqp(params, st, x0):
    """SLSQP on the port's NLP (cost = |r|^2, constraints g <= 0)."""
    memo = {}

    def at(x):
        # SLSQP asks for the values and the Jacobians at the same points:
        # evaluate once per point
        key = np.asarray(x, np.float64).tobytes()
        if key not in memo:
            memo.clear()
            out = ocp_jac.evaluate_with_jac(torch.from_numpy(np.asarray(x, np.float64)),
                                            params, CFG, st)
            memo[key] = tuple(t.numpy() for t in out)
        return memo[key]

    res = minimize(
        lambda x: float(np.sum(at(x)[0] ** 2)),
        x0,
        jac=lambda x: 2.0 * at(x)[2].T @ at(x)[0],
        constraints=[{"type": "ineq", "fun": lambda x: -at(x)[1],
                      "jac": lambda x: -at(x)[3]}],
        method="SLSQP",
        options={"maxiter": 400, "ftol": 1e-10},
    )
    assert res.status == 0, (res.status, res.message)
    return res


def test_cold_start_tick_matches_slsqp():
    params_b, params, st = first_tick_params()
    x0 = np.zeros(ocp.n_vars(CFG.n))
    ours = solve_sqp(torch.zeros(1, x0.size, dtype=torch.float64), params_b, CFG, st)
    assert bool(ours.success[0])
    res = slsqp(params, st, x0)
    x_o, x_r = ours.x[0], torch.from_numpy(res.x)

    viol_o = float(ocp.constraints(x_o, params, CFG, st).max())
    viol_r = float(ocp.constraints(x_r, params, CFG, st).max())
    assert viol_o < 1e-5, viol_o
    assert viol_r < 1e-5, viol_r

    c_o = float(ocp.cost(x_o, params, CFG, st))
    c_r = float(ocp.cost(x_r, params, CFG, st))
    # the port's SQP must not converge to a worse point than the
    # independent solver (marginally better is fine)
    assert c_o <= c_r * 1.001 + 1e-8, (c_o, c_r)

    tr_o = ocp.rollout(x_o, params, CFG, st)
    tr_r = ocp.rollout(x_r, params, CFG, st)
    np.testing.assert_allclose(tr_o["q"].numpy(), tr_r["q"].numpy(), atol=1e-3, rtol=0)
    np.testing.assert_allclose(tr_o["p"][:, :3].numpy(), tr_r["p"][:, :3].numpy(), atol=5e-4,
                               rtol=0)
    # the two independent solvers agree on the optimal value itself
    np.testing.assert_allclose(c_o, c_r, rtol=1e-5)
