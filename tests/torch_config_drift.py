"""How far the port's solver configurations drift from the JAX package's
on the CPU in float64, and the rounding band they are held to.

    JAX_PLATFORMS=cpu python tests/torch_config_drift.py [--escalated-only]

(~6 min; ~2 min for the escalated tick alone.)

Prints, as JSON lines:

- ``tick``: for each configuration of the tick-level tests
  (``test_torch_solver_configs*.py``), one tick of
  ``.fleet_cache/test8.pkl`` scenes 0-1 in both packages and the largest
  difference of any output or carry leaf relative to that leaf's largest
  entry (at least 1);
- ``escalated``: the real escalated tick of ``test_torch_escalation.py``
  (scenes 0-2, 0.3 rad off the start, 1 x 2 iterations, ``esc_lanes=2``):
  ``x_prev`` per lane from the port, from JAX, and from each package with a
  second exact factorization (JAX: ``jnp.linalg.cholesky`` and a
  triangular solve in place of its masked Cholesky and row-loop inverse;
  the port: ``torch.linalg.cholesky`` and a triangular solve in place of
  kernel A's plain version), their differences, and the merit at each
  solution.
"""

import dataclasses
import json
import os
import sys

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_enable_x64", True)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from boundplanner_tpu.ops import qp as jqp  # noqa: E402
from boundplanner_tpu.parallel import batch as jbatch  # noqa: E402
from boundplanner_tpu_torch.mpc import ocp as tocp  # noqa: E402
from boundplanner_tpu_torch.mpc.bound_mpc import FleetMPC, build_tick_params  # noqa: E402
from boundplanner_tpu_torch.ops import qp as tqp  # noqa: E402
from boundplanner_tpu_torch.parallel import batch as tbatch  # noqa: E402
from boundplanner_tpu_torch.parallel.fleet_cache import to_numpy, to_torch  # noqa: E402
from torch_tick_parity import configs, fleet_scenes, jax_inputs, leaves  # noqa: E402

TICK_CONFIGS = {
    "chunked": dict(struct_chunked=True),
    "link": dict(struct_link=True),
    "dense_tail": dict(struct_tail=False),
    "admm": dict(struct_ocp=False, qp_solver="admm"),
    "admm_dense_tail": dict(struct_tail=False, qp_solver="admm"),
    "kkt2": dict(kkt_every=2),
    "qp_warm_dual": dict(qp_warm_dual=True),
    "warm_sz": dict(qp_warm_dual=True, qp_warm_sz=True),
}


def rel_diff(got, ref):
    """Largest leaf difference relative to the leaf's largest entry."""
    worst = 0.0
    for g, r in zip(leaves(got), [np.asarray(x) for x in jax.tree.leaves(ref)]):
        g, r = g.astype(float), r.astype(float)
        worst = max(worst, float(np.abs(g - r).max()) / max(1.0, float(np.abs(r).max())))
    return worst


def tick_drift(name, fields):
    scenes = fleet_scenes(2)
    jcfg, tcfg = configs(**fields)
    jcarry, jobs = jax_inputs(scenes)
    q0 = scenes[1]
    z = np.zeros_like(q0)
    jmeas = jax.vmap(lambda *a: jbatch._plant_measurement(*a, jnp.float64))(q0, z, z, z, q0)
    jc, jo = jax.tree.map(np.asarray, jbatch.batched_mpc_tick(jcarry, jmeas, jobs, jcfg))
    carry, _, obs = to_torch(scenes, "cpu", torch.float64)
    meas = to_torch(jax.tree.map(np.asarray, jmeas), "cpu", torch.float64)
    model = FleetMPC(tcfg, device="cpu", dtype=torch.float64)
    tc, to = to_numpy(tbatch.batched_mpc_tick(carry, meas, obs, model))
    return {"tick": name, "outputs": max(rel_diff(to[k], jo[k]) for k in jo),
            "carry": rel_diff(tc, jc)}


def escalated_band():
    carry, q0, obs = fleet_scenes(3)
    q0 = q0 + 0.3 * np.random.default_rng(4).normal(size=q0.shape)
    jcfg, tcfg = configs(sqp_iters=1, qp_iters=2, esc_lanes=2)
    jcarry, jobs = jax_inputs((carry, q0, obs))
    inputs = to_torch((carry, q0, obs), "cpu", torch.float64)

    def jax_run():
        return np.asarray(jbatch.fleet_rollout(jcarry, jnp.asarray(q0), jobs, jcfg, 1)[0].x_prev)

    def port_run():
        model = FleetMPC(tcfg, device="cpu", dtype=torch.float64)
        return to_numpy(tbatch.fleet_rollout(*inputs, model, 1)[0]).x_prev

    x = {"jax": jax_run(), "port": port_run()}
    # both of JAX's factorization routes (`pallas_kkt` picks one)
    real_j = jqp.cholesky_masked, jqp.invert_lower, jqp.kkt_inverse
    lower_inv = lambda l: jax.scipy.linalg.solve_triangular(
        l, jnp.eye(l.shape[-1], dtype=l.dtype), lower=True)
    jqp.cholesky_masked, jqp.invert_lower = jnp.linalg.cholesky, lower_inv
    jqp.kkt_inverse = lambda k: lower_inv(jnp.linalg.cholesky(k))
    jax.clear_caches()
    try:
        x["jax_alt"] = jax_run()
    finally:
        jqp.cholesky_masked, jqp.invert_lower, jqp.kkt_inverse = real_j
        jax.clear_caches()
    real_t = tqp.kkt_inverse
    tqp.kkt_inverse = lambda k: torch.linalg.solve_triangular(
        torch.linalg.cholesky(k), torch.eye(k.shape[-1], dtype=k.dtype).expand_as(k),
        upper=False)
    try:
        x["port_alt"] = port_run()
    finally:
        tqp.kkt_inverse = real_t

    # the merit of each solution on the pre-tick state, at the retry's budget
    esc_cfg = dataclasses.replace(tcfg, sqp_iters=tcfg.esc_sqp_iters,
                                  qp_iters=tcfg.esc_qp_iters, esc_lanes=0)
    model = FleetMPC(esc_cfg, device="cpu", dtype=torch.float64)
    c, q, o = inputs
    zq = torch.zeros_like(q)
    params = build_tick_params(c, tbatch._plant_measurement(q, zq, zq, zq, q, model.st.chain),
                               o, esc_cfg, model.st)[0]

    def merit(lane, xv):
        r, g = tocp.evaluate(torch.from_numpy(np.array(xv)),
                             {k: v[lane] for k, v in params.items()}, esc_cfg, model.st)
        return float(torch.sum(r * r) + esc_cfg.merit_penalty * torch.clamp(g, min=0).sum())

    pairs = (("port", "jax"), ("jax_alt", "jax"), ("port_alt", "port"))
    return {"escalated": "x_prev",
            "max_abs_diff_per_lane": {f"{a}-{b}": np.abs(x[a] - x[b]).max(axis=1).tolist()
                                      for a, b in pairs},
            "max_abs_x_prev": float(np.abs(x["jax"]).max()),
            "merit_per_lane": {k: [merit(lane, v[lane]) for lane in (0, 1)]
                               for k, v in x.items()}}


def main():
    torch.set_num_threads(1)
    for name, fields in ({} if "--escalated-only" in sys.argv else TICK_CONFIGS).items():
        print(json.dumps(tick_drift(name, fields)), flush=True)
    print(json.dumps(escalated_band()), flush=True)


if __name__ == "__main__":
    main()
