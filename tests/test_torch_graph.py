"""The graph route of the fused tick on the CPU (`mpc.graph.Graph`,
`FleetMPC(graph=...)`).

On the card ``FleetMPC.tick`` replays one CUDA graph per configuration
and input signature. What the CPU can hold of it:

- (a) capture safety: one tick of each configuration runs under
  ``torch_host_guard.host_guard``, which raises on any host data or host
  read inside the tick (a captured graph would bake the one in and cannot
  do the other);
- (b) the graph's body, run eagerly, equals the eager route bit for bit
  over a 3-tick ``fleet_rollout``, also with the escalation retry: the
  rollout's step graph (`parallel.batch._rollout_step`, one per
  configuration, escalation and signature) holds the tick and the retry;
- (c) that body in float64 against the JAX package's jitted
  ``fleet_rollout`` (3 ticks) at ``test_torch_slice.py``'s tolerances;
- (d) the CPU default is eager, and ``graph=True`` on the CPU raises.

Scenes: ``.fleet_cache/test8.pkl`` scenes 0-1 (scene 0 alone at batch 1
for the default ``MPCParams()``).
"""

import dataclasses
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from boundplanner_tpu.config import perf_mpc_params
from boundplanner_tpu.mpc import bound_mpc as jmpc
from boundplanner_tpu.parallel.batch import fleet_rollout as jax_fleet_rollout
from boundplanner_tpu_torch import config as tconfig
from boundplanner_tpu_torch.mpc.bound_mpc import FleetMPC
from boundplanner_tpu_torch.parallel import batch as tbatch
from boundplanner_tpu_torch.parallel.fleet_cache import load, to_numpy, to_torch, tree_map
from torch_host_guard import HostOpError, host_guard

torch.set_num_threads(1)
FLEET8 = os.path.join(os.path.dirname(__file__), "..", ".fleet_cache", "test8.pkl")
TICKS = 3


def f64(a):
    a = np.asarray(a)
    return a.astype(np.float64) if a.dtype.kind == "f" else a


def scenes(count=2, dtype=torch.float64):
    payload = load(FLEET8)
    tree = tree_map(lambda a: f64(a)[:count], (payload["carry"], payload["q0"], payload["obs"]))
    return to_torch(tree, "cpu", dtype)


def leaves(tree):
    out = []
    tree_map(lambda x: out.append(np.asarray(x)), tree)
    return out


def test_host_guard_catches_host_ops():
    x = torch.zeros(2)
    for op in (lambda: torch.tensor([1.0]), lambda: torch.as_tensor((1.0,)),
               lambda: torch.from_numpy(np.zeros(2)), lambda: x[0].item(),
               lambda: bool(x[0]), lambda: float(x[0]), lambda: x.tolist(),
               lambda: x.cpu(), lambda: x.numpy(), lambda: x[[0, 1]],
               lambda: x.__setitem__(0, 1.0)):
        with pytest.raises(HostOpError), host_guard():
            op()
    with host_guard():
        torch.as_tensor(x, dtype=torch.float64)
        torch.zeros(2) + torch.arange(2)
        x[0].fill_(1.0)
        torch.where(x > 0, 0.0, x)


CAPTURE_CONFIGS = {
    "perf": (tconfig.perf_mpc_params(), 2),
    "esc4_base": (dataclasses.replace(tconfig.perf_mpc_params(), esc_lanes=4), 2),
    "kkt2": (dataclasses.replace(tconfig.perf_mpc_params(), kkt_every=2), 2),
    "admm": (dataclasses.replace(tconfig.perf_mpc_params(), struct_tail=False,
                                 qp_solver="admm"), 2),
    "default_f64_batch1": (tconfig.MPCParams(), 1),
}


@pytest.mark.parametrize("name", list(CAPTURE_CONFIGS))
def test_tick_is_capture_safe(name):
    """(a) No host data and no host read inside one tick."""
    cfg, count = CAPTURE_CONFIGS[name]
    carry, q0, obs = scenes(count)
    model = FleetMPC(cfg, device="cpu", dtype=torch.float64)
    zeros = torch.zeros_like(q0)
    meas = tbatch._plant_measurement(q0, zeros, zeros, zeros, q0, model.st.chain)
    with host_guard():
        _, out = model.tick(carry, meas, obs)
    assert out["q"].shape == (count, cfg.n, 7)
    assert torch.isfinite(out["q"]).all()


def body_rollout(esc_lanes):
    """A 3-tick float64 ``fleet_rollout`` through the step graph's body;
    returns (numpy result, model, retries)."""
    cfg = dataclasses.replace(tconfig.perf_mpc_params(), esc_lanes=esc_lanes)
    model = FleetMPC(cfg, device="cpu", dtype=torch.float64)
    model.graph = True
    tbatch._escalate_failed_lanes.retries = 0
    out = to_numpy(tbatch.fleet_rollout(*scenes(), model, TICKS))
    return out, model, tbatch._escalate_failed_lanes.retries


@pytest.fixture(scope="module")
def body_no_esc():
    return body_rollout(0)


@pytest.mark.parametrize("esc_lanes", [0, 4])
def test_graph_body_equals_eager_rollout(esc_lanes, body_no_esc):
    """(b) 3 ticks through the step graph's body equal the eager route bit
    for bit; with 4 escalation lanes the retry (scene 0, tick 3) runs
    inside the same step graph, whose key names the escalation."""
    got, body, retries = body_no_esc if esc_lanes == 0 else body_rollout(esc_lanes)
    eager = FleetMPC(body.cfg, device="cpu", dtype=torch.float64)
    assert eager.graph is False
    tbatch._escalate_failed_lanes.retries = 0
    ref = to_numpy(tbatch.fleet_rollout(*scenes(), eager, TICKS))
    assert tbatch._escalate_failed_lanes.retries == retries == (1 if esc_lanes else 0)
    (key,) = body.graphs
    assert key[:3] == (tbatch._rollout_step, body.cfg, (esc_lanes > 0,)) and not eager.graphs
    for g, r in zip(leaves(got), leaves(ref)):
        assert g.dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(g, r)


def test_graph_body_matches_jax_rollout(body_no_esc):
    """(c) The graph body in float64 against JAX's jitted rollout, 2 scenes
    x 3 ticks, at the slice test's tolerances (q/phi/p 1e-6, viol 1e-8,
    flags exact, the final decision vector 1e-6 of its largest entry)."""
    carry, q0, obs = (to_numpy(t) for t in scenes())
    jcarry = jmpc.MPCCarry(jmpc.PathState(*carry.path), *carry[1:])
    jfinal, jrecs = jax.tree.map(np.asarray, jax_fleet_rollout(
        jcarry, jnp.asarray(q0), jmpc.ObstacleArrays(*obs), perf_mpc_params(), TICKS))
    (tfinal, trecs), model, _ = body_no_esc
    assert len(model.graphs) == 1
    np.testing.assert_array_equal(trecs["success"], jrecs["success"])
    for key in ("q", "phi", "p"):
        np.testing.assert_allclose(trecs[key], jrecs[key], rtol=0, atol=1e-6)
    np.testing.assert_allclose(trecs["viol"], jrecs["viol"], rtol=0, atol=1e-8)
    x_scale = np.abs(jfinal.x_prev).max()
    np.testing.assert_allclose(tfinal.x_prev, jfinal.x_prev, rtol=0, atol=1e-6 * x_scale)
    for name in ("split_idx", "switch", "has_prev", "error_count"):
        np.testing.assert_array_equal(getattr(tfinal, name), getattr(jfinal, name))


def test_cpu_default_is_eager_and_graph_true_raises():
    """(d) On the CPU the default route is eager; asking for a graph there
    raises."""
    cfg = tconfig.perf_mpc_params()
    with pytest.raises(ValueError, match="CUDA"):
        FleetMPC(cfg, device="cpu", graph=True)
    model = FleetMPC(cfg, device="cpu", dtype=torch.float64)
    assert model.graph is False
    carry, q0, obs = scenes(1)
    tbatch.fleet_rollout(carry, q0, obs, model, 1)
    assert model.graphs == {}
    assert FleetMPC(cfg, device="cpu", graph=False).graph is False
