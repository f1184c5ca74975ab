"""The planner's batched shortest-path route ("spath") in the port against
the JAX package's:

- ``register_planner_kernels`` has JAX's signature and registers "spath"
  only when asked; ``build_fleet_threaded`` takes JAX's arguments;
- ``BoundPlanner._shortest_path`` routes through the broker exactly when
  JAX's does (the key served and at most ``SPATH_PAD`` junctions), and an
  unreached end raises;
- the scene of ``tests/test_device_search.py``'s planner test, planned in
  float64 through a broker with the route: equal to JAX's routed plan at
  1e-9, and to the port's host route at JAX's own bar (the same via count,
  vias within 1e-5: the route relaxes in float32);
- ``build_fleet_threaded(device_search=True)`` plans one scene on the CPU
  with the "spath" key served.
"""

import inspect

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as R

from boundplanner_tpu.parallel import broker as jbroker
from boundplanner_tpu.parallel import fleet as jfleet
from boundplanner_tpu.planner import BoundPlanner as JaxPlanner
from boundplanner_tpu.planner import planner as jplanner
from boundplanner_tpu_torch.config import perf_mpc_params
from boundplanner_tpu_torch.parallel import fleet
from boundplanner_tpu_torch.parallel.broker import BatchBroker, register_planner_kernels
from boundplanner_tpu_torch.planner import planner as tplanner
from boundplanner_tpu_torch.planner.planner import BoundPlanner
from boundplanner_tpu_torch.planner.roadmap import PlanningError

from test_torch_device_search import path_cost, random_roadmap

torch.set_num_threads(1)

OBSTACLES = [[0.2, -1.0, -0.1, 1.0, 1.0, 0.0],
             [0.35, -0.25, 0.0, 0.55, -0.1, 0.45]]
KW = dict(e_p_max=0.5, obstacles=OBSTACLES, workspace_max=[1.0, 0.38, 1.0],
          workspace_min=[-0.14, -1.0, 0.0], seed=0)
P0 = np.array([0.3, 0.3, 0.6])
P1 = np.array([0.45, -0.4, 0.25])
R0 = np.eye(3)
R1 = R.from_euler("XYZ", [0, 90, 0], degrees=True).as_matrix()


def params_of(fn):
    return [(p.name, p.kind, p.default) for p in inspect.signature(fn).parameters.values()]


def test_register_planner_kernels_signature_is_jax():
    assert (inspect.signature(register_planner_kernels)
            == inspect.signature(jbroker.register_planner_kernels))
    assert tplanner.SPATH_PAD == jplanner.SPATH_PAD == 64


def test_build_fleet_threaded_takes_jax_arguments():
    """JAX's parameters, in order and with their defaults, then the port's
    ``device`` and ``plan_dtype``."""
    jax_params = params_of(jfleet.build_fleet_threaded)
    port_params = params_of(fleet.build_fleet_threaded)
    assert port_params[:len(jax_params)] == jax_params
    assert [p[0] for p in port_params[len(jax_params):]] == ["device", "plan_dtype"]


@pytest.mark.parametrize("device_search", [False, True])
def test_spath_registered_only_when_asked(device_search):
    brk = BatchBroker(linger=0.0, device="cpu")
    register_planner_kernels(brk, 20, device_search)
    assert ("spath" in brk._fns) == device_search
    assert "via_rot_6" in brk._fns and "via_rot_7" not in brk._fns


@pytest.mark.parametrize("n_junctions, routed", [(12, True), (64, True), (65, False)])
def test_shortest_path_routes_by_size(n_junctions, routed):
    """Through "spath" up to SPATH_PAD junctions, on the host beyond; the
    same optimum either way."""
    rm = random_roadmap(np.random.default_rng(n_junctions), n_junctions)
    brk = BatchBroker(linger=0.0, device="cpu", dtype=torch.float64)
    register_planner_kernels(brk, device_search=True)
    planner = BoundPlanner(broker=brk, device="cpu", dtype=torch.float64)
    path = planner._shortest_path(rm)
    assert brk.calls_by_key.get("spath", 0) == int(routed)
    assert path[0] == 0 and path[-1] == 1
    assert all(v in rm._adj[u] for u, v in zip(path, path[1:]))
    np.testing.assert_allclose(path_cost(rm, path), path_cost(rm, rm.shortest_path()),
                               rtol=1e-5)


def test_shortest_path_without_route_is_host():
    rm = random_roadmap(np.random.default_rng(3), 10)
    brk = BatchBroker(linger=0.0, device="cpu", dtype=torch.float64)
    register_planner_kernels(brk)
    planner = BoundPlanner(broker=brk, device="cpu", dtype=torch.float64)
    assert planner._shortest_path(rm) == rm.shortest_path()
    assert "spath" not in brk.calls_by_key


def test_routed_unreached_end_raises():
    rm = random_roadmap(np.random.default_rng(1), 6)
    for u in range(6):
        rm._adj[u].pop(1, None)
    rm._adj[1] = {}
    brk = BatchBroker(linger=0.0, device="cpu", dtype=torch.float64)
    register_planner_kernels(brk, device_search=True)
    planner = BoundPlanner(broker=brk, device="cpu", dtype=torch.float64)
    with pytest.raises(RuntimeError, match="not connected") as err:
        planner._shortest_path(rm)
    assert isinstance(err.value, PlanningError)


@pytest.fixture(scope="module")
def plans():
    """JAX's routed plan, the port's routed plan and the port's host plan
    (float64), with the port's broker."""
    jbrk = jbroker.BatchBroker(linger=0.0)
    jbroker.register_planner_kernels(jbrk, device_search=True)
    jax_routed = JaxPlanner(broker=jbrk, **KW).plan_convex_set_path(P0.copy(), P1.copy(), R0, R1)
    brk = BatchBroker(linger=0.0, device="cpu", dtype=torch.float64)
    register_planner_kernels(brk, device_search=True)
    routed = BoundPlanner(broker=brk, device="cpu", dtype=torch.float64, **KW)
    port_routed = routed.plan_convex_set_path(P0.copy(), P1.copy(), R0, R1)
    port_host = BoundPlanner(device="cpu", dtype=torch.float64, **KW).plan_convex_set_path(
        P0.copy(), P1.copy(), R0, R1)
    return jax_routed, port_routed, port_host, brk


def test_routed_plan_matches_jax_routed(plans):
    jax_routed, port_routed, _, brk = plans
    assert brk.calls_by_key["spath"] >= 1
    p_via, r_via, bp1, sets_via = port_routed
    assert len(p_via) == len(jax_routed[0])
    np.testing.assert_allclose(np.asarray(p_via), np.asarray(jax_routed[0]), rtol=0, atol=1e-9)
    np.testing.assert_allclose(np.asarray(r_via), np.asarray(jax_routed[1]), rtol=0, atol=1e-9)
    np.testing.assert_allclose(np.asarray(bp1), np.asarray(jax_routed[2]), rtol=0, atol=1e-9)
    for (a, b), (ja, jb) in zip(sets_via, jax_routed[3]):
        np.testing.assert_allclose(a, ja, rtol=0, atol=1e-9)
        np.testing.assert_allclose(b, jb, rtol=0, atol=1e-9)


def test_routed_plan_matches_host_route(plans):
    """JAX's own bar for the route against the host Dijkstra
    (``tests/test_device_search.py``)."""
    _, port_routed, port_host, _ = plans
    assert len(port_routed[0]) == len(port_host[0])
    np.testing.assert_allclose(np.asarray(port_routed[0]), np.asarray(port_host[0]), atol=1e-5)


def test_build_fleet_threaded_routes_spath():
    carry, q0, obs, brk = fleet.build_fleet_threaded(
        1, perf_mpc_params(), n_obstacles=2, seed=3, dtype=np.float64, n_threads=1,
        linger=0.0, device_search=True, device="cpu", plan_dtype=torch.float64)
    assert brk.calls_by_key["spath"] >= 1
    assert q0.shape == (1, 7) and np.isfinite(np.asarray(carry.x_prev)).all()
