"""The port's cross-scene broker and fleet cache on the CPU: coalescing
semantics, brokered planners against unbrokered ones, and a 2-scene
``fleet_cache.build_and_save`` that round-trips through ``load_fleet``
into the rollout. The JAX-built cache files load too.

Brokered plans must equal the unbrokered ones to 1e-12 (float64): the
broker stacks the same batch-major calls, and a batch row's result does
not depend on its neighbours beyond summation order.
"""

import os
import pickle
import sys
import threading

import numpy as np
import pytest
from scipy.spatial.transform import Rotation as R

import torch

from boundplanner_tpu_torch.config import perf_mpc_params
from boundplanner_tpu_torch.mpc.bound_mpc import FleetMPC
from boundplanner_tpu_torch.parallel import fleet, fleet_cache
from boundplanner_tpu_torch.parallel.batch import fleet_rollout
from boundplanner_tpu_torch.parallel.broker import BatchBroker, register_planner_kernels
from boundplanner_tpu_torch.planner.planner import BoundPlanner

torch.set_num_threads(1)
ROOT = os.path.join(os.path.dirname(__file__), "..")


def run_threads(fn, n, timeout=300):
    out, errors = [None] * n, []

    def work(i):
        try:
            out[i] = fn(i)
        except Exception as err:  # reported by the caller
            errors.append(err)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    return out


def test_coalesces_concurrent_calls():
    brk = BatchBroker(linger=0.05, device="cpu", dtype=torch.float64)
    brk.register("sq", lambda x: x * x)
    out = run_threads(lambda i: brk.call("sq", np.full(3, float(i))), 6)
    for i in range(6):
        np.testing.assert_allclose(out[i], np.full(3, float(i)) ** 2)
    assert brk.calls_served == 6
    assert brk.batches_run < 6
    assert brk.coalesced_calls == 6 - brk.batches_run


def test_stress_more_threads_than_cores():
    """32 threads, several keys, a tiny switch interval: every caller gets
    its own row and the counters add up (a lost update would break them)."""
    brk = BatchBroker(linger=0.002, max_batch=8, device="cpu", dtype=torch.float64)
    for k in range(3):
        brk.register(f"k{k}", lambda x, k=k: x * 2.0 + k)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        out = run_threads(lambda i: [brk.call(f"k{(i + j) % 3}", np.full(2, float(i)))
                                     for j in range(5)], 32, timeout=60)
    finally:
        sys.setswitchinterval(old)
    for i in range(32):
        for j in range(5):
            np.testing.assert_array_equal(out[i][j], np.full(2, 2.0 * i + (i + j) % 3))
    assert brk.calls_served == 160
    assert brk.coalesced_calls == brk.calls_served - brk.batches_run


def test_pads_to_power_of_two_and_chunks():
    seen = []
    brk = BatchBroker(linger=0.05, max_batch=4, device="cpu", dtype=torch.float64)
    brk.register("id", lambda x: (seen.append(x.shape[0]), x + 1.0)[1])
    out = run_threads(lambda i: brk.call("id", np.full(2, float(i))), 7)
    for i in range(7):
        np.testing.assert_allclose(out[i], np.full(2, i + 1.0))
    assert all(n in (1, 2, 4) for n in seen)
    assert brk.calls_served == 7


def test_single_call_does_not_deadlock():
    brk = BatchBroker(linger=0.001, device="cpu", dtype=torch.float64)
    brk.register("neg", lambda x: -x)
    np.testing.assert_allclose(brk.call("neg", np.arange(4.0)), -np.arange(4.0))
    assert brk.batches_run == 1


def test_error_reaches_every_caller():
    brk = BatchBroker(linger=0.05, device="cpu")

    def boom(x):
        raise ValueError("kernel failed")

    brk.register("boom", boom)
    errors = []

    def call(i):
        try:
            brk.call("boom", np.zeros(2))
        except ValueError as err:
            errors.append(err)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(errors) == 3


OBSTACLES = [[0.2, -1.0, -0.1, 1.0, 1.0, 0.0], [0.35, -0.25, 0.0, 0.55, -0.1, 0.45]]
GOALS = [[0.45, -0.4, 0.25], [0.5, -0.45, 0.3], [0.4, -0.35, 0.2], [0.45, -0.45, 0.35]]


def plan(i, broker):
    planner = BoundPlanner(e_p_max=0.5, obstacles=OBSTACLES, workspace_max=[1.0, 0.38, 1.0],
                           workspace_min=[-0.14, -1.0, 0.0], seed=i, broker=broker,
                           device="cpu", dtype=torch.float64)
    r0 = R.from_euler("XYZ", [0, 90, 0], degrees=True).as_matrix()
    return planner.plan_convex_set_path(np.array([0.55, 0.0, 0.6]), np.array(GOALS[i]), r0, r0)


def test_brokered_planners_match_direct():
    """Four planner threads through one broker plan what four unbrokered
    planners plan."""
    direct = [plan(i, None) for i in range(4)]
    brk = BatchBroker(linger=0.02, device="cpu", dtype=torch.float64)
    register_planner_kernels(brk, max_set_size=20)
    brokered = run_threads(lambda i: plan(i, brk), 4)
    assert brk.coalesced_calls >= 1
    assert brk.calls_served == brk.batches_run + brk.coalesced_calls
    for (pv0, rv0, _, sets0), (pv1, rv1, _, sets1) in zip(direct, brokered):
        assert len(pv0) == len(pv1)
        for a, b in zip(pv0 + rv0, pv1 + rv1):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=1e-12)
        for (a0, b0), (a1, b1) in zip(sets0, sets1):
            np.testing.assert_allclose(a0, a1, rtol=0, atol=1e-12)
            np.testing.assert_allclose(b0, b1, rtol=0, atol=1e-12)


def test_unported_builders_raise(monkeypatch):
    """The phase-synchronous and the process-pool builders are ported (no
    builder raises ``NotImplementedError`` any more): on a machine without a
    card their default device raises the card's error at once, and
    ``build_and_save`` sends 512 scenes or more to the process pool."""
    cfg = perf_mpc_params()
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fleet.build_fleet_sync(4, cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fleet.build_fleet_mp(4, cfg)

    class Routed(Exception):
        pass

    def pool_builder(batch, cfg, **kw):
        raise Routed(batch)

    monkeypatch.setattr(fleet, "build_fleet_mp", pool_builder)
    with pytest.raises(Routed):
        fleet_cache.build_and_save(512, 0, "unused.pkl", device="cpu")


def test_cache_path_keys(tmp_path):
    p = fleet_cache.cache_path(128, 7, 4, root=str(tmp_path))
    assert p.endswith("fleet_b128_s7_segs4.pkl") and str(tmp_path) in p


def test_load_rejects_wrong_schema(tmp_path):
    p = tmp_path / "bad.pkl"
    with open(p, "wb") as f:
        pickle.dump({"schema": "something_else"}, f)
    with pytest.raises(ValueError, match="schema"):
        fleet_cache.load(str(p))


def test_build_and_save_roundtrip(tmp_path):
    """A 2-scene fleet planned in float64 through the threaded broker
    builder, pickled, reloaded as tensors and rolled one tick; every kept
    scene is a fleet draw of the seed."""
    path = str(tmp_path / "fleet2.pkl")
    payload = fleet_cache.build_and_save(2, 5, path, n_threads=2, dtype=np.float64,
                                         device="cpu", plan_dtype=torch.float64)
    assert payload["broker_stats"]["calls_served"] > 0
    loaded = fleet_cache.load(path)
    assert loaded["batch"] == 2 and loaded["seed"] == 5
    assert loaded["nr_segs"] == perf_mpc_params().nr_segs
    draws = [fleet.build_obstacle_arrays(fleet.random_scene(
        np.random.default_rng(5 + 1000 * d), 3)[0], dtype=np.float64) for d in range(1, 9)]
    for i in range(2):
        assert any(np.array_equal(loaded["obs"].b[i], o.b) for o in draws)

    carry, q0, obs = fleet_cache.load_fleet(path, "cpu", torch.float64)
    assert q0.shape == (2, 7) and carry.path.p.shape == (2, 16, 3)
    np.testing.assert_array_equal(carry.path.p.numpy(), payload["carry"].path.p)
    model = FleetMPC(perf_mpc_params(), device="cpu", dtype=torch.float64)
    _, recs = fleet_rollout(carry, q0, obs, model, 1)
    assert torch.isfinite(recs["phi"]).all()


@pytest.mark.parametrize("name", ["test8.pkl", "fleet_b128_s7_segs4.pkl"])
def test_loads_jax_built_caches(name):
    payload = fleet_cache.load(os.path.join(ROOT, ".fleet_cache", name))
    carry, q0, obs = fleet_cache.to_torch((payload["carry"], payload["q0"], payload["obs"]), "cpu")
    assert carry.path.p.shape[0] == q0.shape[0] == obs.a.shape[0]
