"""The port's multi-process and multi-device rollouts on the CPU.

Two ranks of ``python -m boundplanner_tpu_torch.parallel.dryrun`` started
by `distributed.launch` over ``gloo`` (float64, an 8-scene demo fleet,
``perf_mpc_params()``, 2 ticks) reproduce one process rolling the same
fleet out with ``chunked_rollout`` at chunk 4 (a rank's block) by value;
the diagnostics are the same on both ranks and match the host reductions
within the JAX test's tolerances (success 1e-6, phi 1e-9). In one
process, ``sharded_rollout`` over ``["cpu", "cpu"]`` and
``dryrun_multichip`` over the same two devices equal the chunked
rollout. Each of the three is also held to the JAX package's
``fleet_rollout`` on the same demo fleet: phi and q within 1e-6 and the
success flags exactly (the f64 slice's bars, tests/test_torch_slice.py),
the diagnostics within the same bars (max_viol 1e-8), and the executed
enter/dig-in penetration within 1e-6 of the JAX dry run's own jnp
expression (``__graft_entry__.py``), which also holds the port's measure
on hand-made trajectories. Also the shard slice of one process, the feed
round trip, and the launcher's failure report.
"""

import json
import sys
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from boundplanner_tpu import demo as jdemo
from boundplanner_tpu.config import perf_mpc_params as jperf
from boundplanner_tpu.parallel.batch import fleet_rollout as jax_fleet_rollout
from boundplanner_tpu_torch.config import perf_mpc_params
from boundplanner_tpu_torch.demo import demo_fleet
from boundplanner_tpu_torch.mpc.bound_mpc import FleetMPC
from boundplanner_tpu_torch.parallel import distributed as dist
from boundplanner_tpu_torch.parallel.batch import chunked_rollout
from boundplanner_tpu_torch.parallel.dryrun import dryrun_multichip, executed_penetration
from boundplanner_tpu_torch.parallel.mesh import fleet_diagnostics, sharded_rollout
from boundplanner_tpu_torch.utils.tree import to_numpy, to_torch, tree_map

torch.set_num_threads(1)
BATCH, TICKS, F64 = 8, 2, torch.float64
CPU = torch.device("cpu")
TOL, VIOL_TOL = 1e-6, 1e-8


def jax_penetration(p, obs):
    """The JAX dry run's executed-EE penetration (``__graft_entry__.py``),
    as jnp."""
    p3 = jnp.asarray(p)[..., :3]
    rows = jnp.einsum("bmri,bti->btmr", jnp.asarray(obs.a), p3) - jnp.asarray(obs.b)[:, None]
    pen = -jnp.max(rows, axis=-1)
    pen = jnp.where(jnp.asarray(obs.mask)[:, None, :], pen, -jnp.inf)
    d = jnp.max(pen, axis=-1)
    clean0 = d[:, 0] <= 1e-3
    pen_enter = jnp.max(jnp.where(clean0, jnp.max(d, axis=1), -jnp.inf))
    pen_digin = jnp.max(jnp.where(~clean0, d[:, -1] - d[:, 0], -jnp.inf))
    return float(pen_enter), float(pen_digin)


@pytest.fixture(scope="module")
def fleet():
    carry, obs, q0 = demo_fleet(perf_mpc_params(), BATCH, dtype=np.float64)
    return to_torch((carry, q0, obs), CPU, F64)


@pytest.fixture(scope="module")
def reference(fleet):
    """One process, chunks of one rank's block."""
    model = FleetMPC(perf_mpc_params(), device="cpu", dtype=F64)
    final, recs = chunked_rollout(*fleet, model, TICKS, chunk=BATCH // 2)
    return to_numpy(final), to_numpy(recs)


@pytest.fixture(scope="module")
def jax_reference():
    """The JAX package's rollout of the same demo fleet, and its dry-run
    diagnostics."""
    carry, obs, q0 = jdemo.demo_fleet(jperf(), BATCH, dtype=np.float64)
    _, recs = jax_fleet_rollout(carry, jnp.asarray(q0), obs, jperf(), TICKS)
    recs = jax.tree.map(np.asarray, recs)
    enter, digin = jax_penetration(recs["p"], obs)
    diag = {"success_rate": float(recs["success"].astype(np.float32).mean()),
            "max_viol": float(recs["viol"].max()),
            "mean_phi_final": float(recs["phi"][:, -1].mean()),
            "pen_enter": enter, "pen_digin": digin}
    return recs, diag


@pytest.fixture(scope="module")
def gloo_ranks():
    results = dist.launch(
        [sys.executable, "-m", "boundplanner_tpu_torch.parallel.dryrun", "--demo", str(BATCH),
         "--ticks", str(TICKS), "--device", "cpu", "--dtype", "float64", "--backend", "gloo"],
        nproc=2, env_extra={"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}, timeout=240)
    ranks = []
    for rc, out in results:
        assert rc == 0
        line = [ln for ln in out.splitlines() if ln.startswith("DRYRUN_RESULT ")]
        assert line, out
        ranks.append(json.loads(line[0][len("DRYRUN_RESULT "):]))
    ranks.sort(key=lambda r: r["rank"])
    return ranks


@pytest.fixture(scope="module")
def sharded(fleet):
    return sharded_rollout(*fleet, perf_mpc_params(), TICKS, ["cpu", "cpu"])


@pytest.fixture(scope="module")
def dryrun_two_devices():
    return dryrun_multichip(n_devices=2, n_ticks=TICKS, device="cpu", dtype=F64,
                            demo_batch=BATCH)


def test_two_gloo_processes_match_one(gloo_ranks, reference):
    ranks = gloo_ranks
    assert [r["lo"] for r in ranks] == [0, BATCH // 2]
    assert ranks[0]["diag"] == ranks[1]["diag"]
    assert ranks[0]["launches"] == {"chol_inverse": 0, "line_polytope": 0}   # the CPU

    _, recs = reference
    phi = np.concatenate([np.asarray(r["phi"]) for r in ranks])
    q = np.concatenate([np.asarray(r["q"]) for r in ranks])
    assert np.std(recs["phi"][:, -1]) > 1e-5          # distinct scenes: a wrong order would show
    np.testing.assert_array_equal(phi, recs["phi"])
    np.testing.assert_array_equal(q, recs["q"][:, -1])
    diag = ranks[0]["diag"]
    np.testing.assert_allclose(diag["success_rate"], recs["success"].astype(np.float32).mean(),
                               atol=1e-6)
    np.testing.assert_allclose(diag["mean_phi_final"], recs["phi"][:, -1].mean(), atol=1e-9)
    assert diag["max_viol"] == recs["viol"].max()


def test_sharded_rollout_matches_chunked(sharded, reference):
    final, recs, diag = sharded
    ref_final, ref_recs = reference
    tree_map(np.testing.assert_array_equal, to_numpy(recs), ref_recs)
    tree_map(np.testing.assert_array_equal, to_numpy(final), ref_final)
    assert diag == fleet_diagnostics(tree_map(torch.from_numpy, ref_recs))


def test_dryrun_over_two_devices_matches_chunked(dryrun_two_devices, reference):
    res = dryrun_two_devices
    _, recs = reference
    assert res["shards"] == 2 and res["ranks"] == 1 and res["lo"] == 0
    np.testing.assert_array_equal(res["phi"], recs["phi"])
    np.testing.assert_array_equal(res["q"], recs["q"][:, -1])
    assert res["diag"]["mean_phi_final"] == pytest.approx(recs["phi"][:, -1].mean(), abs=1e-12)


def assert_diag_matches(diag, ref):
    assert diag["success_rate"] == pytest.approx(ref["success_rate"], abs=1e-6)
    assert diag["mean_phi_final"] == pytest.approx(ref["mean_phi_final"], abs=TOL)
    assert diag["max_viol"] == pytest.approx(ref["max_viol"], abs=VIOL_TOL)
    for key in ("pen_enter", "pen_digin"):
        np.testing.assert_allclose(diag[key], ref[key], rtol=0, atol=TOL)


@pytest.mark.parametrize("route", ["gloo", "sharded", "dryrun"])
def test_matches_jax(route, request, jax_reference):
    """Two gloo ranks, ``sharded_rollout`` over two devices, and
    ``dryrun_multichip`` over two devices, each against the JAX rollout."""
    jrecs, jdiag = jax_reference
    if route == "gloo":
        ranks = request.getfixturevalue("gloo_ranks")
        phi = np.concatenate([np.asarray(r["phi"]) for r in ranks])
        q = np.concatenate([np.asarray(r["q"]) for r in ranks])
        diag = ranks[0]["diag"]
    elif route == "sharded":
        _, recs, diag = request.getfixturevalue("sharded")
        recs = to_numpy(recs)
        obs = to_numpy(request.getfixturevalue("fleet")[2])
        enter, digin = executed_penetration(recs["p"], obs)
        diag = {**diag, "pen_enter": enter, "pen_digin": digin}
        np.testing.assert_array_equal(recs["success"], jrecs["success"])
        np.testing.assert_allclose(recs["p"], jrecs["p"], rtol=0, atol=TOL)
        np.testing.assert_allclose(recs["viol"], jrecs["viol"], rtol=0, atol=VIOL_TOL)
        phi, q = recs["phi"], recs["q"][:, -1]
    else:
        res = request.getfixturevalue("dryrun_two_devices")
        phi, q, diag = res["phi"], res["q"], res["diag"]
    np.testing.assert_allclose(phi, jrecs["phi"], rtol=0, atol=TOL)
    np.testing.assert_allclose(q, jrecs["q"][:, -1], rtol=0, atol=TOL)
    assert_diag_matches(diag, jdiag)


def test_local_batch_slice_and_feed_round_trip():
    assert not dist.is_initialized()
    assert dist.local_batch_slice(8) == slice(0, 8)
    tree = {"a": np.arange(16, dtype=np.float64).reshape(8, 2), "b": np.arange(8),
            "c": torch.ones(8, 3, dtype=F64)}
    fed = dist.global_from_local(tree, "cpu", F64)
    assert fed["a"].dtype == F64 and fed["b"].dtype == torch.int64
    back = dist.local_from_global(fed)
    for key in tree:
        np.testing.assert_array_equal(back[key], np.asarray(tree[key]))


def test_global_from_local_roundtrip():
    """tests/test_distributed.py's round trip through the scenario mesh, in
    one process: the mesh is this process's device alone, and a tree fed
    onto it comes back equal."""
    mesh = dist.global_scenario_mesh("cpu")
    assert mesh == [torch.device("cpu")]
    tree = {"a": np.arange(16, dtype=np.float32).reshape(8, 2),
            "b": np.arange(8, dtype=np.float32)}
    back = dist.local_from_global(dist.global_from_local(tree, mesh, torch.float32))
    np.testing.assert_array_equal(back["a"], tree["a"])
    np.testing.assert_array_equal(back["b"], tree["b"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            dist.global_scenario_mesh()


def test_executed_penetration():
    """Scene 0 starts clean and enters the box 2 cm deep; scene 1 starts
    3 cm inside and ends 1 cm inside (it pulls out)."""
    a = np.concatenate([np.eye(3), -np.eye(3)])[None, None].repeat(2, 0)   # (2, 1, 6, 3)
    b = np.array([0.1] * 3 + [0.1] * 3)[None, None].repeat(2, 0)           # |x_i| <= 0.1
    obs = types.SimpleNamespace(a=a, b=b, mask=np.ones((2, 1), bool))
    p = np.zeros((2, 3, 6))
    p[0, :, 0] = [0.3, 0.2, 0.08]
    p[1, :, 0] = [0.07, 0.08, 0.09]
    enter, digin = executed_penetration(p, obs)
    assert enter == pytest.approx(0.02) and digin == pytest.approx(-0.02)
    assert (enter, digin) == pytest.approx(jax_penetration(p, obs), abs=1e-12)


def test_executed_penetration_matches_jax_on_random_trajectories():
    """Random boxes and trajectories around them, two scenes starting
    inside a box (one 2 cm deep), some masked boxes: the port's measure
    equals the jnp expression."""
    rng = np.random.default_rng(5)
    n_b, n_t, n_m = 6, 7, 3
    lo = rng.uniform(-0.3, 0.1, (n_b, n_m, 3))
    hi = lo + rng.uniform(0.05, 0.3, (n_b, n_m, 3))
    a = np.broadcast_to(np.concatenate([np.eye(3), -np.eye(3)]), (n_b, n_m, 6, 3)).copy()
    b = np.concatenate([hi, -lo], axis=-1)
    mask = rng.random((n_b, n_m)) < 0.8
    mask[:, 0] = True
    p = rng.uniform(-0.35, 0.45, (n_b, n_t, 6))
    p[0, 0, :3] = (lo[0, 0] + hi[0, 0]) / 2            # scene 0 starts inside box 0
    p[1, 0, :3] = hi[1, 0] - 0.02                       # scene 1 starts 2 cm inside box 0
    obs = types.SimpleNamespace(a=a, b=b, mask=mask)
    enter, digin = executed_penetration(p, obs)
    assert np.isfinite(digin)
    assert (enter, digin) == pytest.approx(jax_penetration(p, obs), abs=1e-12)


def test_launch_reports_a_failed_rank():
    with pytest.raises(RuntimeError, match="1/2 processes failed"):
        dist.launch([sys.executable, "-c",
                     f"import os, sys; sys.exit(int(os.environ['{dist.ENV_PID}']))"],
                    nproc=2, timeout=60)
