"""The port's process-pool fleet builder and the fleet cache's routes.

``build_fleet_mp`` on the CPU in float64 (2 spawned worker processes,
blocks of 2 draws, 2 obstacles, a reduced ``MPCParams`` as in
tests/test_sync_broker.py) keeps the first 2 successful draws in draw
order, and they equal the same draws planned one after another in this
process, bit for bit (both run the unbrokered planner on one thread). The
block results come back from the workers with their kernel-launch counts
(0 here: the CPU takes the kernels' plain versions). The JAX package's
``build_fleet_mp`` with the same arguments, its pool run in this process,
plans the same number of draws, as many successfully, and keeps the same
fleet within 1e-6 (the planner's parity bar, tests/test_torch_planner.py).
On a card the default worker count is capped at ``fleet.CARD_PROCS``.

``fleet_cache.build_and_save`` routes 512 scenes or more to
``build_fleet_mp`` with its ``info`` as the stats; ``fleet_cache.ensure``
loads an existing file, and builds a missing one with the CLI in a
subprocess (the command is checked; the build is stood in for by a copy
of a cached fleet). Nothing is written into the tracked ``.fleet_cache/``.
"""

import os
import shutil
import sys

import multiprocessing

import numpy as np
import pytest

import jax
import torch

from boundplanner_tpu import config as jconfig
from boundplanner_tpu.parallel import fleet as jfleet
from boundplanner_tpu_torch.config import MPCParams
from boundplanner_tpu_torch.ops import _build
from boundplanner_tpu_torch.parallel import fleet, fleet_cache
from boundplanner_tpu_torch.utils.tree import tree_map, tree_stack

torch.set_num_threads(1)
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TEST8 = os.path.join(ROOT, ".fleet_cache", "test8.pkl")
SMALL = dict(sqp_iters=2, qp_iters=5, line_search_steps=2)
CFG = MPCParams(**SMALL)
BUILD = dict(n_obstacles=2, seed=3, n_procs=2, block=2, dtype=np.float64)
TOL = 1e-6


@pytest.fixture(scope="module")
def port_fleet():
    return fleet.build_fleet_mp(2, CFG, device="cpu", plan_dtype=torch.float64, timeout=300,
                                **BUILD)


class _InlineContext:
    """A stand-in for the spawn context: the pool runs its tasks in this
    process, one after another (no initializer: it would pin this process
    to one core)."""

    def Value(self, *args):
        return multiprocessing.Value(*args)

    def Pool(self, processes, initializer, initargs):
        return _InlinePool()


class _InlinePool:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def imap_unordered(self, fn, tasks):
        return map(fn, tasks)


def test_mp_fleet_build_matches_jax(port_fleet, monkeypatch):
    monkeypatch.setattr(multiprocessing, "get_context", lambda method: _InlineContext())
    carry_j, q0_j, obs_j, info_j = jfleet.build_fleet_mp(
        2, jconfig.MPCParams(**SMALL), pin=False, x64=True, **BUILD)
    carry_t, q0_t, obs_t, info_t = port_fleet
    for key in ("planned", "draws", "n_procs"):
        assert info_t[key] == info_j[key], key
    np.testing.assert_array_equal(q0_t, q0_j)
    for got, ref in zip(obs_t, obs_j):
        np.testing.assert_array_equal(got, np.asarray(ref))
    np.testing.assert_array_equal(carry_t.path.num_sectors, carry_j.path.num_sectors)
    assert carry_t._fields == carry_j._fields
    for got, ref in zip(jax.tree.leaves(tuple(carry_t)), jax.tree.leaves(tuple(carry_j))):
        np.testing.assert_allclose(np.asarray(got, float), np.asarray(ref, float),
                                   rtol=TOL, atol=TOL)


def test_mp_fleet_build_matches_direct(port_fleet):
    carry_m, q0_m, obs_m, info = port_fleet
    assert info["draws"] == 4 and info["n_procs"] == 2 and info["planned"] >= 2
    assert info["plans_per_s"] > 0 and info["wall_s"] > 0
    assert info["launches"]["chol_inverse"] == info["launches"]["line_polytope"] == 0
    assert 1 <= len(info["launches"]["per_worker"]) <= 2

    direct, draw = [], 0
    while len(direct) < 2:
        draw += 1
        obstacles, goal = fleet.random_scene(np.random.default_rng(3 + 1000 * draw), 2)
        out = fleet.plan_scene(fleet.DEMO_Q0.copy(), goal, obstacles, 3 + draw, CFG,
                               np.float64, device="cpu", plan_dtype=torch.float64)
        if out is not None:
            direct.append(out)
    carry_d, obs_d = tree_stack([d[0] for d in direct]), tree_stack([d[1] for d in direct])
    tree_map(np.testing.assert_array_equal, carry_m, carry_d)
    tree_map(np.testing.assert_array_equal, obs_m, obs_d)
    np.testing.assert_array_equal(q0_m, np.broadcast_to(fleet.DEMO_Q0, (2, 7)))


def test_build_and_save_routes_large_fleets_to_mp(tmp_path, monkeypatch):
    stub = fleet_cache.load(TEST8)
    calls = []

    def fake_mp(batch, cfg, **kw):
        calls.append((batch, kw))
        return stub["carry"], stub["q0"], stub["obs"], {"planned": batch, "plans_per_s": 1.0}

    monkeypatch.setattr(fleet, "build_fleet_mp", fake_mp)
    out = str(tmp_path / "big.pkl")
    payload = fleet_cache.build_and_save(512, 7, out, device="cpu")
    assert calls and calls[0][0] == 512 and calls[0][1]["device"] == torch.device("cpu")
    assert payload["broker_stats"] == {"planned": 512, "plans_per_s": 1.0}
    assert fleet_cache.load(out)["broker_stats"]["planned"] == 512


def test_ensure_loads_or_builds_in_a_subprocess(tmp_path, monkeypatch):
    monkeypatch.setattr(fleet_cache, "cache_path",
                        lambda b, s, n, root=None: str(tmp_path / f"fleet_b{b}_s{s}_segs{n}.pkl"))
    runs = []

    def fake_run(cmd, check, timeout, cwd):
        runs.append((cmd, check, timeout, cwd))
        shutil.copy(TEST8, cmd[5])

    monkeypatch.setattr(fleet_cache.subprocess, "run", fake_run)
    path = str(tmp_path / "fleet_b2_s7_segs4.pkl")
    payload = fleet_cache.ensure(2, 7, 4, timeout=60.0, device="cpu")
    assert runs == [([sys.executable, "-m", "boundplanner_tpu_torch.parallel.fleet_cache",
                      "2", "7", path, "--device", "cpu"], True, 60.0, ROOT)]
    assert payload["schema"] == fleet_cache.SCHEMA and os.path.exists(path)
    again = fleet_cache.ensure(2, 7, 4, device="cpu")           # the file exists now
    assert len(runs) == 1
    np.testing.assert_array_equal(again["q0"], payload["q0"])
    assert not os.path.exists(os.path.join(ROOT, ".fleet_cache", "fleet_b2_s7_segs4.pkl"))


def test_card_default_worker_count(monkeypatch):
    """Without ``n_procs``, a card gets ``CARD_PROCS`` workers however many
    cores the host has; the CPU gets one per core."""
    seen = []

    class Stop(Exception):
        pass

    class Ctx(_InlineContext):
        def Pool(self, processes, initializer, initargs):
            seen.append(processes)
            raise Stop

    monkeypatch.setattr(multiprocessing, "get_context", lambda method: Ctx())
    monkeypatch.setattr(fleet.os, "cpu_count", lambda: 64)
    monkeypatch.setattr(fleet, "checked_device", lambda d: torch.device(d))
    monkeypatch.setattr(_build, "build", lambda: None)
    for device in ("cuda", "cpu"):
        with pytest.raises(Stop):
            fleet.build_fleet_mp(2, CFG, device=device)
    assert seen == [fleet.CARD_PROCS, 64]
