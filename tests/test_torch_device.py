"""The port's entry points run on the card unless the caller asks for the
CPU, and a call that asks for the card on a machine without one raises at
once, naming the device: nothing falls back to the CPU. The CLI of the
fleet cache exits non-zero at once under the same condition."""

import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from boundplanner_tpu_torch.config import perf_mpc_params
from boundplanner_tpu_torch.mpc.bound_mpc import FleetMPC
from boundplanner_tpu_torch.parallel import distributed, fleet, fleet_cache
from boundplanner_tpu_torch.parallel.broker import BatchBroker
from boundplanner_tpu_torch.parallel.dryrun import dryrun_multichip
from boundplanner_tpu_torch.parallel.mesh import make_mesh, sharded_rollout
from boundplanner_tpu_torch.planner.device_search import fleet_shortest_paths
from boundplanner_tpu_torch.planner.planner import BoundPlanner
from boundplanner_tpu_torch.planner.roadmap import SetRoadmap
from boundplanner_tpu_torch.utils import tree
from boundplanner_tpu_torch.utils.device import checked_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLEET8 = os.path.join(ROOT, ".fleet_cache", "test8.pkl")
OBSTACLES = [[0.2, -1.0, -0.1, 1.0, 1.0, 0.0]]

ENTRY_POINTS = {
    "BoundPlanner": (BoundPlanner.__init__, "device"),
    "BatchBroker": (BatchBroker.__init__, "device"),
    "FleetMPC": (FleetMPC.__init__, "device"),
    "plan_scene": (fleet.plan_scene, "device"),
    "build_fleet": (fleet.build_fleet, "device"),
    "build_fleet_threaded": (fleet.build_fleet_threaded, "device"),
    "build_fleet_mp": (fleet.build_fleet_mp, "device"),
    "build_and_save": (fleet_cache.build_and_save, "device"),
    "ensure": (fleet_cache.ensure, "device"),
    "load_fleet": (fleet_cache.load_fleet, "device"),
    "fleet_shortest_paths": (fleet_shortest_paths, "device"),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(name):
    fn, arg = ENTRY_POINTS[name]
    assert inspect.signature(fn).parameters[arg].default == "cuda"


def test_fleet_mpc_defaults_to_float32():
    assert inspect.signature(FleetMPC.__init__).parameters["dtype"].default == torch.float32


def test_to_torch_has_no_device_default():
    param = inspect.signature(tree.to_torch).parameters["device"]
    assert param.default is inspect.Parameter.empty
    with pytest.raises(TypeError):
        tree.to_torch(np.zeros(2))


@pytest.fixture
def no_card(monkeypatch):
    """A machine without a CUDA device, whatever this one has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


CALLS = {
    "BoundPlanner": lambda: BoundPlanner(obstacles=OBSTACLES, seed=0),
    "BatchBroker": lambda: BatchBroker(),
    "FleetMPC": lambda: FleetMPC(perf_mpc_params()),
    "plan_scene": lambda: fleet.plan_scene(fleet.DEMO_Q0, [0.5, -0.3, 0.3], OBSTACLES, 0,
                                           perf_mpc_params()),
    "build_fleet": lambda: fleet.build_fleet(2, perf_mpc_params()),
    "build_fleet_threaded": lambda: fleet.build_fleet_threaded(2, perf_mpc_params()),
    "build_fleet_mp": lambda: fleet.build_fleet_mp(2, perf_mpc_params()),
    "build_and_save": lambda: fleet_cache.build_and_save(2, 0, "unused.pkl"),
    "ensure": lambda: fleet_cache.ensure(2, 0, 4),
    "load_fleet": lambda: fleet_cache.load_fleet(FLEET8),
    "fleet_shortest_paths": lambda: fleet_shortest_paths([SetRoadmap(0.0, 0.0, 0.0)]),
    "make_mesh": lambda: make_mesh(),
    "sharded_rollout": lambda: sharded_rollout(*fleet_cache.load_fleet(FLEET8, "cpu"),
                                               perf_mpc_params(), 1, make_mesh()),
    "distributed_rollout": lambda: distributed.distributed_rollout(
        *fleet_cache.load_fleet(FLEET8, "cpu"), perf_mpc_params(), 1),
    "dryrun_multichip": lambda: dryrun_multichip(),
}


@pytest.mark.parametrize("name", list(CALLS))
def test_entry_point_without_card_raises(no_card, name):
    with pytest.raises(RuntimeError, match="cuda"):
        CALLS[name]()


def test_checked_device():
    assert checked_device("cpu") == torch.device("cpu")
    assert checked_device(torch.device("cpu")) == torch.device("cpu")


def test_cpu_when_asked():
    brk = BatchBroker(device="cpu")
    assert brk.device == torch.device("cpu")
    model = FleetMPC(perf_mpc_params(), device="cpu", dtype=torch.float64)
    assert all(b.device.type == "cpu" for b in model.buffers())
    assert {b.dtype for b in model.buffers() if b.is_floating_point()} == {torch.float64}
    carry, q0, _ = fleet_cache.load_fleet(FLEET8, "cpu")
    assert q0.device.type == "cpu" and q0.dtype == torch.float32


def test_fleet_mpc_matches_moved_model():
    """The factory keywords build what ``.to(device, dtype)`` made before:
    the float64 structure cast to the requested dtype."""
    a = FleetMPC(perf_mpc_params(), device="cpu", dtype=torch.float32)
    b = FleetMPC(perf_mpc_params(), device="cpu", dtype=torch.float64).to(torch.float32)
    for (na, ta), (nb, tb) in zip(a.named_buffers(), b.named_buffers()):
        assert na == nb
        assert torch.equal(ta, tb)


def test_cli_without_device_fails_fast_without_card(tmp_path):
    out = tmp_path / "fleet.pkl"
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "boundplanner_tpu_torch.parallel.fleet_cache", "2", "0", str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "cuda" in proc.stderr
    assert not out.exists()
