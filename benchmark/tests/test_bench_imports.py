"""Nothing the benchmark runs imports ``jax``, ``jaxlib``, ``flax`` or
``boundplanner_tpu``, by top-level names compared whole."""

import os
import subprocess
import sys

from benchmark import harness


def test_forbidden_names_compared_whole():
    mods = ["boundplanner_tpu_torch", "boundplanner_tpu_torch.mpc", "jaxtyping", "flaxen",
            "numpy"]
    assert harness.forbidden_modules(mods) == []
    assert harness.forbidden_modules(mods + ["boundplanner_tpu.ops.qp"]) == ["boundplanner_tpu"]
    assert harness.forbidden_modules(["jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib"]


def test_benchmark_modules_import_nothing_forbidden():
    """A fresh interpreter imports every module the benchmark runs (the
    harness, the drivers with the program's entry points, the reference,
    every metric reader) and finds no forbidden module loaded."""
    code = f"""
import glob, os, sys
sys.path.insert(0, {harness.ROOT!r})
from benchmark import harness, tracing, yardstick, control
from benchmark.reference import fleet, arm
import boundplanner_tpu_torch.parallel.batch, boundplanner_tpu_torch.parallel.fleet_cache
import boundplanner_tpu_torch.mpc.node, boundplanner_tpu_torch.mpc.bound_mpc
man = harness.manifest()
for w in man["workloads"]:
    harness.driver(harness.cell(man, w["name"])["traffic"])
for m in man["end_to_end"] + man["per_layer"]:
    harness.reader(m["name"])
found = harness.forbidden_modules()
print("FOUND", found)
sys.exit(1 if found else 0)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_reference_imports_nothing_of_the_program():
    code = f"""
import sys
sys.path.insert(0, {harness.ROOT!r})
from benchmark.reference import fleet, arm
bad = sorted({{m.split('.')[0] for m in sys.modules}} & {{'boundplanner_tpu', 'boundplanner_tpu_torch', 'jax'}})
print(bad)
sys.exit(1 if bad else 0)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
