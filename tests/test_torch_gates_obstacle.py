"""Gate 1 on the port, on the CPU (``gates.obstacle_run``, the CLI's
``obstacle``): the table + pillar scene planned in float64, ``MPCNode`` at
the perf configuration in float32 toward the path end. The port meets the
JAX gate's bars on the path end (<= 45 ticks), the final error (<= 2 mm)
and the EE outside every original box; its fallbacks are held to the e2e
test's bar (<= 2). The gate's "0 fallbacks" moves with the rounding: one
CPU thread falls back once here, two threads never, and the JAX package's
own ``tools/gate_obstacle.py`` falls back once on this CPU (tick 10, viol
1.23e-4 against the 1e-4 bar)."""

import torch

from boundplanner_tpu_torch import gates

torch.set_num_threads(1)


def test_obstacle_run_meets_the_jax_bars():
    row = gates.obstacle_run("cpu", torch.float32)
    assert row["stopped_by"] == "path_end" and row["path_end_reached"]
    bars = row["bars"]
    assert bars["path_end_within_ticks"] and bars["goal_err_within"], row
    assert bars["ee_outside_boxes"] and row["min_box_margin_m"] > 0.0, row
    assert bars["no_fallbacks"] == (row["fails"] == 0)
    assert row["passed"] == all(bars.values())
    assert row["fails"] <= 2 and row["goal_err_m"] < 2e-3
