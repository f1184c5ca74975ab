"""The port's runtime examples (``boundplanner_tpu_torch/examples``) on the
CPU at a reduced budget (2 SQP x 6 IPM iterations): ``rviz_bringup.main``
publishes 2 ticks headless and returns its tick count (as
tests/test_ros_compat.py runs the JAX script), its telemetry payloads equal
JAX's ``mpc_data_dict`` of the same records and validate against the
port's IDL; ``fleet_example.main`` plans one scene and rolls it out for 2
ticks; every example's command line parses.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from boundplanner_tpu import ros_compat as jrc
from boundplanner_tpu.telemetry import MPCTickRecord as JRecord
from boundplanner_tpu_torch import config as tconfig
from boundplanner_tpu_torch import idl
from boundplanner_tpu_torch.examples import fleet_example, rviz_bringup
from boundplanner_tpu_torch.ros_compat import RosPublisher

torch.set_num_threads(1)
SMALL = dict(sqp_iters=2, qp_iters=6, line_search_steps=2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ["boundplanner_example", "boundplanner_with_mpc_example", "fleet_example",
            "rviz_bringup"]
FLAT = ("phi", "dphi", "fails")   # flattened to scalars by the JSON transport


class RecordingPublisher(RosPublisher):
    """A headless publisher that keeps what ``publish_tick`` was given and
    returned."""

    def __init__(self):
        super().__init__()
        self.ticks = []
        self.markers = []

    def publish_tick(self, record):
        msg = super().publish_tick(record)
        self.ticks.append((record, msg))
        return msg

    def publish_collision_spheres(self, centers, radii):
        out = super().publish_collision_spheres(centers, radii)
        self.markers.append(out)
        return out


def test_rviz_bringup_publishes_jax_payloads():
    pub = RecordingPublisher()
    assert rviz_bringup.main(max_ticks=2, device="cpu", params=tconfig.MPCParams(**SMALL),
                             pub=pub) == 2
    assert not pub.active and len(pub.ticks) == 2 and len(pub.markers) == 2
    schema = idl.load_msg("MPCData")
    for rec, msg in pub.ticks:
        ref = jrc.mpc_data_dict(JRecord(**vars(rec)))
        assert msg == ref
        assert set(msg) <= set(schema)
        idl.validate(schema, {k: v for k, v in msg.items() if k not in FLAT})
        assert np.isfinite(msg["q"]).all()
    assert all(len(m) == 7 and m[0]["type"] == "SPHERE" for m in pub.markers)


def test_fleet_example_rolls_out():
    out = fleet_example.main(batch=1, ticks=2, device="cpu", params=tconfig.MPCParams(**SMALL))
    assert set(out) == {"success_rate", "mean_phi_final", "solves_per_s"}
    assert 0.0 <= out["success_rate"] <= 1.0
    assert np.isfinite(out["mean_phi_final"]) and out["mean_phi_final"] > 0.0


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_command_line(name):
    proc = subprocess.run([sys.executable, "-m", f"boundplanner_tpu_torch.examples.{name}",
                           "--help"], capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert "--device" in proc.stdout
