"""The port's ``MPCNode`` reproduces the golden tracking trajectory.

The scenario of tests/test_golden_regression.py (the demo pose, one free
segment 0.05/-0.2/-0.05 m away with a 20 degree turn, the default
``MPCParams()`` in float64) runs 8 ticks on the CPU through the port;
q and phi after every tick match ``tests/golden/tracking_v1.npz`` within
atol 1e-6, the reference's own bar. The file is only read.
"""

import pathlib

import numpy as np
from scipy.spatial.transform import Rotation as R

import torch

from boundplanner_tpu_torch.mpc import MPCNode

torch.set_num_threads(1)
GOLDEN = pathlib.Path(__file__).parent / "golden" / "tracking_v1.npz"
N_TICKS = 8


def run_scenario():
    q0 = np.array([0.0, 0.0, 0.0, -np.pi / 2, 0.0, np.pi / 2, 0.0])
    node = MPCNode(q0, device="cpu", dtype=torch.float64)
    p0 = node.p0.copy()
    r0 = R.from_rotvec(np.array(p0[3:])).as_matrix()
    r1 = R.from_euler("z", 20, degrees=True).as_matrix() @ r0
    node.update_reference(
        [p0[:3].copy(), p0[:3] + np.array([0.05, -0.2, -0.05])],
        [r0, r1],
        [np.array([0.0, 0.0, 1.0])],
        [np.array([0.0, 0.0, 1.0])],
        [np.array([90, 90, 90, -90, -90, -90]) * np.pi / 180],
        [np.zeros((15, 3))],
        [np.ones(15)],
        [],
    )
    qs, phis = [], []
    for _ in range(N_TICKS):
        node.step()
        qs.append(node.q.copy())
        phis.append(float(node.mpc.phi_current[0]))
    return np.array(qs), np.array(phis)


def test_matches_golden():
    data = np.load(GOLDEN)
    qs, phis = run_scenario()
    np.testing.assert_allclose(qs, data["qs"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(phis, data["phis"], rtol=0, atol=1e-6)
