"""Failure detection and recovery, the port's ``BoundMPC`` beside JAX's.

The scenarios of tests/test_failure_recovery.py at its configuration
(3 SQP x 8 IPM iterations, 3 line-search candidates, float64 on the CPU):
a NaN joint measurement makes the solve fail, the fallback replays the
previous trajectory shifted one step, and the error count resets once
the measurement is good again; a persistent NaN measurement exhausts the
fallback horizon and the arm brakes to rest. Both controllers take the
same measurements every tick (the plant is driven by the port's jerk);
the error count sequences are equal and every output agrees within 1e-7.
The re-anchor scenarios are in tests/test_torch_failure_reanchor.py.
"""

import numpy as np
from scipy.spatial.transform import Rotation as R

import jax.numpy as jnp
import torch

from boundplanner_tpu.config import MPCParams as JParams
from boundplanner_tpu.mpc.bound_mpc import BoundMPC as JBoundMPC
from boundplanner_tpu.robot import kinematics as jkin
from boundplanner_tpu.utils.integration import integrate_jerk_step
from boundplanner_tpu_torch.config import MPCParams
from boundplanner_tpu_torch.mpc import BoundMPC

torch.set_num_threads(1)
Q0 = np.array([0.0, 0.0, 0.0, -np.pi / 2, 0.0, np.pi / 2, 0.0])
SMALL = dict(sqp_iters=3, qp_iters=8, line_search_steps=3)
CFG = MPCParams(**SMALL)
TOL = 1e-7
ERB = np.array([90, 90, 90, -90, -90, -90]) * np.pi / 180
Z = np.array([0.0, 0.0, 1.0])
FREE = (np.zeros((15, 3)), np.ones(15))


def pose_of(q):
    return np.array(jkin.fk_pose(jnp.asarray(q)))


class Pair:
    """JAX's and the port's ``BoundMPC`` built from the same arguments;
    ``step`` feeds both one measurement and holds the port to JAX."""

    def __init__(self, *args, p0):
        self.jax = JBoundMPC(*args, obstacles=[], p0=p0, params=JParams(**SMALL))
        self.port = BoundMPC(*args, obstacles=[], p0=p0, params=CFG, device="cpu",
                             dtype=torch.float64)
        self.counts = []

    def step(self, q, dq, ddq, pose, v, jerk):
        j = self.jax.step(q, dq, ddq, pose, v, jerk)
        t = self.port.step(q, dq, ddq, pose, v, jerk)
        assert t[1]["success"] == j[1]["success"]
        assert self.port.error_count == self.jax.error_count
        for key in ("q", "dq", "ddq", "dddq", "p", "v", "phi", "dphi"):
            np.testing.assert_allclose(t[0][key], j[0][key], rtol=0, atol=TOL, err_msg=key)
        np.testing.assert_allclose(t[1]["p"], j[1]["p"], rtol=0, atol=TOL)
        self.counts.append(self.port.error_count)
        return t[0]

    def forge_parked(self, error_count):
        """A parked state: fallback horizon exhausted, previous solution kept."""
        self.jax.carry = self.jax.carry._replace(
            error_count=jnp.asarray(error_count, jnp.int32), has_prev=jnp.asarray(True))
        self.port.carry = self.port.carry._replace(
            error_count=torch.tensor(error_count, dtype=torch.int32),
            has_prev=torch.tensor(True))


class Plant:
    """The arm: q, dq, ddq integrated from the port's commanded jerk."""

    def __init__(self, dq=None):
        self.q, self.dq, self.ddq = Q0.copy(), np.zeros(7) if dq is None else dq, np.zeros(7)
        self.jerk = np.zeros(7)

    def measure(self, nan=False):
        pose = pose_of(self.q)
        jac = np.array(jkin.jacobian_fk(jnp.asarray(self.q)))
        q = self.q.copy()
        if nan:
            q[2] = np.nan
        return q, self.dq, self.ddq, pose, jac @ self.dq, self.jerk

    def apply(self, traj):
        u0, u1 = traj["dddq"][:, 0], traj["dddq"][:, 1]
        self.q, self.dq, self.ddq = (np.asarray(x) for x in integrate_jerk_step(
            jnp.asarray(self.q), jnp.asarray(self.dq), jnp.asarray(self.ddq),
            jnp.asarray(u0), jnp.asarray(u1), CFG.dt))
        self.jerk = u1


def straight_pair(length):
    pose0 = pose_of(Q0)
    r0 = R.from_rotvec(pose0[3:]).as_matrix()
    return Pair([pose0[:3].copy(), pose0[:3] + np.array([0.0, -length, 0.0])], [r0, r0],
                [Z], [Z], [ERB], [FREE[0]], [FREE[1]], p0=pose0)


def test_nan_measurement_falls_back_then_recovers():
    pair = straight_pair(0.2)
    pose0, zeros = pose_of(Q0), np.zeros(7)
    out1 = pair.step(Q0, zeros, zeros, pose0, np.zeros(6), zeros)
    bad = Q0.copy()
    bad[2] = np.nan
    out2 = pair.step(bad, zeros, zeros, pose0, np.zeros(6), zeros)
    # the fallback replays the previous accepted trajectory shifted by one step
    np.testing.assert_allclose(out2["q"][:, 0], out1["q"][:, 1], atol=1e-9)
    pair.step(Q0, zeros, zeros, pose0, np.zeros(6), zeros)
    assert pair.counts == [0, 1, 0]


def test_exhausted_fallback_brakes_to_rest():
    pair = straight_pair(0.2)
    dq = np.zeros(7)
    dq[1] = 0.5                      # real motion, so a stale-jerk replay would run away
    plant = Plant(dq)
    pair.step(*plant.measure())
    speeds = []
    for _ in range(42):
        plant.apply(pair.step(*plant.measure(nan=True)))
        speeds.append(float(np.linalg.norm(plant.dq)))
    assert pair.counts[0] == 0 and pair.counts[1] == 1
    assert pair.port.error_count >= CFG.n - 2
    assert speeds[-1] < 0.02, speeds[-5:]
    assert np.isfinite(plant.q).all() and np.abs(plant.q).max() < 10.0
