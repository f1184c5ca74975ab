"""Re-anchoring after a safe stop, the port's ``BoundMPC`` beside JAX's.

The re-anchor scenarios of tests/test_failure_recovery.py at its
configuration (float64 on the CPU): a parked arm that drifted into the
second window segment re-anchors onto that segment (the sector advances,
phi lands 0.1 into it), and after a NaN fault long enough to exhaust the
fallback horizon and brake to rest, the re-anchored cold solve resumes
tracking once the fault clears. Both controllers take the same
measurements every tick; the error count sequences are equal and every
output agrees within 1e-7 (`test_torch_failure_recovery.Pair`).
"""

import numpy as np
from scipy.spatial.transform import Rotation as R

import jax.numpy as jnp
import torch

from boundplanner_tpu.robot.model import _ik_gauss_newton
from test_torch_failure_recovery import CFG, ERB, FREE, Q0, Z, Pair, Plant, pose_of

torch.set_num_threads(1)


def test_reanchor_projects_onto_nearest_window_segment():
    pose0 = pose_of(Q0)
    r0 = R.from_rotvec(pose0[3:]).as_matrix()
    # two sectors: a short segment 0 (0.05 m), then segment 1 (0.3 m)
    vias = [pose0[:3].copy(), pose0[:3] + np.array([0.0, -0.05, 0.0]),
            pose0[:3] + np.array([0.0, -0.35, 0.0])]
    pair = Pair(vias, [r0] * 3, [Z, Z], [Z, Z], [ERB, ERB], [FREE[0]] * 2, [FREE[1]] * 2,
                p0=pose0)
    parked = pose0.copy()
    parked[1] -= 0.15                # the arm stands 0.1 into segment 1
    q_park = np.asarray(_ik_gauss_newton(jnp.asarray(parked[:3]), jnp.asarray(r0),
                                         jnp.asarray(Q0)))
    pose_park = pose_of(q_park)
    np.testing.assert_allclose(pose_park[:3], parked[:3], atol=1e-5)
    pair.forge_parked(CFG.n - 2)
    zeros = np.zeros(7)
    pair.step(q_park, zeros, zeros, pose_park, np.zeros(6), zeros)
    assert int(pair.port.carry.path.sector) == int(pair.jax.carry.path.sector) == 1
    phi, jphi = float(pair.port.carry.phi_current), float(pair.jax.carry.phi_current)
    assert abs(phi - jphi) <= 1e-7 and 0.10 < phi < 0.30, (phi, jphi)


def test_reanchor_recovers_after_safe_stop():
    pose0 = pose_of(Q0)
    r0 = R.from_rotvec(pose0[3:]).as_matrix()
    # a path long against the braking drift: the in-scan re-anchor's case
    pair = Pair([pose0[:3].copy(), pose0[:3] + np.array([0.0, -1.0, 0.0])], [r0, r0],
                [Z], [Z], [ERB], [FREE[0]], [FREE[1]], p0=pose0)
    plant = Plant()
    for _ in range(2):
        plant.apply(pair.step(*plant.measure()))
    assert pair.port.error_count == 0
    for _ in range(CFG.n + 12):      # a NaN fault: exhaust the fallback, brake to rest
        plant.apply(pair.step(*plant.measure(nan=True)))
    assert pair.port.error_count >= CFG.n - 2
    assert np.max(np.abs(plant.dq)) < 0.1
    recovered_at, phis = None, []
    for t in range(15):
        traj = pair.step(*plant.measure())
        plant.apply(traj)
        if pair.port.error_count == 0 and recovered_at is None:
            recovered_at = t
        if recovered_at is not None:
            phis.append(float(traj["phi"][0]))
    assert recovered_at is not None, pair.counts
    assert pair.port.error_count <= 1
    assert phis[-1] > phis[0] - 1e-6, phis
    assert np.isfinite(plant.q).all()
