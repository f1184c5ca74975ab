"""Fuzz the port's segment switching (the counterpart of
``tests/test_switching_fuzz.py``): randomized multi-segment paths tracked
by ``MPCNode`` in float64 on the CPU; the sector only advances, phi is
continuous within a sector and never moves back, the path is mostly
tracked, at most 3 ticks fall back.

Tier 1 runs seed 0 at the perf configuration (3 SQP x 4 IPM iterations,
the structured QP: ~0.3 s a tick); the slow test runs the JAX test's
configuration (8 SQP x 15 IPM iterations, dense QP) at its seeds 0 and 1.
"""

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as R

from boundplanner_tpu_torch.config import MPCParams, perf_mpc_params
from boundplanner_tpu_torch.demo import DEMO_Q0
from boundplanner_tpu_torch.mpc.node import MPCNode

torch.set_num_threads(1)
JAX_CFG = MPCParams(sqp_iters=8, qp_iters=15, line_search_steps=4)


def run_random_path(seed, cfg):
    rng = np.random.default_rng(seed)
    node = MPCNode(DEMO_Q0.copy(), params=cfg, device="cpu", dtype=torch.float64)
    p0 = node.p0.copy()
    r0 = R.from_rotvec(np.array(p0[3:])).as_matrix()

    # 4 random via points in a reachable envelope around the start
    p_via = [p0[:3].copy()]
    for _ in range(3):
        step = rng.uniform(-0.12, 0.12, 3)
        step[2] = rng.uniform(-0.08, 0.05)
        p_via.append(p_via[-1] + step)
    rots = [r0]
    for _ in range(3):
        rots.append(R.from_euler("z", rng.uniform(-15, 15), degrees=True).as_matrix() @ rots[-1])

    nseg = len(p_via) - 1
    node.update_reference(
        p_via, rots, [np.array([0.0, 0.0, 1.0])] * nseg, [np.array([0.0, 0.0, 1.0])] * nseg,
        [np.array([90, 90, 90, -90, -90, -90]) * np.pi / 180] * nseg,
        [np.zeros((15, 3))] * nseg, [np.ones(15)] * nseg, [])

    sectors, phis = [], []
    for _ in range(45):
        node.step()
        sectors.append(int(np.asarray(node.mpc.carry.path.sector)))
        phis.append(float(node.mpc.phi_current[0]))
        if phis[-1] >= float(node.mpc.phi_max[0]) - 0.003:
            break

    sectors = np.array(sectors)
    phis = np.array(phis)
    # sector only ever advances
    assert np.all(np.diff(sectors) >= 0)
    # phi continuity WITHIN a sector (across a switch phi re-projects onto
    # the next segment and may legitimately jump forward)
    within = np.abs(np.diff(phis))[np.diff(sectors) == 0]
    if within.size:
        assert within.max() < 0.08
    # never moves backwards meaningfully
    assert np.min(np.diff(phis)) > -0.02
    # made real progress through multiple sectors or reached the end
    assert phis[-1] > 0.5 * float(node.mpc.phi_max[0])
    assert sum(node.fails) <= 3  # transient, recovered
    return sectors


def test_random_multisegment_path_perf_config():
    sectors = run_random_path(0, perf_mpc_params())
    assert sectors[-1] >= 1          # the fuzzed path really switched


@pytest.mark.slow
@pytest.mark.parametrize("seed", [0, 1])
def test_random_multisegment_path(seed):
    run_random_path(seed, JAX_CFG)
