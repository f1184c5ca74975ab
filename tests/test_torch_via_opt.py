"""Via-point optimization in the port against the JAX package, in float64
on the CPU: ``fit_ee_in_set`` (20 rotation fractions as one batched
phase-1 QP) and ``solve_via_rot`` (the generic Gauss-Newton SQP with a
forward-mode Jacobian) for one and two via points, on a corridor of
overlapping boxes padded to the planner's 48 rows.

Tolerance 1e-8 on x and equal success flags: 25 SQP iterations of 30 IPM
iterations each, summation order only (measured ~1e-16).
"""

import importlib

import numpy as np
import pytest
from scipy.spatial.transform import Rotation as R

import jax.numpy as jnp
import torch

from boundplanner_tpu_torch.ops.sqp import jac_fwd
from boundplanner_tpu_torch.planner import via_opt as tvia

jvia = importlib.import_module("boundplanner_tpu.planner.via_opt")

torch.set_num_threads(1)
TOL = 1e-8
ROWS = 48


def box(lo, hi):
    a = np.zeros((ROWS, 3))
    b = np.full(ROWS, 10.0)
    a[:3], a[3:6] = np.eye(3), -np.eye(3)
    b[:3], b[3:6] = hi, -np.asarray(lo)
    return a, b


BOXES = [box([0.0, 0.0, 0.0], [0.5, 0.4, 0.5]),
         box([0.4, 0.0, 0.0], [1.0, 0.4, 0.5]),
         box([0.9, 0.0, 0.0], [1.5, 0.4, 0.5])]


def intersection(i, j):
    a = np.zeros((ROWS, 3))
    b = np.full(ROWS, 10.0)
    a[:6], a[6:12] = BOXES[i][0][:6], BOXES[j][0][:6]
    b[:6], b[6:12] = BOXES[i][1][:6] - 0.001, BOXES[j][1][:6] - 0.001
    return a, b


def rotation():
    r0 = R.from_euler("XYZ", [0, 90, 0], degrees=True).as_matrix()
    r1 = R.from_euler("XYZ", [0, 45, 0], degrees=True).as_matrix()
    omega = R.from_matrix(r1 @ r0.T).as_rotvec()
    norm = np.linalg.norm(omega)
    return r0 @ np.array([-0.05, 0.0, 0.0]), omega / norm, np.asarray(norm)


def via_args(nr_via):
    l_ee, omega_normed, omega_norm = rotation()
    p_start = np.array([0.1, 0.2, 0.25])
    p_end = np.array([0.95 if nr_via == 1 else 1.4, 0.2, 0.3])
    x0 = np.concatenate([[0.45 + 0.5 * i, 0.2, 0.2, 0.5] for i in range(nr_via)])
    a_i, b_i = map(np.stack, zip(*[intersection(i, i + 1) for i in range(nr_via)]))
    a_v, b_v = map(np.stack, zip(*BOXES[: nr_via + 1]))
    return [x0, p_start, p_end, l_ee, omega_normed, omega_norm,
            np.full(nr_via + 1, 0.6), a_i, b_i, a_v, b_v]


@pytest.mark.parametrize("nr_via", [1, 2])
def test_solve_via_rot_matches_jax(nr_via):
    args = via_args(nr_via)
    ref = jvia.solve_via_rot(*[jnp.asarray(a) for a in args], nr_via=nr_via)
    got = tvia.solve_via_rot(*[torch.from_numpy(np.asarray(a))[None] for a in args],
                             nr_via=nr_via)
    np.testing.assert_allclose(got.x[0].numpy(), np.asarray(ref.x), rtol=TOL, atol=TOL)
    assert bool(got.success[0]) == bool(ref.success)
    assert int(got.iters[0]) == int(ref.iters)
    np.testing.assert_allclose(float(got.viol[0]), float(ref.viol), rtol=TOL, atol=TOL)


def test_solve_via_rot_batch_rows_are_independent():
    """Problems of different data in one batch (as the broker coalesces
    them) give what each gives alone."""
    a1, a2 = via_args(1), via_args(1)
    a2[2] = np.array([0.9, 0.25, 0.2])
    both = tvia.solve_via_rot(*[torch.from_numpy(np.stack([x, y])) for x, y in zip(a1, a2)],
                              nr_via=1)
    for i, args in enumerate((a1, a2)):
        one = tvia.solve_via_rot(*[torch.from_numpy(np.asarray(a))[None] for a in args], nr_via=1)
        np.testing.assert_allclose(both.x[i].numpy(), one.x[0].numpy(), rtol=0, atol=1e-12)


def test_jac_fwd_matches_finite_differences():
    """The batched forward-mode Jacobian of the via-rotation residuals and
    constraints against central differences."""
    args = [torch.from_numpy(np.asarray(a))[None] for a in via_args(2)]
    data = args[1:]
    samples = torch.linspace(0.0, 1.0, tvia.N_SEG_SAMPLES + 2, dtype=torch.float64)[1:-1]
    one = tvia._via_rot_problem(2, samples)

    def eval_fn(x):                                     # (B, L, nx)
        r, g = one(x[0, 0], *(d[0] for d in data))
        return r[None, None], g[None, None]

    x = args[0]
    jr, jg = jac_fwd(eval_fn, x)
    h = 1e-6
    for k in range(x.shape[1]):
        e = torch.zeros_like(x)
        e[0, k] = h
        rp, gp = eval_fn((x + e)[:, None])
        rm, gm = eval_fn((x - e)[:, None])
        np.testing.assert_allclose(jr[0, :, k].numpy(), ((rp - rm) / (2 * h))[0, 0].numpy(),
                                   atol=1e-7)
        np.testing.assert_allclose(jg[0, :, k].numpy(), ((gp - gm) / (2 * h))[0, 0].numpy(),
                                   atol=1e-7)


@pytest.mark.parametrize("probe,shift", [
    ([0.2, 0.2, 0.2], 0.0),       # fits at the first fraction
    ([0.49, 0.2, 0.2], 0.0),      # probe near a face: the QP moves it in
    ([0.25, 0.2, 0.25], 0.46),    # box shrunk to a sliver: no fraction fits
])
def test_fit_ee_in_set_matches_jax(probe, shift):
    l_ee, omega_normed, omega_norm = rotation()
    a, b = BOXES[0]
    b = b - 0.001
    b[:6] -= shift * np.array([1, 0, 1, 1, 0, 1])
    ref = jvia.fit_ee_in_set(jnp.asarray(a), jnp.asarray(b), jnp.asarray(l_ee),
                             jnp.asarray(omega_normed), jnp.asarray(omega_norm), jnp.asarray(probe))
    got = tvia.fit_ee_in_set(*[torch.from_numpy(np.asarray(x, np.float64))[None]
                               for x in (a, b, l_ee, omega_normed, omega_norm, probe)])
    assert bool(got[0][0]) == bool(ref[0])
    np.testing.assert_allclose(float(got[1][0]), float(ref[1]), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got[2][0].numpy(), np.asarray(ref[2]), rtol=TOL, atol=TOL)
