"""The planner's numeric leaves in the port against the JAX package, in
float64 on the CPU: ``ops.qp.solve_feasibility`` (cold, warm-started, and
the padded-row regimes of ``tests/test_qp.py``), ``ops.qp.solve_projection``
and the three MVIE variants of ``ops.mvie``.

Tolerance 1e-8: the same algorithms with the same fixed trip counts; the
port solves a batch at once and takes the MVIE's Newton derivatives in
closed form where JAX uses autodiff, so results differ by summation order
only (measured ~1e-15, and ~1e-11 on the fixed-orientation MVIE, whose
Newton systems are the worst conditioned).
"""

import importlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from boundplanner_tpu_torch.ops import qp as tqp

jqp = importlib.import_module("boundplanner_tpu.ops.qp")
jmvie = importlib.import_module("boundplanner_tpu.ops.mvie")
# the module, not the function of the same name that ``ops`` exports
tmvie = importlib.import_module("boundplanner_tpu_torch.ops.mvie")

torch.set_num_threads(1)
TOL = 1e-8


def t64(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a, dtype=np.float64)) for a in arrays]


def close(got, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=tol, atol=tol)


def polytope(rng, m=10, rows=48, box=0.8):
    """Random rows around the origin plus a workspace box, padded with
    inactive rows (a = 0, b = 10) as the planner pads to FIT_ROWS."""
    a = rng.normal(size=(m, 3))
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    b = rng.uniform(0.2, 0.6, m)
    a = np.vstack([a, np.eye(3), -np.eye(3)])
    b = np.concatenate([b, np.full(6, box)])
    a_p = np.zeros((rows, 3))
    b_p = np.full(rows, 10.0)
    a_p[: len(b)] = a
    b_p[: len(b)] = b
    return a_p, b_p


@pytest.mark.parametrize("warm", [False, True])
def test_solve_feasibility_matches_jax(warm):
    rng = np.random.default_rng(11)
    a, b = map(np.stack, zip(*[polytope(rng) for _ in range(4)]))
    b[1] -= 0.7                                   # an empty polytope: t > 0
    x0 = rng.uniform(-0.5, 0.5, (4, 3))
    x, t, sol = tqp.solve_feasibility(*t64(a, b), x0=t64(x0)[0] if warm else None)
    for i in range(4):
        xj, tj, _ = jqp.solve_feasibility(jnp.asarray(a[i]), jnp.asarray(b[i]),
                                          x0=jnp.asarray(x0[i]) if warm else None)
        close(x[i], xj)
        close(t[i], tj)
    assert float(t[1]) > 0 and float(t[0]) < 0


def test_solve_feasibility_padded_and_unbounded_rows_match_jax():
    """The regimes of `tests/test_qp.py::test_feasibility_unbounded_polytope`:
    a bare half-space drifts to the -1/(2 eps) scale, padding rows clamp t
    at -10, a box restores a strictly feasible answer."""
    g1, h1 = np.array([[1.0, 0.0, 0.0]]), np.array([0.0])
    g = np.zeros((8, 3))
    g[0] = [1.0, 0.0, 0.0]
    h = 10.0 * np.ones(8)
    h[0] = 0.0
    g_box = np.vstack([g, np.eye(3), -np.eye(3)])
    h_box = np.concatenate([h, np.ones(6)])
    for gg, hh in ((g1, h1), (g, h), (g_box, h_box)):
        x, t, _ = tqp.solve_feasibility(*t64(gg[None], hh[None]))
        xj, tj, _ = jqp.solve_feasibility(jnp.asarray(gg), jnp.asarray(hh))
        assert np.all(np.isfinite(x.numpy())) and np.isfinite(float(t[0]))
        close(x[0], xj)
        close(t[0], tj)
    np.testing.assert_allclose(float(tj), float(t[0]))


def test_solve_projection_matches_jax():
    rng = np.random.default_rng(12)
    a, b = map(np.stack, zip(*[polytope(rng) for _ in range(5)]))
    target = rng.uniform(-1.5, 1.5, (5, 3))
    target[0] = 0.0                               # already inside
    sol = tqp.solve_projection(*t64(a, b, target))
    for i in range(5):
        ref = jqp.solve_projection(jnp.asarray(a[i]), jnp.asarray(b[i]), jnp.asarray(target[i]))
        close(sol.x[i], ref.x)
        assert bool(sol.success[i]) == bool(ref.success)


def mvie_instances(seed, count=4, m=12):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        a = rng.normal(size=(m, 3))
        a /= np.linalg.norm(a, axis=1, keepdims=True)
        b = rng.uniform(0.5, 1.5, m)
        out.append((np.vstack([a, np.eye(3), -np.eye(3)]), np.concatenate([b, np.full(6, 2.0)])))
    return map(np.stack, zip(*out))


def check_result(res, ref, i):
    close(res.shape[i], ref.shape)
    close(res.center[i], ref.center)
    close(res.gen[i], ref.gen)
    assert bool(res.ok[i]) == bool(ref.ok)


@pytest.mark.parametrize("seeded", [False, True])
def test_mvie_matches_jax(seeded):
    a, b = mvie_instances(3)
    d0 = np.full((4, 3), 0.05)
    res = tmvie.mvie(*t64(a, b), d0=t64(d0)[0] if seeded else None)
    for i in range(4):
        ref = jmvie.mvie(jnp.asarray(a[i]), jnp.asarray(b[i]),
                         jnp.asarray(d0[i]) if seeded else None)
        assert bool(ref.ok)
        check_result(res, ref, i)


def test_mvie_fixed_mid_matches_jax():
    a, b = mvie_instances(4)
    d = np.random.default_rng(5).uniform(-0.2, 0.2, (4, 3))
    res = tmvie.mvie_fixed_mid(*t64(a, b, d))
    for i in range(4):
        ref = jmvie.mvie_fixed_mid(jnp.asarray(a[i]), jnp.asarray(b[i]), jnp.asarray(d[i]))
        assert bool(ref.ok)
        check_result(res, ref, i)


def test_mvie_fixed_r_matches_jax():
    a, b = mvie_instances(6)
    rng = np.random.default_rng(7)
    d = rng.uniform(-0.2, 0.2, (4, 3))
    r = np.stack([np.linalg.qr(rng.normal(size=(3, 3)))[0] for _ in range(4)])
    lb = rng.uniform(0.05, 0.3, 4)
    res = tmvie.mvie_fixed_r(*t64(a, b, d, r, lb))
    for i in range(4):
        ref = jmvie.mvie_fixed_r(jnp.asarray(a[i]), jnp.asarray(b[i]), jnp.asarray(d[i]),
                                 jnp.asarray(r[i]), lb[i])
        assert bool(ref.ok)
        check_result(res, ref, i)


@pytest.mark.parametrize("variant", ["free", "fixed_mid", "fixed_r"])
def test_mvie_infeasible_seed_matches_jax(variant):
    """A seed outside the polytope must give ok=False. The barrier's Hessian
    is NaN there (0/0 at the 1e-300 floor, as jax.hessian gives), so the
    Newton iterate stays at its start in both packages."""
    a, b = mvie_instances(8, count=2)
    d = np.array([[5.0, 5.0, 5.0], [0.0, 0.0, 3.0]])
    if variant == "free":
        res = tmvie.mvie(*t64(a, b), d0=t64(d)[0])
        refs = [jmvie.mvie(jnp.asarray(a[i]), jnp.asarray(b[i]), jnp.asarray(d[i]))
                for i in range(2)]
    elif variant == "fixed_mid":
        res = tmvie.mvie_fixed_mid(*t64(a, b, d))
        refs = [jmvie.mvie_fixed_mid(jnp.asarray(a[i]), jnp.asarray(b[i]), jnp.asarray(d[i]))
                for i in range(2)]
    else:
        r = np.stack([np.eye(3)] * 2)
        res = tmvie.mvie_fixed_r(*t64(a, b, d, r, np.full(2, 0.1)))
        refs = [jmvie.mvie_fixed_r(jnp.asarray(a[i]), jnp.asarray(b[i]), jnp.asarray(d[i]),
                                   jnp.asarray(r[i]), 0.1) for i in range(2)]
    for i, ref in enumerate(refs):
        assert not bool(ref.ok)
        check_result(res, ref, i)
