"""The port's numeric edges against the JAX package, float64 on the CPU:

- the rest of ``ops/linalg.py`` (triangular solves, ``chol_solve``,
  ``spd_solve``, ``blocked_cholesky``/``blocked_invert_lower`` at nb = 34)
  on seeded SPD matrices, n = 8 and 136, unbatched and batched (JAX under
  ``vmap``), within 1e-10;
- ``mpc/bounds.py``: the cases of tests/test_bounds.py and seeded random
  ones, plus the interpolation conditions themselves. The coefficients
  agree within 1e-12 of the largest, or within cond(V) x eps where the
  confluent-Vandermonde system V is worse conditioned than 1e-12 / eps
  (two LAPACK solves of one system agree only to that: a 6th-order case
  on [0.96, 1.77] has cond 7.2e6 and differs by 2.4e-12 relative);
- ``mpc/flops.py``: ``solve_flops`` equal to JAX's dict for dict (same
  integers, same float arithmetic) for dense, flat and chunked
  configurations of ``perf_mpc_params()`` and ``MPCParams()``, and
  ``ocp_struct.layout`` equal to the counts of JAX's chunked ``OCPStruct``;
  the port's chunked structure (split, column support, Grams) against it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boundplanner_tpu.config import MPCParams, perf_mpc_params
from boundplanner_tpu.mpc import bounds as jbounds
from boundplanner_tpu.mpc.flops import solve_flops as jax_solve_flops
from boundplanner_tpu.mpc.ocp_struct import build as jax_build_struct
from boundplanner_tpu.ops import linalg as jlin
from boundplanner_tpu_torch import config as tconfig
from boundplanner_tpu_torch.mpc import bounds as tbounds
from boundplanner_tpu_torch.mpc import ocp_struct as tstruct
from boundplanner_tpu_torch.mpc.flops import solve_flops
from boundplanner_tpu_torch.ops import linalg as tlin

torch.set_num_threads(1)
LIN_TOL = 1e-10
BOUND_TOL = 1e-12


def spd(rng, n, batch=None):
    shape = (n, n) if batch is None else (batch, n, n)
    a = rng.normal(size=shape)
    return a @ np.swapaxes(a, -1, -2) + n * np.eye(n)


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


# --- ops/linalg.py ----------------------------------------------------------

@pytest.mark.parametrize("n", [8, 136])
def test_triangular_solves_match_jax(n):
    rng = np.random.default_rng(n)
    a = spd(rng, n)
    b = rng.normal(size=n)
    l = np.linalg.cholesky(a)
    for name in ("solve_lower", "solve_upper_t", "chol_solve"):
        got = getattr(tlin, name)(t64(l), t64(b)).numpy()
        ref = np.asarray(getattr(jlin, name)(jnp.asarray(l), jnp.asarray(b)))
        np.testing.assert_allclose(got, ref, rtol=0, atol=LIN_TOL, err_msg=name)
    got = tlin.spd_solve(t64(a), t64(b)).numpy()
    np.testing.assert_allclose(got, np.asarray(jlin.spd_solve(jnp.asarray(a), jnp.asarray(b))),
                               rtol=0, atol=LIN_TOL)
    np.testing.assert_allclose(a @ got, b, rtol=0, atol=1e-8)


def test_batched_solves_match_jax_vmap():
    rng = np.random.default_rng(3)
    a = spd(rng, 24, batch=5)
    b = rng.normal(size=(5, 24))
    got = tlin.spd_solve(t64(a), t64(b)).numpy()
    ref = np.asarray(jax.vmap(jlin.spd_solve)(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=LIN_TOL)


def test_spd_solve_keeps_the_pivot_clamp():
    """A zero pivot is clamped to sqrt(1e-30), as in JAX: finite and equal."""
    a = np.diag([4.0, 0.0, 9.0])
    b = np.array([1.0, 0.0, 3.0])
    got = tlin.spd_solve(t64(a), t64(b)).numpy()
    ref = np.asarray(jlin.spd_solve(jnp.asarray(a), jnp.asarray(b)))
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n", [68, 136])
def test_blocked_cholesky_and_inverse_match_jax(n):
    rng = np.random.default_rng(n + 1)
    a = spd(rng, n)
    l = tlin.blocked_cholesky(t64(a), nb=34)
    l_ref = jlin.blocked_cholesky(jnp.asarray(a), nb=34)
    np.testing.assert_allclose(l.numpy(), np.asarray(l_ref), rtol=0, atol=LIN_TOL)
    li = tlin.blocked_invert_lower(l, nb=34).numpy()
    li_ref = np.asarray(jlin.blocked_invert_lower(l_ref, nb=34))
    np.testing.assert_allclose(li, li_ref, rtol=0, atol=LIN_TOL)
    np.testing.assert_allclose(li @ l.numpy(), np.eye(n), rtol=0, atol=1e-8)


def test_blocked_batched_match_jax_vmap():
    rng = np.random.default_rng(11)
    a = spd(rng, 68, batch=3)
    l = tlin.blocked_cholesky(t64(a), nb=34)
    l_ref = jax.vmap(lambda m: jlin.blocked_cholesky(m, nb=34))(jnp.asarray(a))
    np.testing.assert_allclose(l.numpy(), np.asarray(l_ref), rtol=0, atol=LIN_TOL)
    li = tlin.blocked_invert_lower(l, nb=34).numpy()
    li_ref = np.asarray(jax.vmap(lambda m: jlin.blocked_invert_lower(m, nb=34))(l_ref))
    np.testing.assert_allclose(li, li_ref, rtol=0, atol=LIN_TOL)


def test_blocked_needs_divisible_n():
    with pytest.raises(ValueError):
        tlin.blocked_cholesky(torch.eye(10, dtype=torch.float64), nb=4)
    with pytest.raises(ValueError):
        tlin.blocked_invert_lower(torch.eye(10, dtype=torch.float64), nb=4)


# --- mpc/bounds.py ----------------------------------------------------------

CASES = [
    ("compute_bound_params", (0.3, 1.7, 0.05, 0.12, 0.4, 0.45)),
    ("compute_bound_params_four", (0.1, 2.0, 0.02, 0.3, 0.7, 0.2, 0.5)),
    ("compute_bound_params_six", (0.3, 1.7, 0.05, 0.12, 99.0, 0.45)),
    ("compute_bound_params_three", (0.2, 1.1, 0.04, 0.2, 0.3, -0.8)),
]


def random_case(rng, name):
    phi0 = rng.uniform(0.0, 1.0)
    phi1 = phi0 + rng.uniform(0.5, 2.0)
    rest = {"compute_bound_params": 4, "compute_bound_params_four": 5,
            "compute_bound_params_six": 4, "compute_bound_params_three": 4}[name]
    return (phi0, phi1, *rng.uniform(-0.5, 0.8, rest))


def conditioning(name, args):
    """cond of the family's confluent-Vandermonde matrix at ``args``."""
    from math import factorial

    phi0, phi1 = args[:2]
    mid = 0.5 * (phi0 + phi1)
    degree, conds = {
        "compute_bound_params": (4, [(phi0, 0), (phi1, 0), (phi0, 1), (phi1, 1), (mid, 0)]),
        "compute_bound_params_four": (4, [(phi0, 0), (phi1, 0), (phi0, 1), (phi1, 1), (mid, 0)]),
        "compute_bound_params_six": (6, [(phi0, 0), (phi0, 1), (phi0, 2), (phi1, 0),
                                         (phi1, 1), (phi1, 2), (mid, 0)]),
        "compute_bound_params_three": (3, [(phi0, 0), (phi1, 0), (phi0, 1), (phi0, 2)]),
    }[name]
    rows = [[factorial(p) / factorial(p - o) * t ** (p - o) if p >= o else 0.0
             for p in range(degree, -1, -1)] for t, o in conds]
    return np.linalg.cond(np.array(rows))


@pytest.mark.parametrize("name,args", CASES + [
    (name, random_case(np.random.default_rng(seed), name))
    for seed, (name, _) in enumerate(CASES * 3)])
def test_bound_families_match_jax(name, args):
    got = np.array([float(c) for c in getattr(tbounds, name)(*args, device="cpu")])
    ref = np.array([float(c) for c in getattr(jbounds, name)(*args)])
    assert got.shape == ref.shape
    rel = max(BOUND_TOL, np.finfo(np.float64).eps * conditioning(name, args))
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(1.0, np.abs(ref).max()))


def test_golden_and_conditions():
    """tests/test_bounds.py's golden values and the 4th-order conditions."""
    c = [float(x) for x in tbounds.compute_bound_params(0.3, 1.7, 0.05, 0.12, 0.4, 0.45,
                                                         device="cpu")]
    np.testing.assert_allclose(
        c, [0.93710954, -3.79945856, 4.57163682, -1.41833611, 0.15904831], atol=1e-9)
    p = np.poly1d(c)
    np.testing.assert_allclose([p(0.3), p(1.7), p(1.0), p.deriv()(0.3), p.deriv()(1.7)],
                               [0.05, 0.12, 0.45, 0.4, -0.4], atol=BOUND_TOL)
    c6 = tbounds.compute_bound_params_six(0.3, 1.7, 0.05, 0.12, -3.0, 0.45, device="cpu")
    c6b = tbounds.compute_bound_params_six(0.3, 1.7, 0.05, 0.12, 99.0, 0.45, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(c6, c6b))   # the slope is inert


def test_batched_bounds_match_jax_vmap():
    rng = np.random.default_rng(7)
    phi0 = rng.uniform(0.0, 1.0, 6)
    phi1 = phi0 + rng.uniform(0.5, 2.0, 6)
    e0, e1, s, em = rng.uniform(0.0, 0.5, (4, 6))
    got = torch.stack(tbounds.compute_bound_params(
        torch.as_tensor(phi0), torch.as_tensor(phi1), e0, e1, s, em, device="cpu"), -1)
    ref = jax.vmap(lambda *a: jnp.stack(jbounds.compute_bound_params(*a)))(
        *(jnp.asarray(x) for x in (phi0, phi1, e0, e1, s, em)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-11)


def test_eval_and_fourth_order_bound_match_jax():
    phis = np.linspace(0.0, 2.0, 9)
    coeffs = (2.0, -1.0, 0.5, 0.25)
    np.testing.assert_allclose(tbounds.eval_bound_poly(phis, coeffs, device="cpu").numpy(),
                               np.asarray(jbounds.eval_bound_poly(jnp.asarray(phis), coeffs)),
                               rtol=0, atol=BOUND_TOL)
    args = (0.1, 2.0, 0.02, 0.3, 0.7, 0.2, 0.5)
    got = tbounds.fourth_order_error_bound(phis, *args, device="cpu").numpy()
    ref = np.asarray(jbounds.fourth_order_error_bound(jnp.asarray(phis), *args))
    np.testing.assert_allclose(got, ref, rtol=0, atol=BOUND_TOL)


# --- mpc/flops.py -----------------------------------------------------------

MODES = {
    "dense": dict(struct_ocp=False),
    "flat": dict(struct_ocp=True, struct_chunked=False),
    "chunked": dict(struct_ocp=True, struct_chunked=True),
}


@pytest.mark.parametrize("base", ["perf", "default"])
@pytest.mark.parametrize("mode", list(MODES))
def test_solve_flops_equals_jax(base, mode):
    jcfg = perf_mpc_params() if base == "perf" else MPCParams()
    tcfg = tconfig.perf_mpc_params() if base == "perf" else tconfig.MPCParams()
    got = solve_flops(dataclasses.replace(tcfg, **MODES[mode]))
    ref = jax_solve_flops(dataclasses.replace(jcfg, **MODES[mode]))
    assert got == ref


def test_flop_model_orderings():
    """tests/test_flops_model.py's invariants, on the port's model."""
    fd, ff, fc = (solve_flops(dataclasses.replace(tconfig.perf_mpc_params(), **MODES[m]))
                  for m in ("dense", "flat", "chunked"))
    assert fc["total"] < ff["total"] < fd["total"]
    assert 1.4 < fd["total"] / ff["total"] < 1.8
    assert fd["total"] / fc["total"] > 2.0
    assert fd["factorization"] == ff["factorization"] == fc["factorization"]


@pytest.mark.parametrize("n", [6, 15])
def test_layout_counts_equal_jax_struct(n):
    st = jax_build_struct(n, 0.1)
    lay = tstruct.layout(n)
    assert (lay.nx, lay.o, lay.m_run, lay.m_r, lay.m_tail, lay.n_slack) == (
        st.nx, st.o, st.m_run, st.m_r, st.m_tail, st.n_slack)
    assert (lay.per_step_g, lay.per_step_r, lay.n_term_g, lay.n_term_r) == (
        st.per_step_g, st.per_step_r, st.n_term_g, st.n_term_r)
    assert (lay.half, lay.n_cols_a, lay.n_b_slack) == (
        st.half, len(st.cols_a), st.b_slack.shape[0])


def test_chunked_structure_still_refused():
    """The chunked structure the counts describe, against JAX's: the same
    split and column support, and its runtime Grams (the causal chunk
    split) equal to JAX's within 1e-12 of the largest entry on seeded
    matrices of the full row layout."""
    jst = jax_build_struct(15, 0.1, chunked=True)
    st = tstruct.build(15, 0.1, chunked=True)
    lay = tstruct.layout(15)
    assert st.chunked and st.half == jst.half == lay.half
    np.testing.assert_array_equal(st.cols_a.numpy(), jst.cols_a)
    assert (st.m_link, st.m_dense) == (jst.m_link, jst.m_dense)
    rng = np.random.default_rng(15)
    g = rng.normal(size=(2, st.m_run, st.nx))
    w = rng.uniform(0.1, 10.0, size=(2, st.m_run))
    j = rng.normal(size=(2, st.m_r, st.nx))
    for got, ref in ((st.gram_g(torch.from_numpy(g), torch.from_numpy(w)),
                      jax.vmap(jst.gram_g)(g, w)),
                     (st.gram_r(torch.from_numpy(j)), jax.vmap(jst.gram_r)(j))):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12 * np.abs(ref).max())


def test_flops_cli_runs():
    import subprocess
    import sys

    proc = subprocess.run([sys.executable, "-m", "boundplanner_tpu_torch.mpc.flops"],
                          capture_output=True, text=True, timeout=120,
                          cwd=str(__import__("pathlib").Path(__file__).resolve().parents[1]))
    assert proc.returncode == 0, proc.stderr
    assert "chunked:" in proc.stdout.splitlines()[-1]
