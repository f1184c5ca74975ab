"""The port's QP solvers against the JAX package's, float64 on the CPU, for
the branches the MPC's configurations add to the plain IPM:

- ``solve_qp_admm`` (``qp_solver="admm"``);
- ``solve_qp`` with the frozen factor (``kkt_every=2``), the dual warm
  start (``z0``), the paired Mehrotra start (``z0`` + ``warm_sz``) and
  ``warm_sz`` alone (the cold start, by value);
- ``solve_qp`` with the factored link rows (``link``/``h_link``).

Each runs on a batch of 4 random strictly convex QPs (n = 12, m = 30,
feasible, made with numpy from a seed) and on the SQP subproblem of the
demo scene's first tick (136 variables, 1589 runtime + 850 tail rows),
against JAX's jitted solvers in x64 at 1e-9 (the subproblem's duals,
up to ~1e3, relative to their largest entry). The link branch has no
random form: its rows are the OCP's.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from boundplanner_tpu import demo as jdemo
from boundplanner_tpu.config import perf_mpc_params
from boundplanner_tpu.mpc import bound_mpc as jmpc
from boundplanner_tpu.mpc import ocp_jac as jjac
from boundplanner_tpu.mpc import ocp_struct as jstruct
from boundplanner_tpu.ops import qp as jqp
from boundplanner_tpu_torch import config as tconfig
from boundplanner_tpu_torch.mpc.bound_mpc import FleetMPC
from boundplanner_tpu_torch.ops import qp as tqp

torch.set_num_threads(1)
TOL = 1e-9
BATCH, N, M = 4, 12, 30
CFG = perf_mpc_params()
TCFG = tconfig.perf_mpc_params()
QP_ITERS = 20

# name -> solve_qp keywords beyond the data (z0/x0 taken from the case)
VARIANTS = {
    "kkt_every2": dict(kkt_every=2),
    "kkt_every3_gondzio": dict(kkt_every=3, gondzio=2),
    "z0": dict(use_z0=True),
    "warm_sz": dict(use_z0=True, use_x0=True, warm_sz=True),
    "warm_sz_without_z0": dict(warm_sz=True),
}


def close(ref, got, tol=TOL, scale=False):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == ref.shape
    bar = tol * max(1.0, np.abs(ref).max()) if scale else tol
    np.testing.assert_allclose(got, ref, rtol=0, atol=bar)


def close_solution(jsol, tsol):
    close(jsol.x, tsol.x)
    close(jsol.s, tsol.s, scale=True)
    close(jsol.z, tsol.z, scale=True)
    np.testing.assert_array_equal(np.asarray(tsol.success), np.asarray(jsol.success))


@pytest.fixture(scope="module")
def random_qps():
    """(P, q, G, h, x0, z0) numpy, batch 4: P = A A' + I, h = G x_f + slack
    in [0.1, 1] (x_f feasible), a warm point x0 near x_f, duals z0 in
    [1e-3, 10]."""
    rng = np.random.default_rng(8)
    a = rng.normal(size=(BATCH, N, N))
    p = a @ a.transpose(0, 2, 1) + np.eye(N)
    q = rng.normal(size=(BATCH, N)) * 3.0
    g = rng.normal(size=(BATCH, M, N))
    x_f = rng.normal(size=(BATCH, N)) * 0.3
    h = np.einsum("bmn,bn->bm", g, x_f) + rng.uniform(0.1, 1.0, size=(BATCH, M))
    x0 = x_f + 0.05 * rng.normal(size=(BATCH, N))
    z0 = 10.0 ** rng.uniform(-3.0, 1.0, size=(BATCH, M))
    return p, q, g, h, x0, z0


def jax_batch(fn):
    return jax.jit(jax.vmap(fn))


def split_kw(kw, x0, z0):
    kw = dict(kw)
    use_x0, use_z0 = kw.pop("use_x0", False), kw.pop("use_z0", False)
    return kw, (x0 if use_x0 else None), (z0 if use_z0 else None)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_solve_qp_variant_random_matches_jax(random_qps, variant):
    p, q, g, h, x0, z0 = random_qps
    kw, x0, z0 = split_kw(VARIANTS[variant], x0, z0)
    jfn = jax_batch(lambda p_, q_, g_, h_, x_, z_: jqp.solve_qp(
        p_, q_, g_, h_, x0=x_, z0=z_, iters=QP_ITERS, **kw))
    jsol = jfn(p, q, g, h, x0, z0)
    t = lambda a: None if a is None else torch.from_numpy(a)
    tsol = tqp.solve_qp(*map(t, (p, q, g, h)), x0=t(x0), z0=t(z0), iters=QP_ITERS, **kw)
    close_solution(jsol, tsol)
    # the warm starts converge within 20 iterations; the stale factors
    # leave every problem short of the residual bars in both packages
    assert np.asarray(jsol.success).all() == ("kkt_every" not in kw)


def test_warm_sz_without_z0_is_the_cold_start(random_qps):
    p, q, g, h, _, _ = random_qps
    t = torch.from_numpy
    cold = tqp.solve_qp(t(p), t(q), t(g), t(h), iters=QP_ITERS)
    warm = tqp.solve_qp(t(p), t(q), t(g), t(h), iters=QP_ITERS, warm_sz=True)
    for a, b in zip(cold, warm):
        assert torch.equal(a, b)


@pytest.mark.parametrize("iters", [60, 200])
def test_solve_qp_admm_random_matches_jax(random_qps, iters):
    p, q, g, h, x0, _ = random_qps
    jsol = jax_batch(lambda *a: jqp.solve_qp_admm(*a, iters=iters))(p, q, g, h, x0)
    tsol = tqp.solve_qp_admm(*map(torch.from_numpy, (p, q, g, h)), x0=torch.from_numpy(x0),
                             iters=iters)
    close_solution(jsol, tsol)
    for key in ("r_p", "r_d", "gap"):
        close(getattr(jsol, key), getattr(tsol, key), scale=True)


def test_kkt_every_refreshes_on_multiples_only(random_qps, monkeypatch):
    """Frozen iterations launch no factorization: 8 iterations at
    kkt_every=3 factor at 0, 3 and 6; ADMM factors once."""
    calls = []
    real = tqp.kkt_inverse
    monkeypatch.setattr(tqp, "kkt_inverse", lambda k: calls.append(1) or real(k))
    p, q, g, h, _, _ = (torch.from_numpy(a) for a in random_qps)
    tqp.solve_qp(p, q, g, h, iters=8, kkt_every=3)
    assert len(calls) == 3
    calls.clear()
    tqp.solve_qp_admm(p, q, g, h, iters=40)
    assert len(calls) == 1


# --- the demo scene's first SQP subproblem ----------------------------------


@pytest.fixture(scope="module")
def subproblem():
    """The SQP subproblem at x = 0 of the demo scene's first tick (perf
    configuration, float64, numpy): hess, grad, G_run, h_run, h_tail, the
    dense form (G with the static rows), and the link form (G_dense, h_dense,
    h_link, acol_u, a_set_joints); plus the port's structure."""
    carry, meas, obs, _ = jdemo.demo_scene(CFG, np.float64)
    params = jax.tree.map(np.asarray, jax.jit(
        lambda c, m, o: jmpc.build_tick_params(c, m, o, CFG)[0])(carry, meas, obs))
    x = jnp.zeros(jjac.ocp.n_vars(CFG.n))
    jparams = jax.tree.map(jnp.asarray, params)
    r, g, jr, jg = (np.asarray(a) for a in jjac.evaluate_with_jac_structured(x, jparams, CFG))
    link_cfg = dataclasses.replace(CFG, struct_link=True)
    _, g_l, _, jg_dense, acol_u = (np.asarray(a) for a in
                                   jjac.evaluate_with_jac_structured(x, jparams, link_cfg))
    jst = jstruct.build(CFG.n, CFG.dt, chunked=False)
    m_run, md, ml = jst.m_run, jst.m_dense, jst.m_link
    hess = 2.0 * jr.T @ jr + 1e-4 * np.eye(x.shape[0])
    tail_rows = jjac._static_bound_rows(CFG.n, CFG.dt)
    st = FleetMPC(TCFG, device="cpu", dtype=torch.float64).st
    return {
        "hess": hess, "grad": 2.0 * jr.T @ r, "jg": jg, "h": -g[:m_run], "h_tail": -g[m_run:],
        "g_all": np.concatenate([jg, tail_rows]), "h_all": -g,
        "jg_dense": jg_dense, "h_dense": -g_l[:md], "h_link": -g_l[md:md + ml],
        "h_tail_l": -g_l[md + ml:], "acol_u": acol_u, "a_joints": params["a_set_joints"],
        "z0": np.random.default_rng(9).uniform(0.01, 3.0, size=g.shape[0]),
        "jst": jst, "st": st,
    }


def port_args(sp, *names):
    return [torch.from_numpy(np.array(sp[k]))[None] for k in names]


def unbatch(sol):
    return type(sol)(*(v[0] for v in sol))


@pytest.mark.parametrize("variant", ["kkt_every2", "z0", "warm_sz"])
def test_solve_qp_variant_subproblem_matches_jax(subproblem, variant):
    sp = subproblem
    kw, _, use_z0 = split_kw(VARIANTS[variant], None, True)
    z0 = sp["z0"] if use_z0 else None
    jsol = jqp.solve_qp(sp["hess"], sp["grad"], sp["jg"], sp["h"], iters=CFG.qp_iters,
                        tol=1e-10, struct=sp["jst"], h_tail=sp["h_tail"],
                        gondzio=CFG.qp_gondzio, z0=z0, **kw)
    hess, grad, jg, h, h_tail = port_args(sp, "hess", "grad", "jg", "h", "h_tail")
    tz0 = None if z0 is None else torch.from_numpy(z0)[None]
    tsol = unbatch(tqp.solve_qp(hess, grad, jg, h, iters=TCFG.qp_iters, tol=1e-10,
                                struct=sp["st"], h_tail=h_tail, gondzio=TCFG.qp_gondzio,
                                z0=tz0, **kw))
    close_solution(jsol, tsol)


def test_solve_qp_link_rows_subproblem_matches_jax(subproblem):
    """Row order [dense runtime | link | tail]; the link block exact."""
    sp = subproblem
    jsol = jqp.solve_qp(sp["hess"], sp["grad"], sp["jg_dense"], sp["h_dense"],
                        iters=CFG.qp_iters, tol=1e-10, struct=sp["jst"],
                        h_tail=sp["h_tail_l"], gondzio=CFG.qp_gondzio,
                        link=(sp["acol_u"], sp["a_joints"]), h_link=sp["h_link"])
    hess, grad, jg, h, h_tail, h_link, acol_u, a_j = port_args(
        sp, "hess", "grad", "jg_dense", "h_dense", "h_tail_l", "h_link", "acol_u", "a_joints")
    tsol = unbatch(tqp.solve_qp(hess, grad, jg, h, iters=TCFG.qp_iters, tol=1e-10,
                                struct=sp["st"], h_tail=h_tail, gondzio=TCFG.qp_gondzio,
                                link=(acol_u, a_j), h_link=h_link))
    close_solution(jsol, tsol)
    # the same QP as the plain structured one (rows reordered)
    plain = unbatch(tqp.solve_qp(*port_args(sp, "hess", "grad", "jg", "h"), iters=TCFG.qp_iters,
                                 tol=1e-10, struct=sp["st"], h_tail=port_args(sp, "h_tail")[0],
                                 gondzio=TCFG.qp_gondzio))
    close(plain.x, tsol.x, 1e-7)


def test_solve_qp_admm_subproblem_matches_jax(subproblem):
    """ADMM on every row (the dense form its callers give it)."""
    sp = subproblem
    jsol = jqp.solve_qp_admm(sp["hess"], sp["grad"], sp["g_all"], sp["h_all"],
                             iters=CFG.admm_iters)
    tsol = unbatch(tqp.solve_qp_admm(*port_args(sp, "hess", "grad", "g_all", "h_all"),
                                     iters=TCFG.admm_iters))
    close_solution(jsol, tsol)
