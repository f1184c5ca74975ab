"""The dense MPC routes of the port against the JAX package: the default
configuration ``MPCParams()`` (forward-mode Jacobian of ``ocp.evaluate``,
dense QP on all 2439 rows) and ``manual_jac=True`` (the dense chain rule
``ocp_jac.evaluate_with_jac``), on the first tick of
``.fleet_cache/test8.pkl`` scenes 0-1 in float64:

- ``check_supported`` accepts both and every branch once refused, and
  rejects what JAX rejects;
- ``evaluate_with_jac`` against the port's ``jac_fwd`` of ``ocp.evaluate``
  and against JAX, to 1e-9;
- the dense ``solve_qp`` on the tick's first SQP subproblem: float64 to
  1e-8; float32 with bf16 directions and Gram; the bf16 Grams (dense and
  structured) against the JAX package's jitted ones;
- one ``solve_sqp`` (2 SQP x 6 IPM iterations, 2 line-search candidates)
  to 1e-8 per route.
"""

import dataclasses
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch.func import vmap as tvmap

from boundplanner_tpu.config import MPCParams
from boundplanner_tpu.mpc import bound_mpc as jmpc
from boundplanner_tpu.mpc import ocp as jocp
from boundplanner_tpu.mpc import ocp_jac as jjac
from boundplanner_tpu.mpc import ocp_struct as jstruct
from boundplanner_tpu.mpc import solver as jsolver
from boundplanner_tpu.ops import qp as jqp
from boundplanner_tpu.parallel import batch as jbatch
from boundplanner_tpu_torch import config as tconfig
from boundplanner_tpu_torch.mpc import bound_mpc as tmpc
from boundplanner_tpu_torch.mpc import ocp as tocp
from boundplanner_tpu_torch.mpc import ocp_jac as tjac
from boundplanner_tpu_torch.mpc import solver as tsolver
from boundplanner_tpu_torch.ops import qp as tqp
from boundplanner_tpu_torch.ops.sqp import jac_fwd
from boundplanner_tpu_torch.parallel.fleet_cache import load, tree_map

torch.set_num_threads(1)
SMALL = dict(sqp_iters=2, qp_iters=6, line_search_steps=2)
CFG = MPCParams(**SMALL)
TCFG = tconfig.MPCParams(**SMALL)
FLEET8 = os.path.join(os.path.dirname(__file__), "..", ".fleet_cache", "test8.pkl")

J_PARAMS = jax.jit(jax.vmap(lambda c, m, o: jmpc.build_tick_params(c, m, o, CFG)[0]))


def f64(a):
    a = np.asarray(a)
    return a.astype(np.float64) if a.dtype.kind == "f" else a


def close(j, t, tol):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=0, atol=tol)


@pytest.fixture(scope="module")
def tick():
    """The JAX tick parameters of scenes 0-1 (numpy, float64), the same as
    the port's tensors, and the port's dense model."""
    payload = load(FLEET8)
    carry, q0, obs = tree_map(lambda a: f64(a)[:2],
                              (payload["carry"], payload["q0"], payload["obs"]))
    zeros = np.zeros_like(q0)
    jcarry = jmpc.MPCCarry(jmpc.PathState(*carry.path), *carry[1:])
    jmeas = jax.vmap(lambda *a: jbatch._plant_measurement(*a, jnp.float64))(
        q0, zeros, zeros, zeros, q0)
    jparams = jax.tree.map(np.asarray, J_PARAMS(jcarry, jmeas, jmpc.ObstacleArrays(*obs)))
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in jparams.items()}
    model = tmpc.FleetMPC(TCFG, device="cpu", dtype=torch.float64)
    return jparams, tparams, model


def test_fleet_mpc_takes_the_default_config():
    model = tmpc.FleetMPC(tconfig.MPCParams(), device="cpu", dtype=torch.float64)
    assert not model.cfg.struct_ocp and model.cfg.struct_chunked
    assert model.st.tail_rows.shape == (model.st.m_tail, model.st.nx) == (850, 136)


@pytest.mark.parametrize("fields", [{}, {"manual_jac": True}, {"qp_bf16": True},
                                    {"struct_ocp": True, "struct_chunked": False}],
                         ids=["default", "manual_jac", "qp_bf16", "struct_flat"])
def test_check_supported_accepts(fields):
    tsolver.check_supported(tconfig.MPCParams(**fields))


@pytest.mark.parametrize("fields", [
    {"struct_link": True},
    {"qp_solver": "admm"},
    {"kkt_every": 2},
    {"qp_warm_dual": True},
    {"qp_warm_dual": True, "qp_warm_sz": True},
    {"esc_lanes": 4},
    {"struct_ocp": True},                                  # struct_chunked=True
    {"struct_ocp": True, "struct_chunked": False, "struct_tail": False},
], ids=lambda f: ",".join(f"{k}={v}" for k, v in f.items()))
def test_check_supported_refuses(fields):
    """Each branch that the port once refused: accepted now (the model
    builds), except where the JAX package refuses it too (``struct_link``
    without the flat structural tail: a ``ValueError`` in both)."""
    cfg = tconfig.MPCParams(**fields)
    if fields == {"struct_link": True}:
        with pytest.raises(ValueError):
            jsolver.solve_sqp(jnp.zeros(tocp.n_vars(cfg.n)), {}, MPCParams(**fields))
        with pytest.raises(ValueError):
            tsolver.check_supported(cfg)
        return
    tsolver.check_supported(cfg)
    model = tmpc.FleetMPC(cfg, device="cpu", dtype=torch.float64)
    assert model.st.chunked == (cfg.struct_ocp and cfg.struct_chunked)


def xs(nx):
    rng = np.random.default_rng(21)
    return np.stack([np.zeros(nx), rng.normal(size=nx) * 0.3])


def test_evaluate_with_jac_matches_jac_fwd_and_jax(tick):
    jparams, tparams, model = tick
    x = xs(model.st.nx)
    tx = torch.from_numpy(x)
    r, g, jr, jg = tvmap(lambda xx, pp: tjac.evaluate_with_jac(xx, pp, TCFG, model.st))(
        tx, tparams)
    assert jr.shape == (2, model.st.m_r, 136) and jg.shape == (2, 2439, 136)
    ev = lambda v: tvmap(lambda xx, pp: tocp.evaluate(xx[0], pp, TCFG, model.st),
                         )(v, tparams)
    r_ad, g_ad = ev(tx[:, None])
    jr_ad, jg_ad = jac_fwd(lambda v: tuple(t[:, None] for t in ev(v)), tx)
    for a, b in ((r, r_ad), (g, g_ad), (jr, jr_ad), (jg, jg_ad)):
        close(b.numpy(), a, 1e-9)
    jout = jax.vmap(lambda xx, pp: jjac.evaluate_with_jac(xx, pp, CFG))(
        jnp.asarray(x), jax.tree.map(jnp.asarray, jparams))
    for j, t in zip(jout, (r, g, jr, jg)):
        close(j, t, 1e-9)


@pytest.fixture(scope="module")
def first_qp(tick):
    """The first dense SQP subproblem of scene 0 (numpy, float64): hess,
    grad, G on all rows, h."""
    jparams = tick[0]
    p0 = jax.tree.map(lambda a: jnp.asarray(a[0]), jparams)
    x0 = jnp.zeros(jocp.n_vars(CFG.n), jnp.float64)
    r, g = jocp.evaluate(x0, p0, CFG)
    jr, jg = jax.jacfwd(lambda x: jocp.evaluate(x, p0, CFG))(x0)
    r, g, jr, jg = (np.asarray(a) for a in (r, g, jr, jg))
    hess = 2.0 * jr.T @ jr + 1e-4 * np.eye(x0.shape[0])
    return hess, 2.0 * jr.T @ r, jg, -g


def test_solve_qp_dense_f64_matches_jax(first_qp):
    kw = dict(iters=MPCParams().qp_iters, tol=1e-10)
    sj = jqp.solve_qp(*(jnp.asarray(a) for a in first_qp), **kw)
    st = tqp.solve_qp(*(torch.from_numpy(np.array(a))[None] for a in first_qp), **kw)
    close(sj.x, st.x[0], 1e-8)
    close(sj.z, st.z[0], 1e-8 * max(1.0, np.abs(np.asarray(sj.z)).max()))
    assert bool(sj.success) == bool(st.success[0])


@pytest.mark.parametrize("where", ["dense", "structured"])
def test_lowp_gram_matches_jitted_jax(where):
    """The bf16 Grams as the JAX package computes them under jit: G and w
    rounded to bf16, the product G w and the G^T (G w) sum in f32 (XLA
    fuses the bf16 product into f32 and never rounds it back; only eager
    JAX rounds it). Rounding the product too lands measurably farther."""
    rng = np.random.default_rng(22)
    m = 600 if where == "dense" else 1589
    g = rng.normal(size=(m, 136)).astype(np.float32)
    w = (10.0 ** rng.uniform(-3.0, 3.0, size=(m,))).astype(np.float32)

    def expr(gg, ww):
        g16 = gg.astype(jnp.bfloat16)
        return jnp.matmul(g16.T, g16 * ww[:, None].astype(jnp.bfloat16),
                          preferred_element_type=jnp.float32)

    if where == "dense":
        jgram = np.asarray(jax.jit(expr)(jnp.asarray(g), jnp.asarray(w)))
        gram = lambda gg, ww: tqp.dense_gram(gg[None], ww[None], lowp=True)[0]
    else:
        jst = jstruct.build(CFG.n, CFG.dt, chunked=False)
        jgram = np.asarray(jax.jit(lambda gg, ww: jst.gram_g(gg, ww, True))(
            jnp.asarray(g), jnp.asarray(w)))
        st = tmpc.FleetMPC(tconfig.perf_mpc_params(), device="cpu", dtype=torch.float32).st
        gram = lambda gg, ww: st.gram_g(gg, ww, True)
    tg, tw = torch.from_numpy(g), torch.from_numpy(w)
    tgram = gram(tg, tw)
    assert tgram.dtype == torch.float32
    scale = np.abs(jgram).max()
    err = np.abs(tgram.numpy() - jgram).max() / scale
    g16 = tg.to(torch.bfloat16)
    rounded = (g16.float().mT @ (g16 * tw[:, None].to(torch.bfloat16)).float()).numpy()
    err_rounded = np.abs(rounded - jgram).max() / scale
    assert err < 1e-6, err
    assert err_rounded > 20.0 * err, (err_rounded, err)


@pytest.mark.parametrize("iters", [1, 25])
def test_solve_qp_dense_f32_lowp_matches_jax(first_qp, iters):
    """float32 with bf16 search directions and Gram (lowp + lowp_rd)
    against JAX float32. One IPM iteration is the same arithmetic up to
    summation order: within 1e-4 of max|x|. Over the default 25 the dense
    f32 IPM (KKT condition ~1e8 on 2439 rows) amplifies that order noise:
    JAX's own solution moves by 1-2 % of max|x| under 1e-7 perturbations
    of the Hessian, so both f32 solutions are held within 5 % of max|x|
    of the f64 one, and the port's finite."""
    kw = dict(iters=iters, tol=1e-10)
    x64 = np.asarray(jqp.solve_qp(*(jnp.asarray(a) for a in first_qp), **kw).x)
    xj = np.asarray(jqp.solve_qp(*(jnp.asarray(a, jnp.float32) for a in first_qp),
                                 lowp=True, lowp_rd=True, **kw).x)
    xt = tqp.solve_qp(*(torch.tensor(np.array(a), dtype=torch.float32)[None]
                        for a in first_qp), lowp=True, lowp_rd=True, **kw).x
    assert xt.dtype == torch.float32 and torch.isfinite(xt).all()
    xt = xt[0].numpy()
    scale = np.abs(x64).max()
    if iters == 1:
        close(xj, xt, 1e-4 * scale)
    else:
        assert np.abs(xj - x64).max() < 5e-2 * scale
        assert np.abs(xt - x64).max() < 5e-2 * scale, (np.abs(xt - x64).max(), scale)


@pytest.mark.parametrize("manual_jac", [False, True], ids=["jac_fwd", "manual_jac"])
def test_solve_sqp_matches_jax(tick, manual_jac):
    jparams, tparams, _ = tick
    cfg = dataclasses.replace(CFG, manual_jac=manual_jac)
    tcfg = dataclasses.replace(TCFG, manual_jac=manual_jac)
    model = tmpc.FleetMPC(tcfg, device="cpu", dtype=torch.float64)
    x0 = np.zeros((2, tocp.n_vars(CFG.n)))
    sj = jax.jit(jax.vmap(lambda x, p: jsolver.solve_sqp(x, p, cfg)))(
        jnp.asarray(x0), jax.tree.map(jnp.asarray, jparams))
    st = tsolver.solve_sqp(torch.from_numpy(x0), tparams, tcfg, model.st)
    x_scale = max(1.0, np.abs(np.asarray(sj.x)).max())
    close(sj.x, st.x, 1e-8 * x_scale)
    close(sj.cost, st.cost, 1e-8 * max(1.0, np.abs(np.asarray(sj.cost)).max()))
    close(sj.viol, st.viol, 1e-8)
    np.testing.assert_array_equal(np.asarray(st.iters), np.asarray(sj.iters))
    np.testing.assert_array_equal(np.asarray(st.success), np.asarray(sj.success))
