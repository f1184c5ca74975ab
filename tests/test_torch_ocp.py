"""PyTorch port vs the JAX package on one real tick of the cached fleet
(``.fleet_cache/test8.pkl`` scenes 0-1, perf configuration):

- ``build_tick_params`` (window, rotation errors, projection vectors, link
  collision sets through the exact projection IPM), float64 to 1e-9;
- ``ocp.evaluate`` and ``ocp_jac.evaluate_with_jac_structured``, float64
  to 1e-9 (the bar of tests/test_ocp_struct.py);
- the flat ``OCPStruct`` products against the dense static rows;
- ``solve_qp`` on the tick's first SQP subproblem: float64 to 1e-8, and
  float32 with lowp + lowp_rd + 2 Gondzio correctors against JAX float32.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch.func import vmap as tvmap

from boundplanner_tpu.config import perf_mpc_params
from boundplanner_tpu_torch import config as tconfig
from boundplanner_tpu.mpc import bound_mpc as jmpc
from boundplanner_tpu.mpc import ocp as jocp
from boundplanner_tpu.mpc import ocp_jac as jjac
from boundplanner_tpu.mpc import ocp_struct as jstruct
from boundplanner_tpu.ops import qp as jqp
from boundplanner_tpu.parallel import batch as jbatch
from boundplanner_tpu_torch.mpc import bound_mpc as tmpc
from boundplanner_tpu_torch.mpc import ocp as tocp
from boundplanner_tpu_torch.mpc import ocp_jac as tjac
from boundplanner_tpu_torch.ops import qp as tqp
from boundplanner_tpu_torch.parallel import batch as tbatch
from boundplanner_tpu_torch.parallel.fleet_cache import load, to_torch, tree_map

torch.set_num_threads(1)
CFG = perf_mpc_params()
TCFG = tconfig.perf_mpc_params()
FLEET8 = os.path.join(os.path.dirname(__file__), "..", ".fleet_cache", "test8.pkl")


J_PARAMS = jax.jit(jax.vmap(lambda c, m, o: jmpc.build_tick_params(c, m, o, CFG)[0]))
J_EVAL = jax.jit(jax.vmap(lambda x, p: jocp.evaluate(x, p, CFG)))
J_EVAL_JAC = jax.jit(jax.vmap(lambda x, p: jjac.evaluate_with_jac_structured(x, p, CFG)))


def f64(a):
    a = np.asarray(a)
    return a.astype(np.float64) if a.dtype.kind == "f" else a


def close(j, t, tol):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=0, atol=tol)


@pytest.fixture(scope="module")
def tick():
    """The fleet's first tick for scenes 0-1 in float64, in both packages:
    JAX params (numpy), port params (tensors) and the port model."""
    payload = load(FLEET8)
    carry, q0, obs = tree_map(lambda a: f64(a)[:2], (payload["carry"], payload["q0"], payload["obs"]))
    zeros = np.zeros_like(q0)
    jcarry = jmpc.MPCCarry(jmpc.PathState(*carry.path), *carry[1:])
    jobs = jmpc.ObstacleArrays(*obs)
    jmeas = jax.vmap(lambda *a: jbatch._plant_measurement(*a, jnp.float64))(
        q0, zeros, zeros, zeros, q0)
    jparams = jax.tree.map(np.asarray, J_PARAMS(jcarry, jmeas, jobs))

    model = tmpc.FleetMPC(TCFG, device="cpu", dtype=torch.float64)
    tcarry, tq0, tobs = to_torch((carry, q0, obs), "cpu", torch.float64)
    tz = torch.zeros_like(tq0)
    tmeas = tbatch._plant_measurement(tq0, tz, tz, tz, tq0, model.st.chain)
    tparams = tmpc.build_tick_params(tcarry, tmeas, tobs, TCFG, model.st)[0]
    return jparams, tparams, model


def scene(params, i):
    return {k: v[i] for k, v in params.items()}


def test_build_tick_params_matches_jax(tick):
    jparams, tparams, _ = tick
    assert set(jparams) == set(tparams)
    for key in jparams:
        close(jparams[key], tparams[key].numpy(), 1e-9)


def xs_for(nx):
    rng = np.random.default_rng(11)
    return [np.zeros(nx), rng.normal(size=nx) * 0.3]


def shared_params(jparams):
    """The JAX tick parameters as the port's tensors: the OCP tests feed
    both packages the same parameters."""
    return {k: torch.from_numpy(np.array(v)) for k, v in jparams.items()}


@pytest.mark.parametrize("which", [0, 1], ids=["x_zero", "x_random"])
def test_evaluate_matches_jax(tick, which):
    jparams, _, model = tick
    x = np.stack([xs_for(tocp.n_vars(TCFG.n))[which]] * 2)
    rj, gj = J_EVAL(jnp.asarray(x), jax.tree.map(jnp.asarray, jparams))
    rt, gt = tvmap(lambda xx, pp: tocp.evaluate(xx, pp, TCFG, model.st))(
        torch.from_numpy(x), shared_params(jparams))
    assert gt.shape == (2, jocp.n_constraints(CFG)) == (2, 2439)
    close(rj, rt, 1e-9)
    close(gj, gt, 1e-9)


@pytest.mark.parametrize("which", [0, 1], ids=["x_zero", "x_random"])
def test_evaluate_with_jac_structured_matches_jax(tick, which):
    jparams, _, model = tick
    x = np.stack([xs_for(tocp.n_vars(TCFG.n))[which]] * 2)
    jout = J_EVAL_JAC(jnp.asarray(x), jax.tree.map(jnp.asarray, jparams))
    tout = tvmap(lambda xx, pp: tjac.evaluate_with_jac_structured(xx, pp, TCFG, model.st))(
        torch.from_numpy(x), shared_params(jparams))
    st = model.st
    shapes = [(2, st.m_r), (2, 2439), (2, st.m_r, st.nx), (2, st.m_run, st.nx)]
    for j, t, shape in zip(jout, tout, shapes):
        assert t.shape == shape
        close(j, t, 1e-9)


def test_struct_tail_products_match_dense(tick):
    _, _, model = tick
    st = model.st
    dense = torch.from_numpy(tjac._static_bound_rows(TCFG.n, TCFG.dt))
    np.testing.assert_array_equal(dense.numpy(), jjac._static_bound_rows(CFG.n, CFG.dt))
    rng = np.random.default_rng(12)
    v = torch.from_numpy(rng.normal(size=(3, st.nx)))
    y = torch.from_numpy(rng.normal(size=(3, st.m_tail)))
    w = torch.from_numpy(rng.uniform(0.1, 10.0, size=(3, st.m_tail)))
    close((v @ dense.T).numpy(), st.tail_apply(v), 1e-12)
    close((y @ dense).numpy(), st.tail_apply_t(y), 1e-12)
    close((dense.T @ (w[..., None] * dense)).numpy(), st.tail_gram(w), 1e-10)
    g = torch.from_numpy(rng.normal(size=(3, 40, st.nx)))
    wr = torch.from_numpy(rng.uniform(0.1, 10.0, size=(3, 40)))
    close((g.mT @ (wr[..., None] * g)).numpy(), st.gram_g(g, wr), 1e-12)
    jst = jstruct.build(CFG.n, CFG.dt, chunked=False)
    close(jax.vmap(jst.tail_gram)(jnp.asarray(w.numpy())), st.tail_gram(w), 1e-10)


@pytest.fixture(scope="module")
def first_qp(tick):
    """The first SQP subproblem of the tick for scene 0, float64 (numpy):
    hess, grad, G_run, h_run, h_tail."""
    jparams = tick[0]
    x0 = np.zeros((2, tocp.n_vars(TCFG.n)))
    r, g, jr, jg = (np.asarray(a)[0] for a in
                    J_EVAL_JAC(jnp.asarray(x0), jax.tree.map(jnp.asarray, jparams)))
    m_run = JST.m_run
    hess = 2.0 * jr.T @ jr + 1e-4 * np.eye(x0.shape[1])
    return hess, 2.0 * jr.T @ r, jg, -g[:m_run], -g[m_run:]


JST = jstruct.build(CFG.n, CFG.dt, chunked=False)
QP_KW = dict(iters=CFG.qp_iters, tol=1e-10, gondzio=CFG.qp_gondzio)


def jax_qp(data, dtype, **kw):
    hess, grad, jg, h, h_tail = (jnp.asarray(a, dtype) for a in data)
    return jqp.solve_qp(hess, grad, jg, h, struct=JST, h_tail=h_tail, **QP_KW, **kw)


def port_qp(data, st, dtype, **kw):
    t = lambda a: torch.tensor(np.array(a), dtype=dtype)[None]
    hess, grad, jg, h, h_tail = map(t, data)
    return tqp.solve_qp(hess, grad, jg, h, struct=st, h_tail=h_tail, **QP_KW, **kw)


def test_solve_qp_f64_matches_jax(tick, first_qp):
    sj = jax_qp(first_qp, jnp.float64)
    stt = port_qp(first_qp, tick[2].st, torch.float64)
    # 4 IPM iterations through explicit inverses of a KKT matrix with
    # condition ~1e8: f64 summation-order noise reaches ~1e-9 in x
    close(sj.x, stt.x[0], 1e-8)
    close(sj.z, stt.z[0], 1e-8 * max(1.0, np.abs(np.asarray(sj.z)).max()))
    assert bool(sj.success) == bool(stt.success[0])


def test_solve_qp_f32_lowp_matches_jax(first_qp):
    """float32 with bf16 search directions (lowp + lowp_rd) and 2 Gondzio
    correctors, against JAX float32 on the same subproblem. Both round the
    same f32 operands to bf16, but 4 IPM iterations through explicit f32
    inverses of a KKT with condition ~1e8 leave each f32 solve ~1e-3 of
    max|x| from the exact (f64) solution, in directions that depend on
    the summation order. So the bar is relative to JAX's own f32 error:
    the port's f32 solution must lie as close to the f64 solution as
    JAX's does (within 2x), and the two f32 solutions within 5e-3 of
    max|x| of each other."""
    x64 = np.asarray(jax_qp(first_qp, jnp.float64).x)
    xj = np.asarray(jax_qp(first_qp, jnp.float32, lowp=True, lowp_rd=True).x)
    st32 = tmpc.FleetMPC(TCFG, device="cpu", dtype=torch.float32).st
    xt = port_qp(first_qp, st32, torch.float32, lowp=True, lowp_rd=True).x
    assert xt.dtype == torch.float32 and torch.isfinite(xt).all()
    xt = xt[0].numpy()
    err_jax = np.abs(xj - x64).max()
    err_port = np.abs(xt - x64).max()
    assert err_port <= 2.0 * err_jax, (err_port, err_jax)
    close(xj, xt, 5e-3 * np.abs(x64).max())
