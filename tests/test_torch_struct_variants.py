"""The port's OCP structure and Jacobians against the JAX package for the
structured variants, on the CPU:

- the factored link rows (``link_apply``, ``link_apply_t``,
  ``link_gram``) on seeded inputs with a batch axis (JAX under ``vmap``),
  float64 within 1e-12 of the largest entry;
- the chunked bf16 Gram (``gram_g(lowp=True)`` with the causal split)
  against JAX's JITTED one in float32, within 1e-6 of the largest entry
  (jitted XLA keeps the bf16 x bf16 weighted copies in float32, as it does
  for the flat Gram; eager JAX would round them to bf16), and the
  ``ValueError`` of both packages on a partial row layout;
- ``evaluate_with_jac_structured`` with ``struct_tail=False`` and with
  ``struct_link=True`` on the demo scene's first tick, float64 within
  1e-10, and the link form applied through ``link_apply`` equal to the
  dense link block;
- ``ocp.cost``, ``ocp.constraints`` and ``Decision``, float64 within 1e-12.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch.func import vmap as tvmap

from boundplanner_tpu import demo as jdemo
from boundplanner_tpu.config import perf_mpc_params
from boundplanner_tpu.mpc import bound_mpc as jmpc
from boundplanner_tpu.mpc import ocp as jocp
from boundplanner_tpu.mpc import ocp_jac as jjac
from boundplanner_tpu.mpc import ocp_struct as jstruct
from boundplanner_tpu_torch import config as tconfig
from boundplanner_tpu_torch.mpc import ocp as tocp
from boundplanner_tpu_torch.mpc import ocp_jac as tjac
from boundplanner_tpu_torch.mpc import ocp_struct as tstruct

torch.set_num_threads(1)
CFG = perf_mpc_params()
TCFG = tconfig.perf_mpc_params()
N, DT = CFG.n, CFG.dt


def close(ref, got, tol):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * max(1.0, np.abs(ref).max()))


@pytest.fixture(scope="module")
def structs():
    return (jstruct.build(N, DT, chunked=False), tstruct.build(N, DT),
            jstruct.build(N, DT, chunked=True), tstruct.build(N, DT, chunked=True))


def test_link_products_match_jax(structs):
    jst, st, _, _ = structs
    rng = np.random.default_rng(31)
    b = 2
    acol_u = rng.normal(size=(b, N - 1, 6, 3, st.o))
    a_j = rng.normal(size=(b, 6, 15, 3))
    v = rng.normal(size=(b, st.nx))
    y = rng.normal(size=(b, st.m_link))
    w = rng.uniform(0.1, 10.0, size=(b, st.m_link))
    t = torch.from_numpy
    close(jax.vmap(jst.link_apply)(acol_u, a_j, v), st.link_apply(t(acol_u), t(a_j), t(v)),
          1e-12)
    close(jax.vmap(jst.link_apply_t)(acol_u, a_j, y),
          st.link_apply_t(t(acol_u), t(a_j), t(y)), 1e-12)
    close(jax.vmap(jst.link_gram)(acol_u, a_j, w), st.link_gram(t(acol_u), t(a_j), t(w)),
          1e-12)
    # the three are one operator: <J v, y> = <v, J' y>, J' diag(w) J = gram
    jv = st.link_apply(t(acol_u), t(a_j), t(v))
    lhs = torch.sum(jv * t(y), -1)
    rhs = torch.sum(t(v) * st.link_apply_t(t(acol_u), t(a_j), t(y)), -1)
    close(lhs.numpy(), rhs, 1e-12)
    gv = (st.link_gram(t(acol_u), t(a_j), t(w)) @ t(v)[..., None])[..., 0]
    close(st.link_apply_t(t(acol_u), t(a_j), t(w) * jv).numpy(), gv, 1e-12)


def test_chunked_bf16_gram_matches_jitted_jax(structs):
    _, _, jst_c, st_c = structs
    st32 = tstruct.build(N, DT, chunked=True).to(torch.float32)
    rng = np.random.default_rng(32)
    g = rng.normal(size=(2, st_c.m_run, st_c.nx)).astype(np.float32)
    w = (10.0 ** rng.uniform(-2.0, 2.0, size=(2, st_c.m_run))).astype(np.float32)
    ref = np.asarray(jax.jit(jax.vmap(lambda a, b: jst_c.gram_g(a, b, True)))(g, w))
    got = st32.gram_g(torch.from_numpy(g), torch.from_numpy(w), lowp=True)
    assert got.dtype == torch.float32
    close(ref, got, 1e-6)
    # and the rounding is the bf16 Gram's, not the f32 one's
    exact = np.einsum("bmi,bm,bmj->bij", g.astype(np.float64), w, g.astype(np.float64))
    assert np.abs(ref - exact).max() > 1e3 * np.abs(ref - got.numpy()).max()


def test_chunked_grams_refuse_partial_rows(structs):
    _, _, jst_c, st_c = structs
    g = np.zeros((st_c.m_dense, st_c.nx))
    w = np.ones(st_c.m_dense)
    with pytest.raises(ValueError):
        jst_c.gram_g(jnp.asarray(g), jnp.asarray(w))
    with pytest.raises(ValueError):
        st_c.gram_g(torch.from_numpy(g)[None], torch.from_numpy(w)[None])
    with pytest.raises(ValueError):
        jst_c.gram_r(jnp.zeros((st_c.m_r - 1, st_c.nx)))
    with pytest.raises(ValueError):
        st_c.gram_r(torch.zeros(1, st_c.m_r - 1, st_c.nx, dtype=torch.float64))


# --- the demo scene's first tick --------------------------------------------


@pytest.fixture(scope="module")
def demo_params():
    """The demo scene's tick parameters (numpy, float64), two decision
    vectors (zero and seeded) and the port's flat structure."""
    carry, meas, obs, _ = jdemo.demo_scene(CFG, np.float64)
    params = jax.tree.map(np.asarray, jax.jit(
        lambda c, m, o: jmpc.build_tick_params(c, m, o, CFG)[0])(carry, meas, obs))
    nx = jocp.n_vars(N)
    xs = np.stack([np.zeros(nx), np.random.default_rng(33).normal(size=nx) * 0.3])
    return params, xs, tstruct.build(N, DT).to(torch.float64)


def both_params(params):
    jp = jax.tree.map(lambda a: jnp.asarray(np.stack([a, a])), params)
    tp = {k: torch.from_numpy(np.stack([v, v])) for k, v in params.items()}
    return jp, tp


@pytest.mark.parametrize("fields", [dict(struct_tail=False), dict(struct_link=True)],
                         ids=["struct_tail_false", "struct_link"])
def test_evaluate_with_jac_structured_variant_matches_jax(demo_params, fields):
    params, xs, st = demo_params
    jcfg = dataclasses.replace(CFG, **fields)
    tcfg = dataclasses.replace(TCFG, **fields)
    jp, tp = both_params(params)
    jout = jax.jit(jax.vmap(lambda x, p: jjac.evaluate_with_jac_structured(x, p, jcfg)))(
        jnp.asarray(xs), jp)
    tout = tvmap(lambda x, p: tjac.evaluate_with_jac_structured(x, p, tcfg, st))(
        torch.from_numpy(xs), tp)
    assert len(tout) == len(jout) == (5 if tcfg.struct_link else 4)
    for j, t in zip(jout, tout):
        close(j, t, 1e-10)
    if tcfg.struct_link:
        # [dense | link | tail] of the same rows, and the factored link
        # block equal to the dense chain rule's
        r, g, jr, jg = tvmap(lambda x, p: tjac.evaluate_with_jac_structured(x, p, TCFG, st))(
            torch.from_numpy(xs), tp)
        per = st.per_step_g
        steps = g[:, :(N - 1) * per].reshape(2, N - 1, per)
        link = slice(21, 21 + st.m_link // (N - 1))
        close(steps[:, :, link].reshape(2, -1).numpy(), tout[1][:, st.m_dense:st.m_run], 0.0)
        v = torch.from_numpy(np.random.default_rng(34).normal(size=(2, st.nx)))
        dense_link = jg[:, :(N - 1) * per].reshape(2, N - 1, per, st.nx)[:, :, link]
        dense_rows = (dense_link.reshape(2, -1, st.nx) @ v[..., None])[..., 0]
        close(dense_rows.numpy(), st.link_apply(tout[4], tp["a_set_joints"], v), 1e-12)
    else:
        assert tout[3].shape[-2] == st.m_run + st.m_tail


def test_ocp_cost_constraints_decision_match_jax(demo_params):
    params, xs, st = demo_params
    jparams = jax.tree.map(jnp.asarray, params)
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    for x in xs:
        close(jocp.cost(jnp.asarray(x), jparams, CFG),
              tocp.cost(torch.from_numpy(x), tparams, TCFG, st), 1e-12)
        close(jocp.constraints(jnp.asarray(x), jparams, CFG),
              tocp.constraints(torch.from_numpy(x), tparams, TCFG, st), 1e-12)
        close(jocp.cost_residuals(jnp.asarray(x), jparams, CFG),
              tocp.cost_residuals(torch.from_numpy(x), tparams, TCFG, st), 1e-12)
    assert tocp.Decision._fields == jocp.Decision._fields
    x, u0 = xs[1], np.random.default_rng(35).normal(size=7)
    u, dsl, rs0, drs, ps0, dps = jocp.unpack(jnp.asarray(x), jnp.asarray(u0), N)
    rsl, psl = jocp.slack_trajectories(rs0, drs, ps0, dps, DT)
    jd = jocp.Decision(u, dsl, rsl, drs, psl, dps)
    tu, tdsl, trs0, tdrs, tps0, tdps = tocp.unpack(torch.from_numpy(x), torch.from_numpy(u0), N)
    trsl, tpsl = tocp.slack_trajectories(trs0, tdrs, tps0, tdps, DT)
    td = tocp.Decision(tu, tdsl, trsl, tdrs, tpsl, tdps)
    for name in tocp.Decision._fields:
        close(getattr(jd, name), getattr(td, name), 1e-12)
