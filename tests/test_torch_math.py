"""PyTorch port vs the JAX package: SO(3), jerk integration, kinematics
(iiwa14 and gen3), limits, and the path window + reference/error functions.

Same numpy inputs (seeded) through both; float64 throughout, held to
1e-12 (both sides evaluate the same formulas; the differences left are
float reassociation, ~1e-15).
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch.func import vmap as tvmap

from boundplanner_tpu.path import ref_fns as jref
from boundplanner_tpu.path import reference_path as jpath
from boundplanner_tpu.robot import kinematics as jkin
from boundplanner_tpu.robot import model as jmodel
from boundplanner_tpu.utils import integration as jint
from boundplanner_tpu.utils import so3 as jso3
from boundplanner_tpu_torch.parallel.fleet_cache import load, to_torch, tree_map
from boundplanner_tpu_torch.path import ref_fns as tref
from boundplanner_tpu_torch.path import reference_path as tpath
from boundplanner_tpu_torch.robot import kinematics as tkin
from boundplanner_tpu_torch.robot import model as tmodel
from boundplanner_tpu_torch.utils import integration as tint
from boundplanner_tpu_torch.utils import so3 as tso3

torch.set_num_threads(1)
TOL = 1e-12
FLEET8 = os.path.join(os.path.dirname(__file__), "..", ".fleet_cache", "test8.pkl")


def t64(a):
    return torch.tensor(np.array(a), dtype=torch.float64)


def close(j, t, tol=TOL):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=0, atol=tol)


def rotvecs(rng, n=64):
    rv = rng.normal(size=(n, 3)) * rng.uniform(0.0, 3.0, size=(n, 1))
    rv[:4] *= 1e-5          # small-angle (Taylor) branches
    rv[4] = 0.0
    return rv


@pytest.mark.parametrize(
    "name", ["skew", "rotvec_to_matrix", "jac_so3_inv_right", "jac_so3_inv_left", "normalize"]
)
def test_so3_vector_functions(name):
    rv = rotvecs(np.random.default_rng(1))
    close(jax.vmap(getattr(jso3, name))(jnp.asarray(rv)), getattr(tso3, name)(t64(rv)))


@pytest.mark.parametrize(
    "name", ["matrix_to_quat", "matrix_to_rotvec", "matrix_to_euler_zyx"]
)
def test_so3_matrix_functions(name):
    rv = rotvecs(np.random.default_rng(2))
    mats = np.array(jax.vmap(jso3.rotvec_to_matrix)(jnp.asarray(rv)))
    mats[5] = np.diag([1.0, -1.0, -1.0])           # angle pi
    close(jax.vmap(getattr(jso3, name))(jnp.asarray(mats)), getattr(tso3, name)(t64(mats)))


def test_gram_schmidt_and_orthogonal_error():
    rng = np.random.default_rng(7)
    v, b, e, w = (rng.normal(size=(16, 3)) for _ in range(4))
    close(jax.vmap(jso3.gram_schmidt)(jnp.asarray(v), jnp.asarray(b)),
          tso3.gram_schmidt(t64(v), t64(b)))
    close(jax.vmap(jref.decompose_orthogonal_error)(*map(jnp.asarray, (e, v, w))),
          tref.decompose_orthogonal_error(t64(e), t64(v), t64(w)))


def test_rodrigues_and_integration():
    rng = np.random.default_rng(3)
    axis = rng.normal(size=(16, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    ang = rng.uniform(-3, 3, size=16)
    close(jax.vmap(jso3.rodrigues)(jnp.asarray(axis), jnp.asarray(ang)),
          tso3.rodrigues(t64(axis), t64(ang)))
    args = [rng.normal(size=(8, 7)) for _ in range(5)]
    for j, t in zip(jint.integrate_jerk_step(*map(jnp.asarray, args), 0.1),
                    tint.integrate_jerk_step(*map(t64, args), 0.1)):
        close(j, t)


@pytest.mark.parametrize("robot", ["iiwa14", "gen3"])
def test_kinematics(robot):
    rng = np.random.default_rng(4)
    q = rng.uniform(-2.9, 2.9, size=(32, 7))
    jchain = jkin.chain_by_name(robot)
    tchain = tkin.Chain(robot).to(torch.float64)
    fj = jax.vmap(lambda qq: jkin.fk_frames(qq, jchain))(jnp.asarray(q))
    ft = tkin.fk_frames(t64(q), tchain)
    for key in ("r", "p", "r_ee", "p_ee", "p_col"):
        close(fj[key], ft[key])
    close(jax.vmap(lambda qq: jkin.fk_pose(qq, jchain))(jnp.asarray(q)),
          tkin.fk_pose(t64(q), tchain))
    close(jax.vmap(lambda qq: jkin.jacobian_fk(qq, jchain))(jnp.asarray(q)),
          tkin.jacobian_fk(t64(q), tchain))


@pytest.mark.parametrize("robot", ["iiwa14", "gen3"])
def test_ocp_limits(robot):
    for j, t in zip(jmodel.ocp_limits(robot), tmodel.ocp_limits(robot)):
        np.testing.assert_array_equal(j, t)
    assert np.all(np.isfinite(tmodel.ocp_limits(robot)[0]))  # gen3 inf -> 1e3


@pytest.fixture(scope="module")
def fleet_paths():
    """The 8 cached PathStates (float64) as numpy + the port's tensors."""
    payload = load(FLEET8)
    path_np = tree_map(
        lambda a: np.asarray(a).astype(np.float64) if np.asarray(a).dtype.kind == "f"
        else np.asarray(a),
        payload["carry"].path,
    )
    return jpath.PathState(*path_np), to_torch(path_np, "cpu", torch.float64)


def test_path_window_advance_correction(fleet_paths):
    path_np, path_t = fleet_paths
    rng = np.random.default_rng(5)
    sector = np.array([0, 1, 2, 3, 0, 1, 9, 14], np.int32)
    path_np = path_np._replace(sector=sector)
    path_t = path_t._replace(sector=torch.from_numpy(sector))
    jwin = jax.vmap(lambda s: jpath.path_window(s, 4))(path_np)
    twin = tpath.path_window(path_t, 4)
    for key in jwin:
        close(jwin[key], twin[key])

    switch = np.array([True, False] * 4)
    jadv = jax.vmap(jpath.path_advance)(path_np, jnp.asarray(switch))
    tadv = tpath.path_advance(path_t, torch.from_numpy(switch))
    np.testing.assert_array_equal(np.asarray(jadv.sector), tadv.sector.numpy())
    np.testing.assert_array_equal(np.asarray(jadv.switched), tadv.switched.numpy())

    p_new = rng.normal(size=(8, 3))
    corr = rng.normal(size=8) * 0.05
    for offset in (1, 2):
        jc = jax.vmap(lambda s, p, c: jpath.path_apply_via_correction(s, offset, p, c))(
            path_np, jnp.asarray(p_new), jnp.asarray(corr))
        tc = tpath.path_apply_via_correction(path_t, offset, t64(p_new), t64(corr))
        for key in ("p", "seg_len", "phi_max"):
            close(getattr(jc, key), getattr(tc, key))


SPLITS = [[0, 15, 15, 15, 15], [0, 5, 15, 15, 15], [0, 3, 9, 15, 15], [0, 1, 4, 8, 15]]


@pytest.mark.parametrize("split", SPLITS, ids=[str(s[1:4]) for s in SPLITS])
def test_reference_and_error_functions(fleet_paths, split):
    path_np, _ = fleet_paths
    rng = np.random.default_rng(6)
    win = jax.tree.map(np.asarray, jpath.path_window(
        jax.tree.map(lambda a: a[3], path_np), 4))
    win.update({k: rng.normal(size=(4, 3)) for k in ("v1", "v2", "v3")})
    params = {k: rng.normal(size=(4, 3)) * 0.1 for k in
              ("dtau_init", "dtau_init_par", "dtau_init_orth1", "dtau_init_orth2")}
    params["jac_dtau_l"] = np.eye(3) + 0.1 * rng.normal(size=(3, 3))
    params["jac_dtau_r"] = np.eye(3) + 0.1 * rng.normal(size=(3, 3))
    params["i_omega_ref_0"] = rng.normal(size=3) * 0.1
    split_idx = np.asarray(split, np.int32)
    p = rng.normal(size=(15, 6)) * 0.3
    v = rng.normal(size=(15, 6)) * 0.3
    omega0 = rng.normal(size=3) * 0.1

    jw = {k: jnp.asarray(a) for k, a in win.items()}
    jp = {k: jnp.asarray(a) for k, a in params.items()}

    def jone(i, pp, vv):
        ref = jref.reference_function(jw, jnp.asarray(split_idx), i, pp, vv, 15, 4)
        err = jref.error_function(ref, jp, jnp.asarray(split_idx), i, pp, vv,
                                  jnp.asarray(omega0), 15, 4)
        return ref, err

    tw = {k: t64(a) for k, a in win.items()}
    tp = {k: t64(a) for k, a in params.items()}
    ts = torch.from_numpy(split_idx)

    def tone(i, pp, vv):
        ref = tref.reference_function(tw, ts, i, pp, vv, 15, 4)
        err = tref.error_function(ref, tp, ts, i, pp, vv, t64(omega0), 15, 4)
        return ref, err

    jr, je = jax.vmap(jone)(jnp.arange(15), jnp.asarray(p), jnp.asarray(v))
    tr, te = tvmap(tone)(torch.arange(15), t64(p), t64(v))
    for key in jr:
        close(jr[key], tr[key])
    for key in je:
        close(je[key], te[key])
