"""Two reference behaviours the port checks against the JAX package:

- the euler-spiral corner blend (``path.euler_spiral.blend_corners``)
  assigns the straddling sub-segment pts[half - 1] -> pts[half] to the
  outgoing segment's set but holds its start only to the incoming set.
  On a right-angle corner whose outgoing set cuts just short of that
  start, the JAX package accepts the blend (a sub-segment that starts
  outside its own set); the port holds the start to the outgoing set too
  and leaves the corner sharp. Where the start sits in both sets, the two
  packages blend alike;
- the dry run's dig-in bar (``__graft_entry__.py``, mirrored by
  ``parallel.dryrun.executed_penetration``) reads the final tick only: a
  scene that starts inside a box, digs deeper and pulls out by the end
  passes it in both packages. ``gates.dig_in_by_tick`` reports the
  deepest dig at any tick beside it.
"""

import types

import numpy as np
import pytest

import jax.numpy as jnp

from boundplanner_tpu.path import euler_spiral as jspiral
from boundplanner_tpu_torch import gates
from boundplanner_tpu_torch.parallel.dryrun import executed_penetration
from boundplanner_tpu_torch.path import euler_spiral as tspiral

EYE = np.eye(3)


def corner_path(cut):
    """A right-angle corner at the origin (in along +x, out along +y); the
    incoming set is all of space, the outgoing set {x >= -cut}."""
    p_via = [np.array([-0.3, 0.0, 0.0]), np.zeros(3), np.array([0.0, 0.3, 0.0])]
    a_in, b_in = np.zeros((15, 3)), np.ones(15)
    a_out, b_out = np.zeros((15, 3)), np.ones(15)
    a_out[0], b_out[0] = [-1.0, 0.0, 0.0], cut
    return (p_via, [EYE] * 3, [np.array([0.0, 0.0, 1.0])] * 2,
            [np.array([0.0, 0.0, 1.0])] * 2, [np.zeros(6)] * 2, [a_in, a_out], [b_in, b_out])


def blend_points():
    """The blend's 5 points at this corner (length 0.05, 4 sub-segments)."""
    out = tspiral.blend_corners(*corner_path(1.0))
    return np.asarray(out[0][1:-1])


def test_blend_points_straddle_the_cut():
    pts = blend_points()
    assert pts.shape == (5, 3)
    # pts[1] (the straddling sub-segment's start) lies at x ~ -0.025,
    # pts[2:] at x >= -0.0126: a cut at x = -0.018 separates them
    assert pts[1, 0] < -0.018 < pts[2, 0]


def test_straddling_start_outside_its_set():
    """JAX blends the corner and its sub-segment pts[1] -> pts[2] (set 1)
    starts 6.7 mm outside set 1; the port leaves the corner sharp."""
    path = corner_path(0.018)
    j_p, _, _, _, _, j_a, j_b = jspiral.blend_corners(*path)
    assert len(j_p) == 7                     # 2 ends + 5 blend points
    # each sub-segment's endpoints against the set it was assigned
    starts_out = [float(np.max(j_a[k] @ j_p[k] - j_b[k])) for k in range(len(j_a))]
    assert starts_out[2] > 6e-3              # pts[1], the start of segment 2
    t_p, t_r, t_bp1, _, _, t_a, t_b = tspiral.blend_corners(*path)
    assert len(t_p) == 3 and len(t_a) == 2
    for got, want in zip(t_p, path[0]):
        np.testing.assert_array_equal(got, want)
    for k in range(len(t_a)):            # every segment inside its set at both ends
        assert np.max(t_a[k] @ t_p[k] - t_b[k]) <= 1e-9
        assert np.max(t_a[k] @ t_p[k + 1] - t_b[k]) <= 1e-9


def test_blend_unchanged_where_the_start_is_inside():
    path = corner_path(0.03)
    jout = jspiral.blend_corners(*path)
    tout = tspiral.blend_corners(*path)
    assert len(tout[0]) == len(jout[0]) == 7
    for got, want in zip(tout[0], jout[0]):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)
    for got, want in zip(tout[1], jout[1]):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    for got, want in zip(tout[5], jout[5]):
        np.testing.assert_array_equal(got, want)


def jax_penetration(p, obs):
    """The JAX dry run's executed-EE penetration (``__graft_entry__.py``)."""
    p3 = jnp.asarray(p)[..., :3]
    rows = jnp.einsum("bmri,bti->btmr", jnp.asarray(obs.a), p3) - jnp.asarray(obs.b)[:, None]
    pen = jnp.where(jnp.asarray(obs.mask)[:, None, :], -jnp.max(rows, axis=-1), -jnp.inf)
    d = jnp.max(pen, axis=-1)
    clean0 = d[:, 0] <= 1e-3
    pen_enter = jnp.max(jnp.where(clean0, jnp.max(d, axis=1), -jnp.inf))
    pen_digin = jnp.max(jnp.where(~clean0, d[:, -1] - d[:, 0], -jnp.inf))
    return float(pen_enter), float(pen_digin)


def box_obs(batch):
    a = np.concatenate([np.eye(3), -np.eye(3)])[None, None].repeat(batch, 0)
    b = np.full((batch, 1, 6), 0.1)                          # |x_i| <= 0.1
    return types.SimpleNamespace(a=a, b=b, mask=np.ones((batch, 1), bool))


def test_dig_in_bar_reads_the_final_tick_only():
    """Scene 0 starts clean; scene 1 starts 2 cm inside, digs 1.2 cm deeper
    at tick 2 and ends 1 cm shallower than it started: both packages' bar
    sees -1 cm, the deepest tick +1.2 cm."""
    obs = box_obs(2)
    p = np.zeros((2, 4, 6))
    p[0, :, 0] = [0.3, 0.25, 0.2, 0.15]
    p[1, :, 0] = [0.08, 0.075, 0.068, 0.09]
    enter, digin = executed_penetration(p, obs)
    assert (enter, digin) == pytest.approx(jax_penetration(p, obs), abs=1e-12)
    assert digin == pytest.approx(-0.01) and digin <= 5e-3   # the bar passes
    depth, scene, tick = gates.dig_in_by_tick(p, obs)
    assert (scene, tick) == (1, 2) and depth == pytest.approx(0.012)


def test_dig_in_by_tick_without_inside_start():
    obs = box_obs(1)
    p = np.zeros((1, 3, 6))
    p[0, :, 0] = [0.3, 0.09, 0.2]
    assert gates.dig_in_by_tick(p, obs) == (-np.inf, None, None)
    assert executed_penetration(p, obs)[0] == pytest.approx(0.01)
