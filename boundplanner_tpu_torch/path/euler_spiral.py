"""Euler-spiral (clothoid) corner blending between linear path segments
(the port's copy of ``boundplanner_tpu/path/euler_spiral.py``: pure numpy
and scipy, unchanged, so the two packages blend corners identically).

Functional equivalent of `bound_planner/ReferencePath/euler_spiral.py`
(bit-rotted and unwired in the reference snapshot — SURVEY.md §2.4),
derived independently rather than transcribed:

A clothoid with curvature kappa(s) = 2*a*s has tangent angle
alpha(s) = a*s^2 and position given by the Fresnel-type integral

    F_a(s) = integral_0^s (cos(a t^2), sin(a t^2)) dt.

To blend a corner between unit directions ``u`` (incoming) and ``w``
(outgoing) with total turn ``theta``, run a clothoid of half-length L
whose curvature ramps 0 -> kappa_max (turning theta/2), then its mirror
image ramping back to 0 (turning the remaining theta/2). Choosing
``a = theta / (2 L^2)`` makes alpha(L) = theta/2. By the mirror symmetry
of the second half,

    p(s) = F_a(s)                                  for s in [0, L]
    p(s) = F_a(L) + R(theta) C (F_a(L) - F_a(2L-s)) for s in [L, 2L]

with R(theta) the 2-D rotation and C = diag(1, -1): substituting
t = 2L - s turns the second-half tangent (cos(theta - a t^2),
sin(theta - a t^2)) into R(theta) C (cos(a t^2), sin(a t^2)).

Placement is closed-form: with the blend start on the incoming line at
distance d before the corner, the exit point must lie on the outgoing
ray, i.e. p(2L) = (d, 0) + r (cos theta, sin theta) for some r >= 0.
Two equations, two unknowns:

    r = p_y(2L) / sin(theta),   d = p_x(2L) - r cos(theta).

(The reference reaches the same point via an explicit projection +
angle construction, `euler_spiral.py:45-58`.) F_a is evaluated with
fixed-order Gauss-Legendre quadrature — vectorized over arc samples and
accurate to ~1e-15 for the small turn angles of path corners, unlike a
truncated Taylor series.
"""

from __future__ import annotations

import numpy as np

_GL_NODES, _GL_WEIGHTS = np.polynomial.legendre.leggauss(24)


def eval_euler_spiral(a, s):
    """Clothoid position F_a(s); ``s`` may be a scalar or an array.

    Returns shape (..., 2): (integral cos(a t^2), integral sin(a t^2)).
    """
    s = np.asarray(s, float)
    t = 0.5 * s[..., None] * (_GL_NODES + 1.0)  # map [-1, 1] -> [0, s]
    ang = a * t * t
    half_w = 0.5 * s[..., None] * _GL_WEIGHTS
    return np.stack(
        [np.sum(half_w * np.cos(ang), -1), np.sum(half_w * np.sin(ang), -1)],
        axis=-1,
    )


def _rot2(angle):
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s], [s, c]])


def create_euler_spiral(v1, v2, length: float = 0.05):
    """Clothoid blend parameters for the corner v1 -> v2.

    Returns ``(a, b, theta, plane, offset, shortenings)``:
      a, b        : curvature slopes of the two halves (b = -a)
      theta       : full corner turn angle, in (0, pi)
      plane       : (2, 3) rows (u, u_perp) spanning the corner plane;
                    local 2-D coords map back via ``plane.T @ xy``
      offset      : blend start sits ``offset + length`` before the
                    corner along v1
      shortenings : arc-parameter corrections [d - L, r - L] for the
                    incoming / outgoing segments (d, r = corner
                    distances of the blend start / end)
    """
    u = np.asarray(v1, float)
    w = np.asarray(v2, float)
    u = u / np.linalg.norm(u)
    w = w / np.linalg.norm(w)

    if np.linalg.norm(u - w) < 1e-3:  # straight-through: nothing to blend
        return 0.0, 0.0, 0.0, np.vstack((u, w)), 0.0, [0.0, 0.0]

    # orthonormal corner-plane frame with u_perp on w's side, so the
    # local turn is always positive
    u_perp = w - (u @ w) * u
    u_perp = u_perp / np.linalg.norm(u_perp)
    plane = np.vstack((u, u_perp))
    theta = float(np.arctan2(u_perp @ w, u @ w))  # in (0, pi)

    a = theta / (2.0 * length**2)  # alpha(L) = a L^2 = theta / 2

    # full-blend exit point from the mirror identity at s = 2L
    p_mid = eval_euler_spiral(a, length)
    p_exit = p_mid + _rot2(theta) @ (p_mid * np.array([1.0, -1.0]))

    # closed-form placement on the corner's two rays
    r_out = p_exit[1] / np.sin(theta)
    d_in = p_exit[0] - r_out * np.cos(theta)

    return a, -a, theta, plane, d_in - length, [d_in - length, r_out - length]


def blend_corners(
    p_via,
    r_via,
    bp1,
    br1,
    e_r_bound,
    a_sets,
    b_sets,
    length: float = 0.05,
    n_sub: int = 4,
):
    """Replace each interior corner of a piecewise-linear via path with a
    discretized clothoid blend (``n_sub`` sub-segments through the spiral).

    Opt-in pre-processing for `reference_path.build_path` — EXCEEDS the
    reference, whose euler-spiral module is bit-rotted and unwired on this
    branch (`bound_planner/ReferencePath/euler_spiral.py:16-82`, SURVEY.md
    §2.4): the MPC's reference math stays piecewise-linear, so the blend
    is realized as extra via points sampled ON the clothoid. Tangent
    discontinuity at each sub-corner is theta/n_sub instead of theta.

    Per-segment attributes (bp1/br1/e_r_bound/a_sets/b_sets) are inherited
    from the incoming half of the corner for sub-segments before the
    spiral midpoint and from the outgoing half after it; rotations are
    slerped at the sub-points' fractional positions so the integrated
    rotation reference is unchanged at the original vias.

    When the path feeds the MPC, keep ``2 * length / n_sub`` (the
    sub-segment length) comparable to the horizon's per-tick advance:
    with n_sub=4 at length=0.05 the 0.025 m sub-segments shrink the
    nr_segs=4 OCP window to ~0.1 m of lookahead against a 1.5 s horizon
    and the solve wedges on the window's phi cap (measured, round 5);
    n_sub=2 tracks cleanly.

    A corner is blended only if (a) both adjacent segments leave room for
    the blend (plus room for the neighboring corners' blends), and (b)
    every sampled spiral point stays inside the convex set of the segment
    it is assigned to — otherwise that corner is left sharp. Returns the
    new ``(p_via, r_via, bp1, br1, e_r_bound, a_sets, b_sets)`` lists.
    """
    from scipy.spatial.transform import Rotation, Slerp

    p = [np.asarray(x, float) for x in p_via]
    n_corner = len(p) - 2
    if n_corner <= 0:
        return (list(p_via), list(r_via), list(bp1), list(br1),
                list(e_r_bound), list(a_sets), list(b_sets))

    new_p = [p[0]]
    new_r = [r_via[0]]
    new_bp1, new_br1, new_erb, new_a, new_b = [], [], [], [], []

    def push_seg(i_seg):
        new_bp1.append(bp1[i_seg])
        new_br1.append(br1[i_seg])
        new_erb.append(e_r_bound[i_seg])
        new_a.append(a_sets[i_seg])
        new_b.append(b_sets[i_seg])

    for i in range(1, len(p) - 1):
        v1 = p[i] - p[i - 1]
        v2 = p[i + 1] - p[i]
        l_in, l_out = np.linalg.norm(v1), np.linalg.norm(v2)
        # room: each segment may host blends at BOTH its ends
        room = 2.5 * length
        a_spl, _, theta, plane, offset, short = create_euler_spiral(
            v1, v2, length
        )
        d_in = short[0] + length   # blend start distance before the corner
        r_out = short[1] + length  # blend end distance after the corner
        ok = (
            theta > 1e-3
            and l_in > room + d_in
            and l_out > room + r_out
        )
        if ok:
            # sample at equal-TURN increments (curvature is linear in s,
            # so equal-arc chunks concentrate turn at the midpoint): the
            # cumulative turn is a s^2 on the first half and
            # theta - a (2L - s)^2 on the mirrored second half
            tau = theta * np.arange(n_sub + 1) / n_sub
            s = np.where(
                tau <= 0.5 * theta,
                np.sqrt(np.maximum(tau, 0.0) / a_spl),
                2.0 * length - np.sqrt(np.maximum(theta - tau, 0.0) / a_spl),
            )
            pts = eval_blend(a_spl, theta, plane, offset, length, s, p[i], v1, v2)
            # containment: first half must sit in the incoming segment's
            # set, second half in the outgoing's. The straddling
            # sub-segment pts[half - 1] -> pts[half] takes the outgoing
            # set, so its start is held to that set too (the JAX package
            # holds it to the incoming set only, and accepts blends whose
            # straddling sub-segment leaves its set)
            half = (n_sub + 1) // 2
            in_ok = np.all(
                a_sets[i - 1] @ pts[:half].T - np.asarray(b_sets[i - 1])[:, None]
                <= 1e-9
            )
            out_ok = np.all(
                a_sets[i] @ pts[half - 1:].T - np.asarray(b_sets[i])[:, None] <= 1e-9
            )
            ok = bool(in_ok and out_ok)
        if not ok:
            new_p.append(p[i])
            new_r.append(r_via[i])
            push_seg(i - 1)
            continue
        # rotations: slerp along the fractional position of each sub-point
        # on its original segment (incoming for the first half)
        rot_in = Slerp(
            [0.0, 1.0],
            Rotation.from_matrix(np.stack([r_via[i - 1], r_via[i]])),
        )
        rot_out = Slerp(
            [0.0, 1.0],
            Rotation.from_matrix(np.stack([r_via[i], r_via[i + 1]])),
        )
        for k, pt in enumerate(pts):
            if k < half:
                frac = np.clip(
                    np.dot(pt - p[i - 1], v1) / max(l_in**2, 1e-12), 0.0, 1.0
                )
                new_r.append(rot_in(frac).as_matrix())
            else:
                frac = np.clip(
                    np.dot(pt - p[i], v2) / max(l_out**2, 1e-12), 0.0, 1.0
                )
                new_r.append(rot_out(frac).as_matrix())
            new_p.append(pt)
            push_seg(i - 1 if k < half else i)

    new_p.append(p[-1])
    new_r.append(r_via[-1])
    push_seg(len(p) - 2)
    return new_p, new_r, new_bp1, new_br1, new_erb, new_a, new_b


def eval_blend(a, theta, plane, offset, length, s, corner, v1, v2):
    """Evaluate the blended 3-D path at arc parameter ``s`` in [0, 2L],
    measured from the blend start (``offset + length`` before the corner
    along v1). ``s`` may be a scalar or an array; returns (..., 3)."""
    u = np.asarray(v1, float)
    u = u / np.linalg.norm(u)
    start = np.asarray(corner, float) - (offset + length) * u

    s = np.asarray(s, float)
    first = eval_euler_spiral(a, np.minimum(s, length))
    p_mid = eval_euler_spiral(a, length)
    tail = p_mid - eval_euler_spiral(a, np.clip(2.0 * length - s, 0.0, length))
    mirror = _rot2(theta) * np.array([1.0, -1.0])  # R(theta) @ diag(1, -1)
    second = p_mid + tail @ mirror.T
    xy = np.where((s <= length)[..., None], first, second)
    return start + xy @ plane
