"""Triangle-basis (piecewise-linear) jerk spline evaluation
(port of ``boundplanner_tpu/utils/jerk_spline.py``).

A jerk trajectory given by samples ``u_j`` at knots ``t_j = j h`` is
interpolated linearly; acceleration, velocity and position follow by
exact integration. Within knot interval j the jerk is affine
(u_j + du_j s), so the chain of antiderivatives is a quartic evaluated at
tau_j = clip(t - t_j, 0, h), summed over the intervals in order (the JAX
package's ``lax.scan`` becomes a loop over the knots).
"""

from __future__ import annotations

import math

import torch


def eval_spline(u, h, t, q0=0.0, v0=0.0, a0=0.0):
    """(jerk, acc, vel, pos) at time ``t``.

    u: (M,) or (M, D) jerk knot values (tensor or array); h: knot spacing;
    t: scalar time (a Python float). Initial conditions q0/v0/a0 broadcast against the
    trailing dims of u."""
    u = torch.as_tensor(u)
    m = u.shape[0]
    knots = torch.arange(m - 1, dtype=u.dtype, device=u.device) * h
    taus = torch.clamp(t - knots, 0.0, h)
    u0s = u[:-1]
    dus = (u[1:] - u[:-1]) / h

    zero = torch.zeros(u.shape[1:], dtype=u.dtype, device=u.device)
    q, v, a = q0 + zero, v0 + zero, a0 + zero
    for j in range(m - 1):
        tau, uj, du = taus[j], u0s[j], dus[j]
        q = q + v * tau + a * tau**2 / 2.0 + uj * tau**3 / 6.0 + du * tau**4 / 24.0
        v = v + a * tau + uj * tau**2 / 2.0 + du * tau**3 / 6.0
        a = a + uj * tau + du * tau**2 / 2.0

    idx = min(max(math.floor(float(t) / h), 0), m - 2)
    tau_j = min(max(float(t) - idx * h, 0.0), h)
    jerk = u[idx] + (u[idx + 1] - u[idx]) / h * tau_j
    return jerk, a, v, q


def eval_jerk(u, h, t):
    return eval_spline(u, h, t)[0]


def eval_acceleration(u, h, a0, t):
    return eval_spline(u, h, t, a0=a0)[1]


def eval_velocity(u, h, v0, a0, t):
    return eval_spline(u, h, t, v0=v0, a0=a0)[2]


def eval_position(u, h, q0, v0, a0, t):
    return eval_spline(u, h, t, q0=q0, v0=v0, a0=a0)[3]
