"""Closed-form jerk-spline joint integration
(port of ``boundplanner_tpu/utils/integration.py``)."""

from __future__ import annotations


def integrate_jerk_step(q, dq, ddq, u0, u1, dt):
    """One dt of the jerk-spline chain; elementwise, any leading dims."""
    q_n = q + dt * dq + dt**2 / 2.0 * ddq + dt**3 / 8.0 * u0 + dt**3 / 24.0 * u1
    dq_n = dq + dt * ddq + dt**2 / 3.0 * u0 + dt**2 / 6.0 * u1
    ddq_n = ddq + dt / 2.0 * (u0 + u1)
    return q_n, dq_n, ddq_n
