"""Polynomial error-bound families, 3rd/4th/6th order (port of
``boundplanner_tpu/mpc/bounds.py``).

Each family is the unique polynomial of a small confluent-Vandermonde
system defined by its interpolation conditions (the reference's expanded
closed forms, `BoundMPC/mpc_utils_casadi.py:95-584`, give the same
polynomial):

- 4th order (phi0, phi1, e0, e1, s, e_max):
    p(phi0)=e0, p(phi1)=e1, p'(phi0)=s, p'(phi1)=-s, p(mid)=e_max
- 4th order general (s0, s1): p'(phi0)=s0, p'(phi1)=-s1
- 6th order (phi0, phi1, e0, e1, s, em): flat C^2 ends,
    p(phi0)=e0, p'(phi0)=0, p''(phi0)=0,
    p(phi1)=e1, p'(phi1)=0, p''(phi1)=0, p(mid)=em
  (the slope argument is accepted but unused, as in the reference)
- 3rd order (phi0, phi1, e0, e1, de0, dde0):
    p(phi0)=e0, p(phi1)=e1, p'(phi0)=de0, p''(phi0)=dde0

Arguments are numbers or tensors that broadcast together (a leading batch
of segments solves as one batched ``torch.linalg.solve``); they are taken
to ``device`` in ``dtype``. Coefficients come back highest degree first,
like the reference tuples.
"""

from __future__ import annotations

import math

import torch

from ..utils.device import DEFAULT_DEVICE, checked_device


def _tensors(values, device, dtype):
    dev = checked_device(device)
    return [torch.as_tensor(v, dtype=dtype, device=dev) for v in values]


def _derivative_row(t, degree: int, order: int):
    """Row of the confluent Vandermonde matrix: d^order/dt^order of
    [t^degree, ..., t, 1] at t (..., ) -> (..., degree + 1)."""
    powers = [degree - i for i in range(degree + 1)]
    coef = torch.tensor(
        [math.factorial(p) / math.factorial(p - order) if p >= order else 0.0
         for p in powers], dtype=t.dtype, device=t.device)
    expnt = torch.tensor([max(p - order, 0) for p in powers], device=t.device)
    return coef * t[..., None] ** expnt


def _solve_conditions(degree: int, conditions):
    """conditions: (t, derivative order, value) tensors. Returns the
    descending coefficients (..., degree + 1) of the unique interpolant."""
    ts = torch.broadcast_tensors(*[t for t, _, _ in conditions],
                                 *[v for _, _, v in conditions])
    n = len(conditions)
    rows = torch.stack([_derivative_row(t, degree, d)
                        for t, (_, d, _) in zip(ts[:n], conditions)], dim=-2)
    vals = torch.stack(ts[n:], dim=-1)
    return torch.linalg.solve(rows, vals)


def compute_bound_params(phi0, phi1, e0, e1, s, e_max, device=DEFAULT_DEVICE,
                         dtype=torch.float64):
    """4th-order corridor with symmetric end slopes (ref
    `mpc_utils_casadi.py:223-320`). Returns (a4, a3, a2, a1, a0)."""
    phi0, phi1, e0, e1, s, e_max = _tensors((phi0, phi1, e0, e1, s, e_max), device, dtype)
    mid = 0.5 * (phi0 + phi1)
    c = _solve_conditions(
        4, [(phi0, 0, e0), (phi1, 0, e1), (phi0, 1, s), (phi1, 1, -s), (mid, 0, e_max)])
    return tuple(c.unbind(-1))


def compute_bound_params_four(phi0, phi1, e0, e1, s0, s1, e_max, device=DEFAULT_DEVICE,
                              dtype=torch.float64):
    """4th-order corridor with independent end slopes (ref
    `mpc_utils_casadi.py:95-220`). Returns (a4, a3, a2, a1, a0)."""
    phi0, phi1, e0, e1, s0, s1, e_max = _tensors(
        (phi0, phi1, e0, e1, s0, s1, e_max), device, dtype)
    mid = 0.5 * (phi0 + phi1)
    c = _solve_conditions(
        4, [(phi0, 0, e0), (phi1, 0, e1), (phi0, 1, s0), (phi1, 1, -s1), (mid, 0, e_max)])
    return tuple(c.unbind(-1))


def compute_bound_params_six(phi0, phi1, e0, e1, s, em, device=DEFAULT_DEVICE,
                             dtype=torch.float64):
    """6th-order corridor with flat C^2 ends (ref
    `mpc_utils_casadi.py:323-481`; the slope argument is unused there too).
    Returns (a6, ..., a0)."""
    del s
    phi0, phi1, e0, e1, em = _tensors((phi0, phi1, e0, e1, em), device, dtype)
    mid = 0.5 * (phi0 + phi1)
    zero = torch.zeros_like(e0)
    c = _solve_conditions(
        6, [(phi0, 0, e0), (phi0, 1, zero), (phi0, 2, zero),
            (phi1, 0, e1), (phi1, 1, zero), (phi1, 2, zero), (mid, 0, em)])
    return tuple(c.unbind(-1))


def compute_bound_params_three(phi0, phi1, e0, e1, de0, dde0, device=DEFAULT_DEVICE,
                               dtype=torch.float64):
    """3rd-order corridor pinned by the initial value, slope and curvature
    (ref `mpc_utils_casadi.py:484-542`). Returns (a3, a2, a1, a0)."""
    phi0, phi1, e0, e1, de0, dde0 = _tensors((phi0, phi1, e0, e1, de0, dde0), device, dtype)
    c = _solve_conditions(
        3, [(phi0, 0, e0), (phi1, 0, e1), (phi0, 1, de0), (phi0, 2, dde0)])
    return tuple(c.unbind(-1))


def eval_bound_poly(phi, coeffs, device=DEFAULT_DEVICE, dtype=torch.float64):
    """A bound polynomial (descending coefficients) at phi, in Horner form,
    elementwise for a tensor phi (ref evaluators,
    `mpc_utils_casadi.py:545-584`)."""
    phi, *coeffs = _tensors((phi, *coeffs), device, dtype)
    acc = torch.zeros_like(phi) + coeffs[0]
    for c in coeffs[1:]:
        acc = acc * phi + c
    return acc


def fourth_order_error_bound(phi, phi0, phi1, e0, e1, s0, s1, e_max,
                             device=DEFAULT_DEVICE, dtype=torch.float64):
    """The general 4th-order bound evaluated at phi (ref
    `compute_fourth_order_error_bound`, `mpc_utils_casadi.py:95-220`)."""
    coeffs = compute_bound_params_four(phi0, phi1, e0, e1, s0, s1, e_max,
                                       device=device, dtype=dtype)
    return eval_bound_poly(phi, coeffs, device=device, dtype=dtype)


__all__ = [
    "compute_bound_params",
    "compute_bound_params_four",
    "compute_bound_params_six",
    "compute_bound_params_three",
    "eval_bound_poly",
    "fourth_order_error_bound",
]
