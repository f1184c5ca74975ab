"""Warm-start shifting in the port (``mpc.ocp.shift_warm_start``): the
shifted vector reproduces the tail of the previous rollout, as
``tests/test_warm_shift.py`` holds the JAX package's; and it equals the
JAX package's shift by value on the same vector (float64)."""

import numpy as np

import jax.numpy as jnp
import torch

from boundplanner_tpu.config import MPCParams as JaxMPCParams
from boundplanner_tpu.mpc import ocp as jocp
from boundplanner_tpu_torch.config import MPCParams
from boundplanner_tpu_torch.mpc import ocp

torch.set_num_threads(1)


def test_shift_preserves_rollout_tail(rng):
    cfg = MPCParams()
    n = cfg.n
    nx = ocp.n_vars(n)
    x = torch.from_numpy(rng.normal(size=nx) * 0.2)
    xs = ocp.shift_warm_start(x, cfg)
    assert xs.shape == x.shape
    o = 7 * (n - 1)
    u = x[:o].reshape(n - 1, 7).numpy()
    u_s = xs[:o].reshape(n - 1, 7).numpy()
    np.testing.assert_allclose(u_s[:-1], u[1:], atol=1e-12)
    np.testing.assert_allclose(u_s[-1], u[-1], atol=1e-12)
    # integrated slack offset advances by one trapezoid increment:
    # new rslacks[0] == old rslacks[1]
    zero = torch.zeros(7, dtype=x.dtype)
    _, _, rs0, drs, ps0, dps = ocp.unpack(x, zero, n)
    rsl_old, psl_old = ocp.slack_trajectories(rs0, drs, ps0, dps, cfg.dt)
    _, _, rs0_s, drs_s, ps0_s, dps_s = ocp.unpack(xs, zero, n)
    rsl_new, psl_new = ocp.slack_trajectories(rs0_s, drs_s, ps0_s, dps_s, cfg.dt)
    np.testing.assert_allclose(float(rsl_new[0]), float(rsl_old[1]), atol=1e-12)
    np.testing.assert_allclose(rsl_new[:-1].numpy(), rsl_old[1:].numpy(), atol=1e-12)
    np.testing.assert_allclose(psl_new[:-1].numpy(), psl_old[1:].numpy(), atol=1e-12)


def test_shift_matches_jax(rng):
    """One vector and a batch of them (the fleet's layout), against the
    JAX package's shift at 1e-15."""
    cfg, jcfg = MPCParams(), JaxMPCParams()
    nx = ocp.n_vars(cfg.n)
    x = rng.normal(size=(3, nx)) * 0.2
    want = np.stack([np.asarray(jocp.shift_warm_start(jnp.asarray(row), jcfg)) for row in x])
    got = ocp.shift_warm_start(torch.from_numpy(x), cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)
    np.testing.assert_allclose(ocp.shift_warm_start(torch.from_numpy(x[0]), cfg).numpy(),
                               want[0], rtol=0, atol=1e-15)
