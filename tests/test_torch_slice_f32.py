"""The port's closed-loop slice in float32 (the working dtype on the card)
on all 8 scenes of ``.fleet_cache/test8.pkl``, 4 ticks, against the JAX
package's float32 CPU run of the same fleet.

In float32 a one-ulp difference in the link rows can flip a marginal
SQP basin (ROUND5_NOTES), so fleets are compared by statistics, not
tick by tick: outputs must be finite and of the expected shapes, the
success rate within 0.1 of JAX's (3 of the 32 tick-solves; the recorded
spread of the same JAX code across backends is 0.932-0.992), and the
final path progress within 0.05 of JAX's mean.
"""

import os

import numpy as np

import jax
import jax.numpy as jnp
import torch

from boundplanner_tpu.config import perf_mpc_params
from boundplanner_tpu.mpc import bound_mpc as jmpc
from boundplanner_tpu.parallel.batch import fleet_rollout as jax_fleet_rollout
from boundplanner_tpu_torch.mpc.bound_mpc import FleetMPC
from boundplanner_tpu_torch.parallel.batch import fleet_rollout
from boundplanner_tpu_torch.parallel.fleet_cache import load, to_numpy, to_torch

torch.set_num_threads(1)
CFG = perf_mpc_params()
FLEET8 = os.path.join(os.path.dirname(__file__), "..", ".fleet_cache", "test8.pkl")
TICKS = 4


def test_f32_fleet_within_jax_spread():
    payload = load(FLEET8)
    carry, q0, obs = payload["carry"], payload["q0"], payload["obs"]
    assert np.asarray(q0).dtype == np.float32
    jcarry = jmpc.MPCCarry(jmpc.PathState(*carry.path), *carry[1:])
    _, jrecs = jax_fleet_rollout(jcarry, jnp.asarray(q0, jnp.float32),
                                 jmpc.ObstacleArrays(*obs), CFG, TICKS)
    jrecs = jax.tree.map(np.asarray, jrecs)

    model = FleetMPC(CFG).to(torch.float32)
    final, trecs = fleet_rollout(*to_torch((carry, q0, obs), "cpu", torch.float32),
                                 model, TICKS)
    trecs = to_numpy(trecs)
    for key, val in trecs.items():
        assert val.shape == jrecs[key].shape
        assert np.all(np.isfinite(val.astype(np.float64))), key
    assert trecs["q"].dtype == np.float32
    assert all(np.all(np.isfinite(x)) for x in to_numpy(final.x_prev))

    s_port = float(trecs["success"].mean())
    s_jax = float(jrecs["success"].mean())
    print(f"success port {s_port:.4f} jax {s_jax:.4f}")
    assert abs(s_port - s_jax) <= 0.1, (s_port, s_jax)
    phi_port = float(trecs["phi"][:, -1].mean())
    phi_jax = float(jrecs["phi"][:, -1].mean())
    print(f"mean phi port {phi_port:.4f} jax {phi_jax:.4f}")
    assert abs(phi_port - phi_jax) <= 0.05, (phi_port, phi_jax)
