"""The structural solver configurations of the port against the JAX
package: one fused tick of ``.fleet_cache/test8.pkl`` scenes 0-1 in
float64 (``torch_tick_parity.check_tick``, every output and carry leaf
within 1e-7 of its largest entry) for

- ``chunked``: the causal chunk split of the runtime Grams;
- ``link``: the factored link-collision rows;
- ``dense_tail``: ``struct_tail=False``, the static rows in a dense QP;

and the combinations that JAX rejects, rejected by the port too:
``struct_link`` with the chunked split or without the structural tail
(``ValueError`` in both), and ADMM with the structural tail (a shape
error while JAX traces; a ``ValueError`` naming it in the port).
"""

import pytest

import jax
import jax.numpy as jnp
import torch

from boundplanner_tpu.mpc import bound_mpc as jmpc
from boundplanner_tpu.mpc import solver as jsolver
from boundplanner_tpu.parallel import batch as jbatch
from boundplanner_tpu_torch.mpc import solver as tsolver
from boundplanner_tpu_torch.mpc.bound_mpc import FleetMPC
from torch_tick_parity import check_tick, configs, fleet_scenes, jax_inputs

torch.set_num_threads(1)

STRUCTURAL = {
    "chunked": dict(struct_chunked=True),
    "link": dict(struct_link=True),
    "dense_tail": dict(struct_tail=False),
}


@pytest.mark.parametrize("name", list(STRUCTURAL))
def test_structural_config_tick_matches_jax(name):
    _, out = check_tick(**STRUCTURAL[name])
    assert out["success"].all()


REJECTED = {
    "link_chunked": dict(struct_link=True, struct_chunked=True),
    "link_dense_tail": dict(struct_link=True, struct_tail=False),
    "admm_struct_tail": dict(qp_solver="admm"),
}


@pytest.fixture(scope="module")
def jax_scene():
    """Scene 0's first-tick inputs for JAX (one scene, no batch axis)."""
    scenes = fleet_scenes(1)
    jcarry, jobs = jax.tree.map(lambda a: jnp.asarray(a)[0], jax_inputs(scenes))
    q0 = jnp.asarray(scenes[1][0])
    meas = jbatch._plant_measurement(q0, 0 * q0, 0 * q0, 0 * q0, q0, jnp.float64)
    return jcarry, meas, jobs


@pytest.mark.parametrize("name", list(REJECTED))
def test_rejected_config_raises_in_both(name, jax_scene):
    jcfg, tcfg = configs(**REJECTED[name])
    jcarry, meas, jobs = jax_scene
    params = jmpc.build_tick_params(jcarry, meas, jobs, jcfg)[0]
    # JAX raises while it traces solve_sqp: a ValueError for struct_link,
    # a shape error (TypeError) in the ADMM branch
    with pytest.raises(ValueError if "link" in name else TypeError):
        jsolver.solve_sqp(jnp.zeros(jcarry.x_prev.shape[-1]), params, jcfg)
    with pytest.raises(ValueError, match="struct_link" if "link" in name else "admm"):
        tsolver.check_supported(tcfg)
    with pytest.raises(ValueError):
        FleetMPC(tcfg, device="cpu", dtype=torch.float64)
