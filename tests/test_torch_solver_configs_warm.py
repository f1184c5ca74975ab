"""The QP warm starts of the port against the JAX package: one fused tick
of ``.fleet_cache/test8.pkl`` scenes 0-1 in float64
(``torch_tick_parity.check_tick``, every output and carry leaf within
1e-7 of its largest entry) for

- ``qp_warm_dual``: each SQP iteration's IPM starts from the previous
  one's duals (ones at first);
- ``warm_sz``: the same duals paired with the warm slack
  (``qp_warm_sz``);
- ``warm_sz_alone``: ``qp_warm_sz`` without ``qp_warm_dual``, which JAX
  runs as the plain configuration: the port's tick equals its plain tick
  by value.
"""

import pytest
import torch

from torch_tick_parity import check_tick, configs, fleet_scenes
from boundplanner_tpu_torch.mpc.bound_mpc import FleetMPC
from boundplanner_tpu_torch.parallel import batch as tbatch
from boundplanner_tpu_torch.parallel.fleet_cache import to_numpy, to_torch

torch.set_num_threads(1)

CONFIGS = {
    "qp_warm_dual": dict(qp_warm_dual=True),
    "warm_sz": dict(qp_warm_dual=True, qp_warm_sz=True),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_warm_start_config_tick_matches_jax(name):
    _, out = check_tick(**CONFIGS[name])
    assert out["success"].all()


def test_warm_sz_alone_is_the_plain_tick():
    scenes = to_torch(fleet_scenes(2), "cpu", torch.float64)
    outs = []
    for fields in ({}, dict(qp_warm_sz=True)):
        model = FleetMPC(configs(**fields)[1], device="cpu", dtype=torch.float64)
        outs.append(to_numpy(tbatch.fleet_rollout(*scenes, model, 1)))
    (c0, r0), (c1, r1) = outs
    for key in r0:
        assert (r0[key] == r1[key]).all(), key
    assert (c0.x_prev == c1.x_prev).all()
