"""The QP-solver configurations of the port against the JAX package: one
fused tick of ``.fleet_cache/test8.pkl`` scenes 0-1 in float64
(``torch_tick_parity.check_tick``, every output and carry leaf within
1e-7 of its largest entry) for

- ``admm``: ``qp_solver="admm"`` on the dense route (``struct_ocp=False``,
  the forward-mode Jacobian of every row);
- ``admm_dense_tail``: ADMM on the structured Jacobian with the static
  rows dense (``struct_tail=False``), the phase ``admm`` of the on-card
  smoke test;
- ``kkt2``: the frozen KKT factor, refreshed every second IPM iteration.
"""

import pytest
import torch

from torch_tick_parity import check_tick

torch.set_num_threads(1)

CONFIGS = {
    "admm": dict(struct_ocp=False, qp_solver="admm"),
    "admm_dense_tail": dict(struct_tail=False, qp_solver="admm"),
    "kkt2": dict(kkt_every=2),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_qp_config_tick_matches_jax(name):
    _, out = check_tick(**CONFIGS[name])
    assert out["success"].all()
