"""The port's configuration (``boundplanner_tpu_torch/config.py``) is a copy
of the JAX package's ``boundplanner_tpu/config.py``: the same fields in the
same order, the same defaults, the same constants. A copy that drifts from
the reference fails here."""

import dataclasses

import numpy as np
import pytest

from boundplanner_tpu import config as jconfig
from boundplanner_tpu_torch import config as tconfig

FACTORIES = {
    "default_mpc_params": lambda c: c.default_mpc_params(),
    "perf_mpc_params": lambda c: c.perf_mpc_params(),
    "planner_params": lambda c: c.PlannerParams(),
}


@pytest.mark.parametrize("name", list(FACTORIES))
def test_params_equal_jax(name):
    got = FACTORIES[name](tconfig)
    ref = FACTORIES[name](jconfig)
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(ref)]
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


@pytest.mark.parametrize("name", ["NUM_JOINTS", "MPC_SET_ROWS", "PLANNER_SET_ROWS",
                                  "NUM_LINK_SETS"])
def test_constants_equal_jax(name):
    assert getattr(tconfig, name) == getattr(jconfig, name)


def test_default_weights_equal_jax():
    np.testing.assert_array_equal(tconfig.default_weights(), jconfig.default_weights())
    np.testing.assert_array_equal(tconfig.MPCParams().weights_array,
                                  jconfig.MPCParams().weights_array)


def test_params_are_frozen_and_hashable():
    cfg = tconfig.perf_mpc_params()
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.qp_iters = 5
    assert hash(cfg) == hash(tconfig.perf_mpc_params())
