"""Small entry points of the port: the JAX package's aliases that its demo
imports (``init_carry_np``, ``build_path_np``), and the kernel-B chain
probe's CLI (``python -m boundplanner_tpu_torch.ops.proj_chain``), which
runs on the card unless asked for the CPU and replays on the host."""

import json
import os

import pytest
import torch

from boundplanner_tpu.mpc import bound_mpc as jbound_mpc
from boundplanner_tpu.path import reference_path as jreference_path
from boundplanner_tpu_torch.mpc import bound_mpc
from boundplanner_tpu_torch.ops import proj_chain
from boundplanner_tpu_torch.path import reference_path

torch.set_num_threads(1)
FLEET8 = os.path.join(os.path.dirname(__file__), "..", ".fleet_cache", "test8.pkl")


def test_jax_aliases():
    assert jbound_mpc.init_carry_np is jbound_mpc.init_carry
    assert bound_mpc.init_carry_np is bound_mpc.init_carry
    assert jreference_path.build_path_np is jreference_path.build_path
    assert reference_path.build_path_np is reference_path.build_path


def test_proj_chain_cli_on_cpu(capsys):
    assert proj_chain.main([FLEET8, "--device", "cpu"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["device"] == "cpu" and row["problems"] == 8 * 96
    assert row["equal_to_plain"]


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_proj_chain_cli_defaults_to_the_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        proj_chain.main([FLEET8])
