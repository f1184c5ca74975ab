"""The port's scene replay, long-horizon gate, escalation probe and gate
CLI (``boundplanner_tpu_torch.gates``) against the JAX package's tools:

- ``scene_replay(scene=43)`` for 3 ticks in float64 against the JAX
  package's ``fleet_rollout`` on the same one-scene slice of the cached
  128-scene fleet (``tools/gate_scene43.py``'s loop), at 1e-7;
- ``long_horizon`` on a small fleet: the diagnostic loop equal to
  ``chunked_rollout`` by value, the chronologies' fields;
- ``probe_escalation`` for 2 ticks: both arms run, each scene's row has
  the JAX tool's fields;
- the CLI runs on the card unless asked for the CPU.
"""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from boundplanner_tpu.config import perf_mpc_params as jax_perf_mpc_params
from boundplanner_tpu.mpc import bound_mpc as jmpc
from boundplanner_tpu.parallel.batch import fleet_rollout as jax_fleet_rollout
from boundplanner_tpu_torch import gates
from boundplanner_tpu_torch.parallel.fleet_cache import load, tree_map

torch.set_num_threads(1)
ROOT = os.path.join(os.path.dirname(__file__), "..")
FLEET128 = os.path.join(ROOT, ".fleet_cache", "fleet_b128_s7_segs4.pkl")
FLEET8 = os.path.join(ROOT, ".fleet_cache", "test8.pkl")
SCENE = 43
TICKS = 3


def f64(a):
    a = np.asarray(a)
    return a.astype(np.float64) if a.dtype.kind == "f" else a


def test_scene_replay_matches_jax_fleet_rollout():
    fleet = load(FLEET128)
    carry, q0, obs = tree_map(lambda a: f64(a)[SCENE:SCENE + 1],
                              (fleet["carry"], fleet["q0"], fleet["obs"]))
    jcarry = jmpc.MPCCarry(jmpc.PathState(*carry.path), *carry[1:])
    cfg = jax_perf_mpc_params()
    roll = jax.jit(lambda c, q, o: jax_fleet_rollout(c, q, o, cfg, TICKS))
    _, jrecs = roll(jcarry, jnp.asarray(q0), jmpc.ObstacleArrays(*obs))
    jrecs = jax.tree.map(np.asarray, jrecs)
    row = gates.scene_replay(fleet, SCENE, TICKS, device="cpu", dtype=torch.float64)
    assert row["scene"] == SCENE and row["ticks"] == TICKS and row["dtype"] == "float64"
    np.testing.assert_array_equal(row["success"], jrecs["success"][0])
    for key in ("phi", "viol"):
        scale = max(np.abs(jrecs[key]).max(), 1e-30)
        np.testing.assert_allclose(row[key], jrecs[key][0], rtol=0, atol=1e-7 * scale,
                                   err_msg=key)
    assert row["max_viol"] == max(row["viol"]) and row["phi_final"] == row["phi"][-1]
    assert row["tracks"] == gates.tracks(row["phi"], row["viol"], row["success"])[0]


def test_long_horizon_diag_equals_rollout():
    fleet = load(FLEET8)
    summary, recs, diag = gates.long_horizon(fleet, ticks=2, top=2, chunk=4, device="cpu",
                                             dtype=torch.float64, watch=(3, 99))
    assert summary["diag_equal"] == {"phi": True, "success": True, "viol": True}
    for key in ("phi", "success", "viol"):
        np.testing.assert_array_equal(recs[key], diag[key])
    assert summary["scenes"] == 8 and summary["ticks"] == 2 and summary["chunk"] == 4
    assert set(summary["watch"]) == {3}
    assert len(summary["worst"]) == 2
    viol_max = diag["viol"].max(axis=1)
    assert [c["scene"] for c in summary["worst"]] == list(np.argsort(-viol_max,
                                                                     kind="stable")[:2])
    assert set(summary["worst"][0]) == {"scene", "max_viol", "fails", "ticks", "failed_ticks",
                                        "first_fail_tick", "err_cnt_max", "sector_changes",
                                        "phi_final", "dq_max"}
    # on the CPU the wrappers take the plain versions: no kernel launches
    assert summary["launches_rollout"] == summary["launches_diag"] == {
        "chol_inverse": 0, "line_polytope": 0}


def test_probe_escalation_rows_have_jax_fields():
    fleet = load(FLEET8)
    rows = gates.probe_escalation(fleet, (1, 3, 5), ticks=2, device="cpu",
                                  dtype=torch.float64)
    assert [r["arm"] for r in rows] == ["base", "escalated"]
    assert rows[0]["esc_lanes"] == 0 and rows[1]["esc_lanes"] == 4
    assert rows[1]["esc"] == [6, 8]
    for row in rows:
        assert [s["scene"] for s in row["scenes"]] == [1, 3, 5]
        for s in row["scenes"]:
            # the JAX tool's per-scene line: fails, the first failing
            # ticks (at most 8), max_viol, phi_final
            assert set(s) == {"scene", "fails", "first_fail_ticks", "max_viol", "phi_final"}
            assert len(s["first_fail_ticks"]) == min(s["fails"], 8)
        assert 0.0 <= row["success_rate"] <= 1.0 and np.isfinite(row["max_viol"])
        assert row["escalated_ticks"] >= 0
    assert rows[0]["escalated_ticks"] == 0


def test_cli_scene_on_cpu(capsys):
    rc = gates.main(["scene", "3", "2", "--device", "cpu", "--fleet", FLEET8])
    out = capsys.readouterr().out.strip().splitlines()
    row = json.loads(out[-1])
    assert row["gate"] == "scene" and row["scene"] == 3 and len(row["phi"]) == 2
    assert rc == (0 if row["tracks"] else 1)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_cli_defaults_to_the_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gates.main(["scene", "--fleet", FLEET8])
