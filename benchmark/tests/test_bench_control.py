"""The controls, on the card at a size a test run holds: each cell's
control (the program with TF32 on for the float32 fleet; the reference in
float32 in the program's place for the float64 cells) fails at least one
of the cell's compared numbers, and a sound run of the program fails
none. ``benchmark/control.py`` reads the same at the cells' own sizes."""

import pytest

from benchmark import control, harness


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _readings(card, workload, traffic, seeds, **kw):
    man = harness.manifest()
    c = harness.cell(man, workload)
    c["traffic"].update(traffic)
    out = []
    if c["traffic"]["driver"] == "fleet_rollout":
        control.fleet_readings(c, seeds, card, out.append)
    else:
        control.arm_readings(c, seeds, card, out.append, kw.get("periods", 2))
    return c["limits"]["compare"], out


def _fails(numbers, limits):
    return [k for k, lim in limits.items() if k in numbers and numbers[k] > lim]


@pytest.mark.cuda
@pytest.mark.parametrize("workload,traffic", [
    ("fleet128.perf_f32", {"scenes": 32, "chunk": 32, "ticks": 4}),
    ("fleet128_t10.default_f64", {"scenes": 8, "chunk": 8, "ticks": 2}),
])
def test_fleet_control_fails_sound_passes(card, workload, traffic):
    limits, rows = _readings(card, workload, traffic, [2**31 + 11])
    for row in rows:
        assert not _fails(row["sound"], limits), row["sound"]
        assert _fails(row["control"], limits), row["control"]


@pytest.mark.cuda
def test_arm_control_fails_sound_passes(card):
    limits, rows = _readings(card, "arm_shuttle.default_f64",
                             {"leg_periods": 2, "warm_periods": 1}, [2**31 + 12], periods=2)
    for row in rows:
        assert not _fails(row["sound"], limits), row["sound"]
        assert _fails(row["control"], limits), row["control"]
