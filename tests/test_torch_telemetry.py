"""The port's telemetry (`boundplanner_tpu_torch.telemetry`): host spans
and the tick's device phase marks.

On the CPU: the span store (nesting and parent, the ring's bound, the
profiler's host ranges only while a profiler runs, on its clock) and the
exporter; the phase sequence of one tick of a small structured-OCP
configuration, and none outside a tick (the planner's SQP), with the
marks' launcher recorded, since the CPU launches none; ``MPCNode``'s
``t_comp`` / ``t_loop`` against its spans. On the card (marker ``cuda``):
the profiler's device events of one ``StepGraph`` replay carry the marks
in capture order, and the eager route marks a card that is not the
current device.

The file imports no JAX, so that the card runs it as well:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_telemetry.py -q
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from boundplanner_tpu_torch import config as tconfig
from boundplanner_tpu_torch import telemetry
from boundplanner_tpu_torch.demo import demo_scene, stack_scenes
from boundplanner_tpu_torch.mpc import MPCNode
from boundplanner_tpu_torch.mpc.bound_mpc import FleetMPC
from boundplanner_tpu_torch.utils.tree import to_torch

torch.set_num_threads(1)
Q0 = np.array([0.0, 0.0, 0.0, -np.pi / 2, 0.0, np.pi / 2, 0.0])
# the structured OCP of the main path at a small budget
STRUCT = dataclasses.replace(tconfig.perf_mpc_params(), sqp_iters=2, qp_iters=2,
                             line_search_steps=2)


@pytest.fixture
def fresh():
    """An empty store, emptied again afterwards."""
    telemetry.clear()
    yield
    telemetry.clear()


@pytest.fixture
def launched(monkeypatch):
    """The phases whose marks are launched, in order (the launcher
    recorded in place of the card's)."""
    calls = []
    monkeypatch.setattr(telemetry, "_launch_mark", lambda phase, device: calls.append(phase))
    return calls


def test_span_nesting_and_parent(fresh):
    with telemetry.span("outer") as outer:
        with telemetry.span("inner") as inner:
            pass
        with telemetry.span("inner") as second:
            pass
    stored = telemetry.spans()
    assert [s.name for s in stored] == ["inner", "inner", "outer"]
    assert (outer.parent, inner.parent, second.parent) == (None, outer.id, outer.id)
    assert len({outer.id, inner.id, second.id}) == 3
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= second.start_ns
    assert second.end_ns <= outer.end_ns
    assert outer.duration == pytest.approx((outer.end_ns - outer.start_ns) * 1e-9)
    assert outer.duration >= inner.duration + second.duration


def test_span_ring_keeps_the_newest(fresh):
    n = telemetry.SPAN_CAPACITY + 5
    for i in range(n):
        with telemetry.span(f"s{i}"):
            pass
    stored = telemetry.spans()
    assert len(stored) == telemetry.SPAN_CAPACITY
    assert (stored[0].name, stored[-1].name) == ("s5", f"s{n - 1}")


def test_span_ranges_only_while_profiling(fresh, monkeypatch):
    opened = []
    real = torch._C._profiler._RecordFunctionFast

    def recording(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", recording)
    with telemetry.span("quiet"):
        pass
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with telemetry.span("traced") as traced:
                torch.ones(64).sum()
    assert opened == ["traced"] * 3
    events = [e for e in prof.profiler.kineto_results.events() if e.name() == "traced"]
    assert len(events) == 3 and {e.device_type() for e in events} == {DeviceType.CPU}
    # one clock: the last range (the profiler's first ranges pay its set-up)
    # holds the span, a few microseconds wider on either side
    last = max(events, key=lambda e: e.start_ns())
    assert 0 <= traced.start_ns - last.start_ns() < 2_000_000
    assert 0 <= last.end_ns() - traced.end_ns < 2_000_000
    assert [s.name for s in telemetry.spans()] == ["quiet"] + ["traced"] * 3


def test_export(fresh, tmp_path):
    rec = telemetry.TelemetryRecorder()
    with telemetry.span("node.step"):
        pass
    out = tmp_path / "telemetry.json"
    rec.dump_json(str(out))
    dumped = json.loads(out.read_text())
    assert set(dumped) == {"summary", "spans"} and dumped["summary"] == {}
    assert [s["name"] for s in dumped["spans"]] == ["node.step"]
    assert set(dumped["spans"][0]) == {"name", "start_ns", "end_ns", "parent", "id"}
    telemetry.clear()
    assert telemetry.spans() == []


def test_device_phase_marks_only_inside_a_tick(launched):
    cpu = torch.device("cpu")
    with telemetry.device_phase("ocp", cpu) as outside:
        outside.to("qp")
    assert launched == []
    with telemetry.device_tick(cpu):
        with telemetry.device_phase("link", cpu):
            pass
        with telemetry.device_phase("ocp", cpu) as phase:
            phase.to("qp")
    with telemetry.device_phase("line_search", cpu):
        pass
    assert launched == ["tick", "link", "rest", "ocp", "qp", "rest"]


def test_tick_is_closed_after_a_raise(launched):
    cpu = torch.device("cpu")
    with pytest.raises(ValueError):
        with telemetry.device_tick(cpu):
            raise ValueError
    with telemetry.device_phase("ocp", cpu):
        pass
    assert launched == ["tick"]


def test_planner_sqp_marks_nothing(launched):
    """The SQP outside a tick (the planner's via-point solve,
    `planner.via_opt`) launches no mark."""
    from boundplanner_tpu_torch.ops.sqp import gauss_newton_sqp

    target = torch.tensor([[0.3, -0.2]], dtype=torch.float64)

    def eval_fn(x):                      # (B, K, 2) -> residuals, x0 <= 0.25
        return x - target[:, None], x[..., :1] - 0.25

    res = gauss_newton_sqp(eval_fn, torch.zeros_like(target), iters=3, qp_iters=5)
    assert launched == [] and torch.isfinite(res.x).all()


def test_tick_phase_sequence(launched):
    """One tick of the structured OCP (2 SQP iterations) marks ``tick``,
    ``link``, ``rest``, then ``ocp`` / ``qp`` / ``line_search`` once per
    SQP iteration, then ``rest``."""
    carry, meas, obs = to_torch(stack_scenes(*demo_scene(STRUCT, np.float64)[:3], 2),
                                "cpu", torch.float64)
    FleetMPC(STRUCT, device="cpu", dtype=torch.float64).tick(carry, meas, obs)
    assert launched == (["tick", "link", "rest"]
                        + ["ocp", "qp", "line_search"] * STRUCT.sqp_iters + ["rest"])


def test_node_timings_are_its_spans(fresh, launched):
    """``t_loop`` of each record is the duration of the period's
    ``node.step`` span, and ``t_comp`` the time from its ``tick.replay``'s
    start to its ``tick.readback``'s end; the period's spans nest as the
    node runs them, the record is built after the period, and a hand-off
    is its own span."""
    node = MPCNode(Q0, tconfig.MPCParams(sqp_iters=1, qp_iters=2, line_search_steps=2),
                   device="cpu", dtype=torch.float64)
    telemetry.clear()
    for _ in range(2):
        node.step()
    node.update_reference(*demo_path(node))
    stored = telemetry.spans()
    by_id = {s.id: s for s in stored}
    tops = [s.name for s in stored if s.parent is None]
    assert tops == ["node.step", "node.record"] * 2 + ["node.handoff"]
    periods = [s for s in stored if s.name == "node.step"]
    for rec, period in zip(node.telemetry.ticks, periods):
        kids = [s for s in stored if s.parent == period.id]
        assert [s.name for s in kids] == ["node.fk", "tick", "node.integrate", "node.fk"]
        tick = kids[1]
        inner = {s.name: s for s in stored if s.parent == tick.id}
        assert list(inner) == ["tick.upload", "tick.replay", "tick.wait", "tick.readback"]
        assert rec.t_loop == period.duration
        assert rec.t_comp == (inner["tick.readback"].end_ns - inner["tick.replay"].start_ns) * 1e-9
        assert rec.t_overhead == rec.t_loop - rec.t_comp
        assert all(by_id[s.parent] is period for s in kids)
    # the tick's phases, once a period, on the CPU too
    assert launched.count("tick") == 2


def demo_path(node):
    """A straight 0.2 m leg from the node's pose, free sets."""
    from scipy.spatial.transform import Rotation as R

    p = node.p_lie[:3].copy()
    r0 = R.from_rotvec(np.array(node.p_lie[3:])).as_matrix()
    erb = np.array([90, 90, 90, -90, -90, -90]) * np.pi / 180
    return ([p, p + np.array([0.0, -0.2, 0.0])], [r0, r0], [np.array([0.0, 0.0, 1.0])],
            [np.array([0.0, 0.0, 1.0])], [erb], [np.zeros((15, 3))], [np.ones(15)], [])


@pytest.mark.cuda
def test_cuda_step_graph_replay_carries_the_marks(fresh):
    """On the card, one replay of the rollout's step graph (the perf
    configuration at 2 SQP iterations, 2 scenes) carries the marks as
    device events in capture order; a host span's stored start and end
    agree with its profiler range in the same trace, and no device event
    carries a span's name."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from boundplanner_tpu_torch.parallel import batch

    dev = torch.device("cuda", 0)
    carry, meas, obs = to_torch(stack_scenes(*demo_scene(STRUCT, np.float32)[:3], 2),
                                dev, torch.float32)
    model = FleetMPC(STRUCT, device=dev)
    q0 = meas["q0"]
    batch.fleet_rollout(carry, q0, obs, model, 2)        # warm-up, capture, a replay
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with telemetry.span("test.replay") as host:
            batch.fleet_rollout(carry, q0, obs, model, 1)
            torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    marks = [e.name()[len("bp_phase_"):] for e in sorted(
        (e for e in events if e.device_type() == DeviceType.CUDA), key=lambda e: e.start_ns())
        if e.name().startswith("bp_phase_")]
    assert marks == (["tick", "link", "rest"]
                     + ["ocp", "qp", "line_search"] * STRUCT.sqp_iters + ["rest"])
    # the span is a host range alone: no device event carries a span's name
    assert not [e for e in events if e.device_type() == DeviceType.CUDA
                and e.name() in ("test.replay", "graph.replay")]
    ranges = [e for e in events if e.name() == "test.replay"]
    assert len(ranges) == 1
    assert abs(host.start_ns - ranges[0].start_ns()) < 50_000
    assert abs(host.end_ns - ranges[0].end_ns()) < 50_000


@pytest.mark.cuda
def test_cuda_eager_marks_on_another_device():
    """The eager route (``graph=False``) launches its marks, in order, on
    the model's card while card 0 is the current device: the last card
    where there are two or more, card 0 on a one-card machine."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    carry, meas, obs = to_torch(stack_scenes(*demo_scene(STRUCT, np.float32)[:3], 2),
                                dev, torch.float32)
    model = FleetMPC(STRUCT, device=dev, graph=False)
    model.tick(carry, meas, obs)                          # warm-up
    torch.cuda.synchronize(dev)
    with torch.cuda.device(0):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            model.tick(carry, meas, obs)
            torch.cuda.synchronize(dev)
    marks = [e.name()[len("bp_phase_"):] for e in sorted(
        (e for e in prof.profiler.kineto_results.events()
         if e.device_type() == DeviceType.CUDA), key=lambda e: e.start_ns())
        if e.name().startswith("bp_phase_")]
    assert marks == (["tick", "link", "rest"]
                     + ["ocp", "qp", "line_search"] * STRUCT.sqp_iters + ["rest"])
