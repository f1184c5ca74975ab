"""The readers of the tick's device phases and of the program's host
spans (``benchmark/phase_readers.py`` and the metric files over it), on
synthetic traces and spans."""

from types import SimpleNamespace

import pytest

from benchmark import harness
from benchmark import phase_readers as pr

NEW = ["link_device_ms.f32", "link_device_ms.f64", "link_device_ms.arm",
       "ocp_device_ms.f32", "ocp_device_ms.f64", "ocp_device_ms.arm",
       "qp_device_ms.f32", "qp_device_ms.f64", "qp_device_ms.arm",
       "line_search_device_ms.f32", "line_search_device_ms.f64", "line_search_device_ms.arm",
       "node_fk_ms.arm", "tick_host_ms.arm", "handoff_ms.arm", "replay_launch_ms.f32"]


def tick_events(t0, sqp=2):
    """One tick's device events from ``t0`` (seconds): a mark, then a
    1 ms kernel, for tick, link, rest, SQP iterations and rest; the
    link phase holds two overlapping kernels."""
    out, t = [], t0
    phases = ["tick", "link", "rest"] + ["ocp", "qp", "line_search"] * sqp + ["rest"]
    for phase in phases:
        out.append((pr.MARK + phase, t, t + 1e-6))
        out.append(("work_" + phase, t + 1e-5, t + 1.01e-3))
        if phase == "link":
            out.append(("work_link2", t + 0.5e-3, t + 1.51e-3))
            t += 0.5e-3
        t += 2e-3
    return out, t


def traced(ticks=2, declared=None, lead=True):
    events, t = [], 0.0
    if lead:
        events.append(("before_any_mark", -1e-3, -0.5e-3))
    for _ in range(ticks):
        evs, t = tick_events(t)
        events += evs
    events.reverse()                      # the reader sorts by start
    return {"trace": {"device": events, "ticks": ticks if declared is None else declared}}


def test_phase_split_on_synthetic_ticks():
    split = pr.phase_split(traced())
    assert split["ticks"] == 2
    assert split["marked"] == ["line_search", "link", "ocp", "qp", "rest", "tick"]
    assert split["ms"]["link"] == pytest.approx(1.5)          # two kernels' union
    for phase in ("ocp", "qp", "line_search"):
        assert split["ms"][phase] == pytest.approx(2.0)      # 2 iterations x 1 ms
        assert split["kernels"][phase] == 2
    assert split["kernels"]["link"] == 2
    # tick + rest + rest a tick, and the event before the first mark
    assert split["ms"]["rest"] == pytest.approx(3.0 + 0.25)
    assert split["kernels"]["rest"] == 3.5


def test_phase_readers_none_on_tick_mismatch_or_no_mark():
    assert pr.phase_split(traced(declared=3)) is None
    assert pr.phase_device_ms(traced(declared=1), "qp") is None
    no_link = traced()
    no_link["trace"]["device"] = [e for e in no_link["trace"]["device"]
                                  if e[0] != pr.MARK + "link"]
    assert pr.phase_device_ms(no_link, "link") is None
    assert pr.phase_device_ms(no_link, "qp") == pytest.approx(2.0)
    # the parent's trace: no mark at all
    plain = {"trace": {"device": [("k", 0.0, 1e-3)], "ticks": 1}}
    assert pr.phase_split(plain) is None
    assert pr.phase_split({"trace": None}) is None


@pytest.mark.parametrize("name", [n for n in NEW if "_device_ms." in n])
def test_device_metric_files(name):
    phase = name.split("_device_ms.")[0]
    assert harness.reader(name).read(traced()) == pytest.approx(
        {"link": 1.5, "ocp": 2.0, "qp": 2.0, "line_search": 2.0}[phase])
    assert harness.reader(name).read(traced(declared=5)) is None


def span(i, name, parent, start_ms, end_ms):
    return SimpleNamespace(id=i, name=name, parent=parent, start_ns=int(start_ms * 1e6),
                           end_ns=int(end_ms * 1e6),
                           duration=(int(end_ms * 1e6) - int(start_ms * 1e6)) * 1e-9)


def periods(n=3):
    """``n`` periods of 10 ms: fk 1 ms, a tick of 6 ms (wait 4 ms), fk
    0.5 + k ms; a hand-off of 2 ms before the first."""
    out, i = [span(1, "node.handoff", None, -3.0, -1.0)], 2
    for k in range(n):
        t = 10.0 * k
        step, tick = i, i + 2
        out += [span(i + 1, "node.fk", step, t, t + 1.0),
                span(i + 3, "tick.upload", tick, t + 1.0, t + 1.5),
                span(i + 4, "tick.wait", tick, t + 2.0, t + 6.0),
                span(tick, "tick", step, t + 1.0, t + 7.0),
                span(i + 5, "node.fk", step, t + 7.0, t + 7.5 + k),
                span(step, "node.step", None, t, t + 10.0)]
        i += 6
    return out


def test_host_span_readers():
    spans = periods()
    assert pr.node_fk_ms(spans) == pytest.approx(2.5)        # 1 + 0.5 + the median k
    assert pr.tick_host_ms(spans) == pytest.approx(2.0)
    assert pr.named_median_ms(spans, "node.handoff") == pytest.approx(2.0)
    assert pr.named_median_ms(spans, "graph.replay") is None
    for read in (pr.node_fk_ms, pr.tick_host_ms):
        assert read(None) is None and read([]) is None


@pytest.mark.parametrize("name", [n for n in NEW if "_device_ms." not in n])
def test_host_metric_files(name, monkeypatch):
    """Each reads the program's store; a program without one reads
    nothing."""
    replays = [span(100 + k, "graph.replay", None, k, k + 0.1 * (k + 1)) for k in range(3)]
    monkeypatch.setattr(pr, "program_spans", lambda: periods() + replays)
    reader = harness.reader(name)
    want = {"node_fk_ms.arm": 2.5, "tick_host_ms.arm": 2.0, "handoff_ms.arm": 2.0,
            "replay_launch_ms.f32": 0.2}[name]
    assert reader.read({}) == pytest.approx(want)
    monkeypatch.setattr(pr, "program_spans", lambda: None)
    assert harness.reader(name).read({}) is None


def test_program_spans_from_a_program_without_a_store(monkeypatch):
    from boundplanner_tpu_torch import telemetry

    monkeypatch.delattr(telemetry, "spans")
    assert pr.program_spans() is None


def test_idle_in_spans():
    run = {"trace": {"device": [("a", 0.0, 1.0), ("b", 2.0, 3.0), ("c", 4.0, 5.0)]}}
    spans = [span(1, "node.step", None, 1500.0, 2500.0), span(2, "x", None, 3200.0, 3400.0)]
    share, idle = pr.idle_in_spans(run, spans)
    assert idle == pytest.approx(2.0) and share == pytest.approx(0.7 / 2.0)
    assert pr.idle_in_spans(run, []) is None


def test_new_metrics_in_the_manifest():
    """Each new metric names its one cell, and that cell reports the
    end-to-end metric it moves."""
    man = harness.manifest()
    entries = {m["name"]: m for m in man["per_layer"]}
    cells = {"f32": "fleet128.perf_f32", "f64": "fleet128_t10.default_f64",
             "arm": "arm_shuttle.default_f64"}
    for name in NEW:
        m = entries[name]
        assert m["workloads"] == [cells[name.rsplit(".", 1)[1]]]
        assert m["source"] == ("device_trace" if "_device_ms." in name else "program_span")
        assert m["name"] in [x["name"] for x in harness.metrics_for(man, m["workloads"][0],
                                                                     "per_layer")]


def test_phase_report_span_paths():
    """The report's span tree: each path from a top span, the median over
    the top spans of its time summed (0 where a top span lacks it)."""
    from benchmark.phase_report import span_paths

    spans = periods() + [span(200, "tick.readback", 10, 5.0, 5.5)]
    paths = span_paths(spans)
    assert paths["node.step"] == {"tops": 3, "median_ms": pytest.approx(10.0)}
    assert paths["node.step/node.fk"]["median_ms"] == pytest.approx(2.5)
    assert paths["node.step/tick/tick.wait"]["median_ms"] == pytest.approx(4.0)
    assert paths["node.step/tick/tick.readback"]["median_ms"] == 0.0
    assert paths["node.handoff"]["tops"] == 1
