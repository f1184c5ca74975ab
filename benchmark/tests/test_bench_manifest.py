"""The manifest (``BENCHMARK.json``) against the benchmark's contract, and
every file a cell names found by name."""

import json
import os
import re

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def man():
    return harness.manifest()


def test_top_level_keys(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert man["command"][:1] == ["python3"] and len(man["command"]) <= 32
    assert man["paths"] == ["benchmark"]
    assert 1 <= man["run_seconds"] <= 51 and isinstance(man["run_seconds"], int)
    assert len(json.dumps(man)) <= 64 * 1024


def test_names_and_units(man):
    names = [e["name"] for kind in ("configs", "workloads", "end_to_end", "per_layer")
             for e in man[kind]]
    assert all(NAME.match(n) for n in names), names
    for kind in ("configs", "workloads"):
        assert len({e["name"] for e in man[kind]}) == len(man[kind])
    metrics = [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for w in man["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]
        assert w["chips"] == 1


def test_configs(man):
    files = [c["file"] for c in man["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in man["workloads"]}
    for c in man["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("benchmark/") and os.path.exists(
            os.path.join(harness.ROOT, c["file"]))
        assert c["source"].startswith("https://") and len(c["source"]) <= 200
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert not any(k.endswith(("_dim", "_rank")) for k in c["reduced"])


def test_end_to_end(man):
    e2e = {m["name"]: m for m in man["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in man["workloads"]}
    for w in cells:
        reported = harness.metrics_for(man, w, "end_to_end")
        assert "setup_s" in {m["name"] for m in reported}
        assert len(reported) >= 2
        assert harness.metrics_for(man, w, "per_layer")


def test_per_layer_moves(man):
    """Every per-layer metric moves one end-to-end metric, which every cell
    that reports it reports too; one layer name per layer."""
    for m in man["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        moved = [e for e in man["end_to_end"] if e["name"] == m["moves"]]
        assert moved, m["name"]
        for w in m.get("workloads", [x["name"] for x in man["workloads"]]):
            assert w in moved[0].get("workloads", [w]), (m["name"], w)
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("workload", [w["name"] for w in harness.manifest()["workloads"]])
def test_cell_files_found_by_name(workload):
    """A cell's configuration, traffic, driver, limits and metric readers
    all load from the names in the manifest."""
    man = harness.manifest()
    c = harness.cell(man, workload)
    assert c["config"]["dtype"] in ("float32", "float64")
    assert c["config"]["link_route"] in ("dykstra", "ipm")
    drv = harness.driver(c["traffic"])
    assert hasattr(drv, "setup")
    assert set(c["limits"]["compare"]) and set(c["limits"]["wrong_at"])
    for kind in ("end_to_end", "per_layer"):
        for m in harness.metrics_for(man, workload, kind):
            assert callable(harness.reader(m["name"]).read)


def test_missing_file_is_a_run_error():
    with pytest.raises(harness.RunError):
        harness.reader("no_such_metric")
