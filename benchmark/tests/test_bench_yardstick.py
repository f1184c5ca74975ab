"""The frozen arithmetic on synthetic inputs: the busy union and its gaps,
the roofline bound and shares, the analytic FLOPs, and the readers."""

import dataclasses

import pytest

from benchmark import harness, yardstick as ys
from benchmark.reference.bmpc import config as ref_config


def test_union_and_gaps():
    spans = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (10.0, 10.5)]
    assert ys.union_length(spans) == pytest.approx(3.5)
    assert ys.gaps(spans) == [(2.0, 3.0), (4.0, 10.0)]
    assert ys.union_length([]) == 0.0


def test_bound_bytes_and_operations():
    t, by = ys.bound_s(3.35e12, 1.0, "float32")
    assert t == pytest.approx(1.0) and by == "bytes"
    t, by = ys.bound_s(1.0, 34e12, "float64")
    assert t == pytest.approx(1.0) and by == "operations"


def test_kernel_work_matches_the_kernel_table():
    """Kernel A at (128, 136, 136) f32 and kernel B at P = 12288: the bounds
    of PERF.md's table of kernels (0.00425 ms and 0.00104 ms)."""
    b, ops = ys.kkt_inverse_work(128, 136, 4)
    assert 1e3 * ys.bound_s(b, ops, "float32")[0] == pytest.approx(0.00425, rel=5e-3)
    assert 1e3 * ys.bound_s(ys.seg_poly_work(12288), 0.0, "float32")[0] == pytest.approx(
        0.00104, rel=5e-3)


def test_solve_flops_frozen_equals_the_programs():
    from boundplanner_tpu_torch.config import MPCParams, perf_mpc_params
    from boundplanner_tpu_torch.mpc.flops import solve_flops

    for cfg in (perf_mpc_params(), MPCParams(), dataclasses.replace(perf_mpc_params(),
                                                                    struct_chunked=True)):
        assert ys.solve_flops(cfg) == pytest.approx(solve_flops(cfg)["total"], rel=1e-12)


def _trace(device, scenes=128, ticks=2, window_s=1.0):
    busy = ys.union_length([(lo, hi) for _, lo, hi in device])
    return {"device": device, "busy_s": busy, "window_s": window_s, "ticks": ticks,
            "scenes": scenes, "breakdown": {}}


def _run(config="iiwa14.perf_f32", trace=None, window=None):
    man = harness.manifest()
    conf = next(c for c in man["configs"] if c["name"] == config)
    return {"config": harness.load_json(f"{harness.ROOT}/{conf['file']}"), "trace": trace,
            "window": window or {}, "counters": {}, "setup_s": 1.0}


def test_kkt_roofline_reader():
    """Kernel A's launches at their bound time read 100 %, at twice it 50 %;
    a trace with another count of launches than the configuration's reads
    nothing, as does one without the kernel."""
    cfg = ref_config.perf_mpc_params()
    per_tick = cfg.sqp_iters * cfg.qp_iters
    b, ops = ys.kkt_inverse_work(128, 136, 4)
    t = ys.bound_s(b, ops, "float32")[0]
    name = "void chol_inverse_kernel<float>(...)"
    dev = [(name, float(i), float(i) + t) for i in range(2 * per_tick)]
    dev += [("elementwise", 100.0, 100.5)]
    reader = harness.reader("kkt_inverse_roofline.f32")
    assert reader.read(_run(trace=_trace(dev))) == pytest.approx(100.0)
    slow = [(n, lo, lo + 2 * (hi - lo)) for n, lo, hi in dev]
    assert reader.read(_run(trace=_trace(slow))) == pytest.approx(50.0, rel=1e-6)
    assert reader.read(_run(trace=_trace(dev[1:]))) is None
    assert reader.read(_run(trace=_trace([("elementwise", 0.0, 1.0)]))) is None


def test_kkt_roofline_reader_f64_counts_the_link_ipm():
    cfg = ref_config.MPCParams()
    kkt, link = cfg.sqp_iters * cfg.qp_iters, 25
    t_kkt = ys.bound_s(*ys.kkt_inverse_work(128, 136, 8), "float64")[0]
    t_link = ys.bound_s(*ys.kkt_inverse_work(128 * 96, 4, 8), "float64")[0]
    name = "chol_inverse_kernel<double>"
    dev = [(name, 0.0, t_kkt)] * kkt + [(name, 0.0, t_link)] * link
    run = _run(config="iiwa14.default_f64", trace=_trace(dev, ticks=1))
    assert harness.reader("kkt_inverse_roofline.f32").read(run) == pytest.approx(100.0)


def test_seg_poly_roofline_reader():
    tb = ys.bound_s(ys.seg_poly_work(128 * 96), 0.0, "float32")[0]
    dev = [("line_polytope_kernel<float>", 0.0, 4 * tb), ("line_polytope_kernel<float>", 1.0,
                                                           1.0 + 4 * tb)]
    reader = harness.reader("seg_poly_roofline.f32")
    assert reader.read(_run(trace=_trace(dev))) == pytest.approx(25.0)
    assert reader.read(_run(trace=_trace(dev[:1]))) is None
    assert reader.read(_run(config="iiwa14.default_f64", trace=_trace(dev))) is None


def test_idle_share_device_time_and_mfu():
    dev = [("k", 0.0, 0.25), ("k", 0.5, 0.75)]
    run = _run(trace=_trace(dev, ticks=2, window_s=1.0))
    assert harness.reader("idle_share.f32").read(run) == pytest.approx(50.0)
    assert harness.reader("tick_device_ms.f32").read(run) == pytest.approx(250.0)
    assert harness.reader("kernels_per_tick.f32").read(run) == pytest.approx(1.0)
    cfg = ref_config.perf_mpc_params()
    solves = 67e12 / ys.solve_flops(cfg)           # one second of the f32 peak
    mfu = harness.reader("solve_mfu.f32").read(
        _run(window={"solves": solves, "window_s": 2.0}))
    assert mfu == pytest.approx(50.0)


def test_host_clock_readers():
    w = {"solves": 1000, "window_s": 2.0, "periods": 4, "period_s": [0.1, 0.2, 0.3, 0.4],
         "node_host_s": [0.01, 0.03]}
    run = _run(window=w)
    assert harness.reader("solves_per_s.f64").read(run) == pytest.approx(500.0)
    assert harness.reader("period_ms").read(run) == pytest.approx(500.0)
    assert harness.reader("period_p95_ms").read(run) == pytest.approx(385.0)
    assert harness.reader("node_host_ms.arm").read(run) == pytest.approx(20.0)
    assert harness.reader("setup_s").read(run) == 1.0
