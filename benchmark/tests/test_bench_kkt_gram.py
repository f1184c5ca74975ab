"""Kernel C's reader (``kkt_gram_device_ms.*``) on synthetic traces."""

import pytest

from benchmark import harness, yardstick as ys
from benchmark.reference.bmpc import config as ref_config


def _run(device, ticks=2):
    man = harness.manifest()
    conf = next(c for c in man["configs"] if c["name"] == "iiwa14.default_f64")
    trace = None
    if device is not None:
        busy = ys.union_length([(lo, hi) for _, lo, hi in device])
        trace = {"device": device, "busy_s": busy, "window_s": 1.0, "ticks": ticks,
                 "scenes": 128, "breakdown": {}}
    return {"config": harness.load_json(f"{harness.ROOT}/{conf['file']}"), "trace": trace,
            "window": {}, "counters": {}, "setup_s": 1.0}


def test_kkt_gram_device_ms_reader():
    """Kernel C's device time a tick: one launch an IPM iteration reads its
    sum over the ticks, with the second pass where a call has one; another
    count of launches, a second pass on some calls only, or no kernel C
    (the parent's program, the structured route) reads nothing."""
    cfg = ref_config.MPCParams()
    calls = 2 * cfg.sqp_iters * cfg.qp_iters
    first = [("void (anonymous namespace)::kkt_gram_kernel<true>(...)", float(i),
              float(i) + 2e-4) for i in range(calls)]
    second = [("(anonymous namespace)::kkt_gram_sum_kernel(...)", float(i) + 0.5,
               float(i) + 0.5 + 1e-5) for i in range(calls)]
    other = [("elementwise", 1e4, 1e4 + 1.0)]
    reader = harness.reader("kkt_gram_device_ms.f64")
    assert reader.read(_run(first + other)) == pytest.approx(1e3 * calls * 2e-4 / 2)
    assert harness.reader("kkt_gram_device_ms.arm").read(_run(first + second + other)) == \
        pytest.approx(1e3 * calls * 2.1e-4 / 2)
    assert reader.read(_run(first[1:] + other)) is None
    assert reader.read(_run(first + second[1:] + other)) is None
    assert reader.read(_run(other)) is None
    assert reader.read(_run(None)) is None
