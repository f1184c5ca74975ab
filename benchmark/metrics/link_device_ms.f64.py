"""``link_device_ms.f64``: the link collision sets' device time a tick (the
``link`` phase: kernel B, or the link IPM in float64), in the float64
fleet's traced rollout. See ``benchmark/phase_readers.py``."""

from benchmark.phase_readers import phase_device_ms


def read(run):
    return phase_device_ms(run, "link")
