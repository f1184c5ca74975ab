"""``line_search_device_ms.f32``: the line search's device time a tick (the
``line_search`` phase), in the float32 fleet's traced rollout. See
``benchmark/phase_readers.py``."""

from benchmark.phase_readers import phase_device_ms


def read(run):
    return phase_device_ms(run, "line_search")
