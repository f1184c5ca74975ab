"""``tick_device_ms.f32``: the card's busy time a tick in the float32 fleet's traced segment.
See ``benchmark/readers.py::tick_device_ms``."""

from benchmark.readers import tick_device_ms as read  # noqa: F401
