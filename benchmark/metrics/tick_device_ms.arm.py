"""``tick_device_ms.arm``: the card's busy time a tick in the single arm's traced segment.
See ``benchmark/readers.py::tick_device_ms``."""

from benchmark.readers import tick_device_ms as read  # noqa: F401
