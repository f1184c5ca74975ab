"""``kernels_per_tick.f32``: the card's events a tick in the float32 fleet's traced rollout.
See ``benchmark/readers.py::kernels_per_tick``."""

from benchmark.readers import kernels_per_tick as read  # noqa: F401
