"""``solve_mfu.f32``: the whole tick's share of the card's peak in the float32 fleet.
See ``benchmark/readers.py::solve_mfu``."""

from benchmark.readers import solve_mfu as read  # noqa: F401
