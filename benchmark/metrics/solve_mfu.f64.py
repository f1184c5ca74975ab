"""``solve_mfu.f64``: the whole tick's share of the card's peak in the float64 fleet.
See ``benchmark/readers.py::solve_mfu``."""

from benchmark.readers import solve_mfu as read  # noqa: F401
