"""``solves_per_s.f64``: the float64 fleet's solves a second (host clock).
See ``benchmark/readers.py::solves_per_s``."""

from benchmark.readers import solves_per_s as read  # noqa: F401
