"""``solves_per_s.f32``: the float32 fleet's solves a second (host clock).
See ``benchmark/readers.py::solves_per_s``."""

from benchmark.readers import solves_per_s as read  # noqa: F401
