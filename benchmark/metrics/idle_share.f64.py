"""``idle_share.f64``: the card's idle share of the float64 fleet's traced segment.
See ``benchmark/readers.py::idle_share``."""

from benchmark.readers import idle_share as read  # noqa: F401
