"""``idle_share.f32``: the card's idle share of the float32 fleet's traced segment.
See ``benchmark/readers.py::idle_share``."""

from benchmark.readers import idle_share as read  # noqa: F401
