"""``idle_share.arm``: the card's idle share of the single arm's traced segment.
See ``benchmark/readers.py::idle_share``."""

from benchmark.readers import idle_share as read  # noqa: F401
