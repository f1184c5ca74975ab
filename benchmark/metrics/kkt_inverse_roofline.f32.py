"""``kkt_inverse_roofline.f32``: kernel A's share of its roofline in the float32 fleet.
See ``benchmark/readers.py::kkt_inverse_roofline``."""

from benchmark.readers import kkt_inverse_roofline as read  # noqa: F401
