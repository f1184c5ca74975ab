"""``seg_poly_roofline.f32``: kernel B's share of its roofline in the float32 fleet.
See ``benchmark/readers.py::seg_poly_roofline``."""

from benchmark.readers import seg_poly_roofline as read  # noqa: F401
