"""``kkt_gram_device_ms.f64``: kernel C's device time a tick (the dense
IPM's KKT matrix) in the float64 fleet's traced rollout. See
``benchmark/kkt_gram_readers.py``."""

from benchmark.kkt_gram_readers import kkt_gram_device_ms as read  # noqa: F401
