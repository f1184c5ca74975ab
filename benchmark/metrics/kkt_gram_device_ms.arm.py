"""``kkt_gram_device_ms.arm``: kernel C's device time a tick (the dense
IPM's KKT matrix) in the single arm's traced periods. See
``benchmark/kkt_gram_readers.py``."""

from benchmark.kkt_gram_readers import kkt_gram_device_ms as read  # noqa: F401
