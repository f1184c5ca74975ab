"""``period_p95_ms``: the 95th percentile of every control period of the
window, hand-off included, in milliseconds (host clock)."""

import numpy as np


def read(run):
    periods = run["window"].get("period_s")
    if not periods:
        return None
    return 1e3 * float(np.percentile(np.asarray(periods), 95))
