"""``node_host_ms.arm``: the mean over the window's periods of the node's
``t_loop - t_comp`` (``telemetry.MPCTickRecord``; ``t_comp`` is timed
around a synchronised solve): the node's host work a period, in
milliseconds."""

import numpy as np


def read(run):
    host = run["window"].get("node_host_s")
    if not host:
        return None
    return 1e3 * float(np.mean(host))
