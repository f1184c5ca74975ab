"""``graph_capture_s``: the sum of ``capture_s`` over the CUDA graphs the
program captured (``mpc/graph.py``, ``Graph.capture_s``), all of them in
set-up."""


def read(run):
    value = run["counters"].get("graph_capture_s")
    return value if value else None
