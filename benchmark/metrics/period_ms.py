"""``period_ms``: the window's time over the control periods it ran, in
milliseconds: hand-offs, the node's host work and the tick together (host
clock)."""


def read(run):
    w = run["window"]
    if not w.get("periods"):
        return None
    return 1e3 * w["window_s"] / w["periods"]
