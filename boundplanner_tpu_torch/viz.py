"""Matplotlib 3D debugging plots (port of ``boundplanner_tpu/viz.py``; ref
`bound_planner/utils/visualization.py` and `util_functions.py:91-105`).
The cddlib vertex enumeration is the triple-plane enumeration of
`utils.sets.polytope_vertices`; sets and points may be numpy arrays or
tensors on any device (`utils.tree.host_array` brings them to the host).
"""

from __future__ import annotations

import numpy as np

from .utils.sets import polytope_vertices
from .utils.tree import host_array as _host


def plot_set(ax, a_set, b_set, color="C0"):
    from scipy.spatial import ConvexHull

    a = _host(a_set)
    b = _host(b_set)
    keep = (b < 9.0) & (np.linalg.norm(a, axis=1) > 1e-8)
    pts = polytope_vertices(a[keep], b[keep])
    if pts.shape[0] < 4:
        return
    hull = ConvexHull(pts)
    for face in hull.simplices:
        p1, p2, p3 = pts[face]
        for d0, d1 in ((p1, p2), (p1, p3), (p2, p3)):
            ax.plot([d0[0], d1[0]], [d0[1], d1[1]], [d0[2], d1[2]], color=color, lw=0.6)


def plot_via_path(p_via, r_via, sets_via, obs_sets):
    """(ref `visualization.py:7-20`)."""
    import matplotlib.pyplot as plt

    fig = plt.figure()
    ax = fig.add_subplot(projection="3d")
    p = _host(p_via)
    ax.plot(p[:, 0], p[:, 1], p[:, 2], "o-", color="C1")
    for s in sets_via:
        plot_set(ax, s[0], s[1], color="C0")
    for s in obs_sets:
        plot_set(ax, s[0], s[1], color="C3")
    ax.set_box_aspect((1, 1, 1))
    return ax


def plot_graph(p0, p1, roadmap, obs_sets):
    """Plot a planner `SetRoadmap`: safe sets, junction anchors, obstacles
    (ref `visualization.py:23-39`)."""
    import matplotlib.pyplot as plt

    fig = plt.figure()
    ax = fig.add_subplot(projection="3d")
    ax.plot(*_host(p0), "go")
    ax.plot(*_host(p1), "ro")
    for s in roadmap.sets:
        plot_set(ax, s.a, s.b, color="C0")
    for j in roadmap.junctions:
        ax.plot(*j.anchor, "x", color="C2")
    for s in obs_sets:
        plot_set(ax, s[0], s[1], color="C3")
    return ax
