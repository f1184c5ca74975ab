"""The port's matplotlib plots (``viz.py``) against the JAX package's under
the Agg backend: the same figures, line for line, with equal vertex data
(exact), for ``plot_set``, ``plot_via_path`` and ``plot_graph``; and the
port's plots of tensors equal its plots of the same numpy arrays.
"""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from boundplanner_tpu import viz as jviz  # noqa: E402
from boundplanner_tpu.planner import roadmap as jroadmap  # noqa: E402
from boundplanner_tpu_torch import viz as tviz  # noqa: E402
from boundplanner_tpu_torch.planner import roadmap as troadmap  # noqa: E402

torch.set_num_threads(1)


def box(center, half):
    a = np.vstack([np.eye(3), -np.eye(3)])
    b = np.concatenate([np.asarray(center) + half, -(np.asarray(center) - half)])
    return [a, b]


def lines(ax):
    """Every line of the axes: (x, y, z) data, color, style, marker."""
    out = [(np.asarray(l.get_data_3d()), l.get_color(), l.get_linestyle(), l.get_marker(),
            l.get_linewidth()) for l in ax.get_lines()]
    plt.close(ax.figure)
    return out


def assert_same(got, ref):
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g[0], r[0])
        assert g[1:] == r[1:]


P_VIA = [np.zeros(3), np.array([0.2, 0.0, 0.0]), np.array([0.2, 0.2, 0.0])]
SETS_VIA = [box([0.1, 0, 0], 0.2), box([0.2, 0.1, 0], 0.2)]
OBS = [box([0.5, 0.5, 0.5], 0.1)]


def test_plot_set_equals_jax():
    a, b = box([0.1, -0.2, 0.3], 0.15)
    # padded inactive rows are dropped, as in JAX
    a = np.vstack([a, np.zeros((2, 3))])
    b = np.concatenate([b, 10.0 * np.ones(2)])
    axes = []
    for mod in (tviz, jviz):
        ax = plt.figure().add_subplot(projection="3d")
        mod.plot_set(ax, a, b, color="C4")
        axes.append(lines(ax))
    assert_same(*axes)


@pytest.mark.parametrize("tensors", [False, True], ids=["numpy", "tensor"])
def test_plot_via_path_equals_jax(tensors):
    conv = (lambda x: torch.as_tensor(x)) if tensors else (lambda x: x)
    got = lines(tviz.plot_via_path([conv(p) for p in P_VIA], [np.eye(3)] * 3,
                                   [[conv(a), conv(b)] for a, b in SETS_VIA], OBS))
    ref = lines(jviz.plot_via_path(P_VIA, [np.eye(3)] * 3, SETS_VIA, OBS))
    assert_same(got, ref)


def roadmap(mod):
    rm = mod.SetRoadmap(w_size=1.0, w_bias=0.1, c_fit=10.0)
    for center in ([0, 0, 0], [0.3, 0.1, 0.2]):
        s = box(center, 0.3)
        sid = rm.add_set(mod.SafeSet(a=s[0], b=s[1], volume=0.1, ellipsoid=np.eye(3),
                                     mid=np.asarray(center, float)))
        rm.add_junction(mod.Junction(a=s[0], b=s[1], owners=(sid, sid),
                                     anchor=np.asarray(center, float) + 0.05,
                                     via=np.zeros(4), fits=True))
    return rm


def test_plot_graph_equals_jax():
    got = lines(tviz.plot_graph(np.zeros(3), np.ones(3), roadmap(troadmap), OBS))
    ref = lines(jviz.plot_graph(np.zeros(3), np.ones(3), roadmap(jroadmap), OBS))
    assert_same(got, ref)
